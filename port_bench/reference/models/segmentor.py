"""Encoder-decoder segmentor and the segmentation loss: a backbone, a
decode head (`heads/upernet.UPerHead`) and an optional auxiliary head
(`FCNHead`)."""

from typing import Optional

import torch
from torch import nn

from port_bench.reference.utils.resize import resize_2d

class EncoderDecoder(nn.Module):
    """Backbone + decode head (+ optional auxiliary head on
    `feats[aux_in_index]`)."""

    def __init__(self, backbone: nn.Module, decode_head: nn.Module,
                 auxiliary_head: Optional[nn.Module] = None,
                 aux_in_index: int = 2):
        super().__init__()
        self.backbone = backbone
        self.decode_head = decode_head
        self.auxiliary_head = auxiliary_head
        self.aux_in_index = aux_in_index

    def forward(self, img: torch.Tensor, with_aux: bool = False,
                generator: Optional[torch.Generator] = None):
        """img: normalized (B, H, W, 3). Returns the decode head's logits
        (B, H, W, K) fp32, resized to the input size; with `with_aux` (and
        an auxiliary head) also the auxiliary logits at input size. In
        training mode BatchNorm takes batch statistics and DropPath and
        dropout draw from `generator`."""
        feats = self.backbone(img, generator=generator)
        hw = img.shape[1:3]
        logits = resize_2d(self.decode_head(feats, generator).float(), hw,
                           "bilinear")
        if with_aux and self.auxiliary_head is not None:
            aux = self.auxiliary_head(feats[self.aux_in_index], generator)
            return logits, resize_2d(aux.float(), hw, "bilinear")
        return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       class_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean softmax cross entropy of (B, H, W, K) logits against (B, H, W)
    labels over the pixels that are not `ignore_index` (mmseg's
    CrossEntropyLoss, reduction 'mean' over the valid pixels), in fp32."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if class_weight is not None:
        nll = nll * class_weight[safe]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def segmentation_loss(logits: torch.Tensor, aux_logits: torch.Tensor,
                      labels: torch.Tensor, aux_weight: float = 0.4,
                      ignore_index: int = 255):
    """The decode head's cross entropy plus `aux_weight` times the
    auxiliary head's: (loss, {"loss_decode", "loss_aux"})."""
    main = cross_entropy_loss(logits, labels, ignore_index)
    aux = cross_entropy_loss(aux_logits, labels, ignore_index)
    return main + aux_weight * aux, {"loss_decode": main, "loss_aux": aux}
