"""Encoder-decoder segmentor, the segmentation loss and the test-time
helpers on tensors (counterpart of `vitadapter/models/segmentor.py`).

`EncoderDecoder` runs a backbone, a decode head (`heads/upernet.UPerHead`)
and an optional auxiliary head (`FCNHead`). `slide_inference`, `flip_tta`
and `multi_scale_flip_aug` score fixed-size NHWC batches through a
`logits_fn`, as the JAX functions do inside one jit; the per-image
reference protocol with true original shapes is `train/loop.py::run_eval`.
"""

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from vitadapter_torch.models.seg_protocol import slide_grid, variant_plan
from vitadapter_torch.parallel.collectives import global_normalizer
from vitadapter_torch.parallel.mesh import data_group
from vitadapter_torch.utils.resize import resize_2d

LogitsFn = Callable[[torch.Tensor], torch.Tensor]


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


def slide_inference(logits_fn: LogitsFn, img: torch.Tensor,
                    crop_size: Tuple[int, int], stride: Tuple[int, int],
                    num_classes: int) -> torch.Tensor:
    """Sliding-window logits (B, H, W, K) fp32 of an NHWC batch: an image
    smaller than the crop is zero-padded up to it, the crops of the fixed
    grid are scored in one `logits_fn` call ((N, ch, cw, 3) ->
    (N, ch, cw, K)), summed into a canvas and divided by the count of
    crops covering each pixel."""
    B, H, W, _ = img.shape
    ch, cw = crop_size
    Hp, Wp = max(H, ch), max(W, cw)
    if (Hp, Wp) != (H, W):
        img = torch.nn.functional.pad(img, (0, 0, 0, Wp - W, 0, Hp - H))
    ys = slide_grid(Hp, ch, stride[0])
    xs = slide_grid(Wp, cw, stride[1])
    crops = torch.stack([img[:, y:y + ch, x:x + cw] for y in ys for x in xs],
                        dim=1)
    n = crops.shape[1]
    logits = logits_fn(crops.reshape(B * n, ch, cw, -1)).reshape(
        B, n, ch, cw, num_classes)
    preds = torch.zeros((B, Hp, Wp, num_classes), dtype=torch.float32,
                        device=img.device)
    count = torch.zeros((1, Hp, Wp, 1), dtype=torch.float32,
                        device=img.device)
    k = 0
    for y in ys:
        for x in xs:
            preds[:, y:y + ch, x:x + cw] += logits[:, k]
            count[:, y:y + ch, x:x + cw] += 1.0
            k += 1
    return (preds / count)[:, :H, :W]


def flip_tta(logits_fn: LogitsFn) -> LogitsFn:
    """Class probabilities averaged over the image and its horizontal flip
    (the reference `inference` averages softmax outputs)."""

    def fn(img: torch.Tensor) -> torch.Tensor:
        p = torch.softmax(logits_fn(img), dim=-1)
        p_f = torch.softmax(logits_fn(img.flip(2)), dim=-1).flip(2)
        return (p + p_f) / 2.0

    return fn


def multi_scale_flip_aug(
    logits_fn: LogitsFn,
    img: torch.Tensor,
    num_classes: int,
    ratios: Sequence[float] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75),
    flip: bool = True,
    size_divisor: int = 32,
    crop_size: Optional[Tuple[int, int]] = None,
    stride: Optional[Tuple[int, int]] = None,
    img_scale: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Multi-scale (+ flip) probabilities (B, H, W, K) of a fixed-size NHWC
    batch, as the JAX function: with `img_scale` each ratio scales that
    canvas and the image is fitted into it keeping its ratio, then resized
    to a multiple of `size_divisor` (MultiScaleFlipAug mode 2); without,
    the ratios scale the input size. Each variant's logits (slide inference
    where it exceeds `crop_size`) are resized back to the input size,
    soft-maxed, unflipped and averaged."""
    B, H, W, _ = img.shape
    acc = torch.zeros((B, H, W, num_classes), dtype=torch.float32,
                      device=img.device)
    for r in ratios:
        if img_scale is not None:
            _, (h, w) = variant_plan(H, W, img_scale, r, size_divisor)
        else:
            h = max(int(round(H * r / size_divisor)) * size_divisor,
                    size_divisor)
            w = max(int(round(W * r / size_divisor)) * size_divisor,
                    size_divisor)
        scaled = resize_2d(img, (h, w), "bilinear")
        variants = [scaled, scaled.flip(2)] if flip else [scaled]
        for vi, v in enumerate(variants):
            if crop_size is not None and (h > crop_size[0]
                                          or w > crop_size[1]):
                logits = slide_inference(logits_fn, v, crop_size,
                                         stride or crop_size, num_classes)
            else:
                logits = logits_fn(v)
            p = torch.softmax(resize_2d(logits.float(), (H, W), "bilinear"),
                              dim=-1)
            acc = acc + (p.flip(2) if vi == 1 else p)
    return acc / (len(ratios) * (2 if flip else 1))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = 255,
                       class_weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Mean softmax cross entropy of (B, H, W, K) logits against (B, H, W)
    labels over the pixels that are not `ignore_index` (mmseg's
    CrossEntropyLoss, reduction 'mean' over the valid pixels), in fp32.
    The valid pixels are counted over the global batch
    (`parallel.global_normalizer`)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    if class_weight is not None:
        nll = nll * class_weight[safe]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / global_normalizer(valid.sum(), group=data_group())


def segmentation_loss(logits: torch.Tensor, aux_logits: torch.Tensor,
                      labels: torch.Tensor, aux_weight: float = 0.4,
                      ignore_index: int = 255):
    """The decode head's cross entropy plus `aux_weight` times the
    auxiliary head's: (loss, {"loss_decode", "loss_aux"})."""
    main = cross_entropy_loss(logits, labels, ignore_index)
    aux = cross_entropy_loss(aux_logits, labels, ignore_index)
    return main + aux_weight * aux, {"loss_decode": main, "loss_aux": aux}
