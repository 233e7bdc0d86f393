"""Sparse R-CNN: learned proposals refined by iterative dynamic-interaction
heads (counterpart of `vitadapter/det/sparse_rcnn.py`; mmdet `SparseRCNN`
/ `DIIHead` as the reference `detection/configs/sparse_rcnn/` sets them).

Each of the 6 stages pools 7x7 RoI features of its boxes from the FPN
(strides 4-32, `det/roi_align.py`), lets the proposal features attend to
each other, generates from each one the parameters of two 1x1 convs over
its own RoI features (`DynamicConv`), and predicts class logits and box
deltas (stds 0.5/0.5/1/1); the refined boxes feed the next stage with no
gradient. Every stage takes the set-prediction losses (focal 2, L1 5,
GIoU 2 on a Hungarian matching: `det/dino.py::dino_matching_loss`, the
auction kernel on the card), the last under the plain names and stage i
under `s{i}.`.

Parameter names are mmdet's (`rpn_head.init_proposal_{features,bboxes}`,
`roi_head.bbox_head.N.{attention.attn, attention_norm,
instance_interactive_conv.{dynamic_layer, norm_in, norm_out, fc_layer,
fc_norm}, instance_interactive_conv_norm, ffn, ffn_norm, cls_fcs,
reg_fcs, fc_cls, fc_reg}`).
"""

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.det.boxes import delta2bbox, stable_top_k
from vitadapter_torch.det.dino import Assigner, dino_matching_loss
from vitadapter_torch.det.losses import cxcywh_to_xyxy, xyxy_to_cxcywh
from vitadapter_torch.det.necks import FPN
from vitadapter_torch.det.roi_align import multi_level_roi_align
from vitadapter_torch.heads.mask2former import MultiheadAttention
from vitadapter_torch.heads.pixel_decoder import FFN
from vitadapter_torch.layers.linear import Linear
from vitadapter_torch.layers.norm import LayerNorm
from vitadapter_torch.ops.matching import hungarian_assign

FPN_STRIDES = (4, 8, 16, 32)
BOX_STDS = (0.5, 0.5, 1.0, 1.0)


class DynamicConv(nn.Module):
    """Per-proposal dynamic interaction (reference `transformer.py:980`):
    roi_feats (N, 49, C), proposal features (N, C) -> (N, C)."""

    def __init__(self, channels: int = 256, inner: int = 64,
                 roi_size: int = 7, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.channels, self.inner = channels, inner
        self.dynamic_layer = Linear(channels, 2 * channels * inner, **kw)
        self.norm_in = LayerNorm(inner, device=device)
        self.norm_out = LayerNorm(channels, device=device)
        self.fc_layer = Linear(roi_size * roi_size * channels, channels,
                               **kw)
        self.fc_norm = LayerNorm(channels, device=device)

    def forward(self, roi_feats: torch.Tensor, prop: torch.Tensor
                ) -> torch.Tensor:
        N = roi_feats.shape[0]
        C, I = self.channels, self.inner
        params = self.dynamic_layer(prop)
        p1 = params[:, :C * I].reshape(N, C, I)
        p2 = params[:, C * I:].reshape(N, I, C)
        # fp32 products, as JAX promotes the fp32 RoI features
        x = torch.einsum("nsc,nci->nsi", roi_feats.float(), p1.float())
        x = F.relu(self.norm_in(x))
        x = torch.einsum("nsi,nic->nsc", x, p2.float())
        x = F.relu(self.norm_out(x))
        return F.relu(self.fc_norm(self.fc_layer(x.reshape(N, -1))))


def _fc_tower(channels: int, n: int, dtype, device) -> nn.ModuleList:
    """mmdet's `cls_fcs` / `reg_fcs`: (Linear without bias, LayerNorm,
    ReLU) `n` times."""
    mods = []
    for _ in range(n):
        mods += [Linear(channels, channels, bias=False, dtype=dtype,
                        device=device),
                 LayerNorm(channels, device=device), nn.ReLU()]
    return nn.ModuleList(mods)


class DIIHead(nn.Module):
    """One refinement stage: roi_feats (B, N, 49, C), proposal features
    (B, N, C) -> class logits (B, N, K) and deltas (B, N, 4), fp32, and the
    new proposal features."""

    def __init__(self, num_classes: int = 80, channels: int = 256,
                 num_heads: int = 8, ffn_dim: int = 2048,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attention = MultiheadAttention(channels, num_heads, **kw)
        self.attention_norm = LayerNorm(channels, device=device)
        self.instance_interactive_conv = DynamicConv(channels, **kw)
        self.instance_interactive_conv_norm = LayerNorm(channels,
                                                        device=device)
        self.ffn = FFN(channels, ffn_dim, **kw)
        self.ffn_norm = LayerNorm(channels, device=device)
        self.cls_fcs = _fc_tower(channels, 1, dtype, device)
        self.reg_fcs = _fc_tower(channels, 3, dtype, device)
        self.fc_cls = Linear(channels, num_classes, device=device)
        self.fc_reg = Linear(channels, 4, device=device)

    def forward(self, roi_feats: torch.Tensor, prop: torch.Tensor):
        B, N, S, C = roi_feats.shape
        x = self.attention_norm(prop + self.attention(prop, prop, prop))
        inter = self.instance_interactive_conv(roi_feats.reshape(B * N, S, C),
                                               x.reshape(B * N, C))
        x = self.instance_interactive_conv_norm(x + inter.reshape(B, N, C))
        x = self.ffn_norm(x + self.ffn(x))
        c = x
        for m in self.cls_fcs:
            c = m(c)
        r = x
        for m in self.reg_fcs:
            r = m(r)
        return self.fc_cls(c), self.fc_reg(r), x


class SparseRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 num_proposals: int = 100, num_stages: int = 6,
                 channels: int = 256, max_dets: int = 100,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.max_dets = max_dets
        self.compute_dtype = dtype
        self.backbone = backbone
        self.neck = FPN([backbone.embed_dim] * 4, channels, num_outs=4,
                        dtype=dtype, device=device)
        self.rpn_head = nn.Module()
        self.rpn_head.init_proposal_bboxes = nn.Embedding(num_proposals, 4,
                                                          device=device)
        self.rpn_head.init_proposal_features = nn.Embedding(
            num_proposals, channels, device=device)
        self.roi_head = nn.Module()
        self.roi_head.bbox_head = nn.ModuleList([
            DIIHead(num_classes, channels, dtype=dtype, device=device)
            for _ in range(num_stages)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Whole-image proposal boxes (normalized cxcywh 0.5, 0.5, 1, 1)
        and N(0, 1) proposal features, as the JAX package."""
        self.rpn_head.init_proposal_bboxes.weight.copy_(torch.tensor(
            [0.5, 0.5, 1.0, 1.0]).expand(self.num_proposals, 4))
        self.rpn_head.init_proposal_features.weight.normal_(
            0.0, 1.0, generator=generator)

    def _stages(self, img, generator=None):
        """Every stage's class logits (B, N, K) and boxes (B, N, 4), pixel
        xyxy."""
        B, H, W, _ = img.shape
        feats = self.neck(self.backbone(img, generator=generator))
        scale = torch.tensor([W, H, W, H], dtype=torch.float32,
                             device=img.device)
        boxes = cxcywh_to_xyxy(self.rpn_head.init_proposal_bboxes.weight)
        boxes = (boxes * scale).expand(B, -1, -1)
        prop = self.rpn_head.init_proposal_features.weight.to(
            self.compute_dtype).expand(B, -1, -1)
        all_cls, all_boxes = [], []
        for head in self.roi_head.bbox_head:
            roi_feats = torch.stack([
                multi_level_roi_align([f[b] for f in feats], boxes[b], 7,
                                      FPN_STRIDES).reshape(
                    self.num_proposals, 49, -1) for b in range(B)])
            cls, delta, prop = head(roi_feats, prop)
            boxes = delta2bbox(boxes, delta, BOX_STDS, (H, W))
            all_cls.append(cls)
            all_boxes.append(boxes)
            boxes = boxes.detach()
        return all_cls, all_boxes

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The test path: the `max_dets` best (proposal, class) sigmoid
        scores of the last stage: {"boxes" (B, D, 4), "scores", "labels"}."""
        all_cls, all_boxes = self._stages(img)
        K = self.num_classes
        scores = torch.sigmoid(all_cls[-1]).reshape(img.shape[0], -1)
        top_s, top_i = stable_top_k(scores, min(self.max_dets,
                                                scores.shape[1]))
        p_idx = torch.div(top_i, K, rounding_mode="floor")
        boxes = all_boxes[-1].gather(1, p_idx[..., None].expand(-1, -1, 4))
        return {"boxes": boxes, "scores": top_s,
                "labels": (top_i % K).to(torch.int32)}

    def forward_train(self, img: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      assigner: Optional[Assigner] = None
                      ) -> Dict[str, torch.Tensor]:
        """The set-prediction losses of every stage on (B, G) pixel xyxy
        gts (the last stage's `loss_cls`, `loss_bbox`, `loss_iou`, stage i's
        under `s{i}.`) and their sum `loss`. DropPath draws from
        `generator`; `assigner` matches each stage (by default
        `ops/matching.py::hungarian_assign`, the auction kernel on the
        card)."""
        B, H, W, _ = img.shape
        all_cls, all_boxes = self._stages(img, generator)
        scale = torch.tensor([W, H, W, H], dtype=torch.float32,
                             device=img.device)
        gt_n = xyxy_to_cxcywh(gt_boxes.float() / scale)
        losses: Dict[str, torch.Tensor] = {}
        total = 0.0
        n = len(all_cls)
        for i, (cls, bx) in enumerate(zip(all_cls, all_boxes)):
            m = dino_matching_loss(cls, xyxy_to_cxcywh(bx / scale),
                                   gt_labels, gt_n, gt_valid,
                                   self.num_classes,
                                   assigner=assigner or hungarian_assign)
            total = total + sum(m.values())
            prefix = "" if i == n - 1 else f"s{i}."
            losses.update({prefix + k: v for k, v in m.items()})
        losses["loss"] = total
        return losses
