"""One-stage detectors: ATSS, and GFL when `reg_max` > 0 (counterpart of
`vitadapter/det/single_stage.py`; mmdet `ATSSHead` / `GFLHead` as the
reference `detection/configs/{atss,gfl}/` collections set them).

A shared head of two 4-conv towers (conv, GroupNorm(32), ReLU) on FPN
strides 8-128, one anchor a cell (scale 8, ratio 1). ATSS: focal class
loss, GIoU box loss weighted by the centerness target, BCE centerness;
adaptive training sample selection (the 9 anchors nearest each gt's centre
on each level, IoU at least mean + std of theirs, centre inside the gt).
GFL: quality focal loss against the IoU of each positive's box with its
best gt, distribution focal loss over `reg_max + 1` bins, GIoU. Losses are
masked means over static shapes, as in the JAX package.

Parameter names are mmdet's (`neck.fpn_convs.N`, `bbox_head.cls_convs.N.
conv` / `.gn`, `bbox_head.{atss,gfl}_cls`, `_reg`, `atss_centerness`,
`scales.N.scale`). The JAX head builds the centerness conv for GFL too
(unused there): the port keeps it, so that the parameter counts agree.
"""

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vitadapter_torch.det.anchors import multi_level_anchors
from vitadapter_torch.det.boxes import batched_nms, bbox_overlaps, stable_top_k
from vitadapter_torch.det.losses import giou, one_hot, sigmoid_focal_loss
from vitadapter_torch.det.necks import FPN, ConvModule
from vitadapter_torch.layers.linear import Conv2d, conv_nhwc
from vitadapter_torch.layers.norm import GroupNorm

ATSS_STRIDES = (8, 16, 32, 64, 128)


class Scale(nn.Module):
    """mmcv's `Scale`: one learned factor (a 0-d `scale`, 1 at init)."""

    def __init__(self, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((), device=device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)


def conv_tower(channels: int, num_convs: int = 4, groups: int = 32,
               dtype: torch.dtype = torch.float32,
               device=None) -> nn.ModuleList:
    """`num_convs` (3x3 conv with bias, GroupNorm) modules, each followed by
    a ReLU in `ATSSHead.forward`."""
    return nn.ModuleList([
        ConvModule(Conv2d(channels, channels, 3, padding=1, dtype=dtype,
                          device=device),
                   GroupNorm(groups, channels, dtype=dtype, device=device))
        for _ in range(num_convs)])


class ATSSHead(nn.Module):
    """Shared towers emitting per level the class logits, the box deltas
    (times the level's scale) and the centerness logit; the output convs
    are fp32 whatever `dtype`."""

    def __init__(self, num_classes: int = 80, channels: int = 256,
                 num_levels: int = 5, reg_max: int = 0,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        fam = "gfl" if reg_max else "atss"
        n_reg = 4 * (reg_max + 1) if reg_max else 4
        self.cls_convs = conv_tower(channels, dtype=dtype, device=device)
        self.reg_convs = conv_tower(channels, dtype=dtype, device=device)
        self.cls_name, self.reg_name = f"{fam}_cls", f"{fam}_reg"
        setattr(self, self.cls_name,
                Conv2d(channels, num_classes, 3, padding=1, device=device))
        setattr(self, self.reg_name,
                Conv2d(channels, n_reg, 3, padding=1, device=device))
        self.atss_centerness = Conv2d(channels, 1, 3, padding=1,
                                      device=device)
        self.scales = nn.ModuleList([Scale(device)
                                     for _ in range(num_levels)])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        getattr(self, self.cls_name).bias.fill_(-4.595)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NHWC maps -> per level (cls (B, H, W, K), reg (B, H, W, n_reg),
        centerness (B, H, W, 1)), fp32."""
        cls_out, reg_out, ctr_out = [], [], []
        for i, f in enumerate(feats):
            c, r = f, f
            for m in self.cls_convs:
                c = F.relu(conv_nhwc(m, c))
            for m in self.reg_convs:
                r = F.relu(conv_nhwc(m, r))
            cls_out.append(conv_nhwc(getattr(self, self.cls_name), c))
            reg_out.append(conv_nhwc(getattr(self, self.reg_name), r)
                           * self.scales[i].scale)
            ctr_out.append(conv_nhwc(self.atss_centerness, r))
        return cls_out, reg_out, ctr_out


def _centers(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2,
                        (boxes[..., 1] + boxes[..., 3]) / 2], -1)


def atss_assign(anchors: torch.Tensor, num_per_level: Sequence[int],
                gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                topk: int = 9) -> torch.Tensor:
    """Adaptive training sample selection of one image: (N,) the assigned
    gt of each anchor or -1. Candidates are the `topk` anchors nearest each
    gt's centre on each level (ties to the lower index, as `lax.top_k`);
    the IoU threshold is the candidates' mean plus their population std;
    the anchor's centre must lie strictly inside the gt; an anchor with
    several positive gts takes the one of highest IoU (the first of
    equals)."""
    N, G = anchors.shape[0], gt_boxes.shape[0]
    iou = bbox_overlaps(anchors, gt_boxes)                    # (N, G)
    ac, gc = _centers(anchors), _centers(gt_boxes)
    dist = torch.linalg.vector_norm(ac[:, None] - gc[None], dim=-1)
    cand = torch.zeros((N, G), dtype=torch.bool, device=anchors.device)
    cols = torch.arange(G, device=anchors.device)[:, None]
    start = 0
    for n in num_per_level:
        _, idx = stable_top_k(-dist[start:start + n].T, min(topk, n))
        cand[start + idx, cols.expand_as(idx)] = True
        start += n
    cand_iou = torch.where(cand, iou, torch.nan)
    mean = torch.nanmean(cand_iou, dim=0)
    std = torch.sqrt(torch.nanmean((cand_iou - mean) ** 2, dim=0))
    thr = mean + std
    inside = ((ac[:, None, 0] > gt_boxes[None, :, 0])
              & (ac[:, None, 0] < gt_boxes[None, :, 2])
              & (ac[:, None, 1] > gt_boxes[None, :, 1])
              & (ac[:, None, 1] < gt_boxes[None, :, 3]))
    pos = cand & (iou >= thr[None]) & inside & gt_valid[None]
    best = torch.argmax(torch.where(pos, iou, -1.0), dim=1)
    return torch.where(pos.any(dim=1), best, -1)


def centerness_target(anchors: torch.Tensor, gts: torch.Tensor
                      ) -> torch.Tensor:
    ac = _centers(anchors)
    left, right = ac[:, 0] - gts[:, 0], gts[:, 2] - ac[:, 0]
    top, bottom = ac[:, 1] - gts[:, 1], gts[:, 3] - ac[:, 1]
    lr = (torch.minimum(left, right)
          / torch.maximum(left, right).clamp(min=1e-6)).clamp(0, 1)
    tb = (torch.minimum(top, bottom)
          / torch.maximum(top, bottom).clamp(min=1e-6)).clamp(0, 1)
    return torch.sqrt(lr * tb)


def decode_atss_deltas(anchors: torch.Tensor, deltas: torch.Tensor
                       ) -> torch.Tensor:
    """(l, t, r, b) distances in units of the anchor's stride (its size
    over 8) -> xyxy."""
    ac = _centers(anchors)
    wh = torch.stack([anchors[..., 2] - anchors[..., 0],
                      anchors[..., 3] - anchors[..., 1]], -1)
    d = deltas * (torch.cat([wh, wh], -1) * 0.125)
    return torch.stack([ac[..., 0] - d[..., 0], ac[..., 1] - d[..., 1],
                        ac[..., 0] + d[..., 2], ac[..., 1] + d[..., 3]], -1)


def gfl_integral(reg_logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4 * (reg_max + 1)) bin logits -> (..., 4) expected bins."""
    n = reg_max + 1
    p = torch.softmax(reg_logits.reshape(*reg_logits.shape[:-1], 4, n), -1)
    return (p * torch.arange(n, dtype=torch.float32,
                             device=p.device)).sum(-1)


def distribution_focal_loss(reg_logits: torch.Tensor, target: torch.Tensor,
                            reg_max: int) -> torch.Tensor:
    """Cross entropy against the two bins around each continuous target
    (..., 4) in [0, reg_max], summed over the four sides."""
    n = reg_max + 1
    logp = torch.log_softmax(
        reg_logits.reshape(*reg_logits.shape[:-1], 4, n), -1)
    t = target.clamp(0, reg_max - 1e-4)
    lo = torch.floor(t).long()
    w_hi = t - lo
    nll_lo = -logp.gather(-1, lo[..., None])[..., 0]
    nll_hi = -logp.gather(-1, (lo + 1)[..., None])[..., 0]
    return ((1 - w_hi) * nll_lo + w_hi * nll_hi).sum(-1)


def quality_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       quality: torch.Tensor, num_classes: int,
                       beta: float = 2.0) -> torch.Tensor:
    """Soft focal loss with the IoU `quality` as the target at each
    anchor's class (labels == num_classes: background, an all-zero
    target), summed over the classes."""
    t = one_hot(labels, num_classes) * quality[:, None]
    logits = logits.float()
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * t
          + torch.log1p(torch.exp(-logits.abs())))
    return ((t - p).abs() ** beta * ce).sum(-1)


class ATSS(nn.Module):
    """Backbone -> FPN (start level 1, learned extras: strides 8-128) ->
    `ATSSHead`; GFL when `reg_max` > 0 (16 in the GFL config)."""

    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 fpn_channels: int = 256, reg_max: int = 0,
                 max_dets: int = 100, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.max_dets = max_dets
        self.backbone = backbone
        self.neck = FPN([backbone.embed_dim] * 4, fpn_channels, num_outs=5,
                        start_level=1, extra="on_output", dtype=dtype,
                        device=device)
        self.bbox_head = ATSSHead(num_classes, fpn_channels,
                                  reg_max=reg_max, dtype=dtype,
                                  device=device)

    def _outputs(self, img, generator=None):
        """Flat per-anchor outputs of a batch: anchors (N, 4), anchors a
        level, cls (B, N, K), reg (B, N, n_reg), centerness (B, N), the
        decoded boxes (B, N, 4) clipped to the image."""
        B, H, W, _ = img.shape
        feats = self.neck(self.backbone(img, generator=generator))
        cls_out, reg_out, ctr_out = self.bbox_head(feats)
        lvl = multi_level_anchors([tuple(f.shape[1:3]) for f in feats],
                                  ATSS_STRIDES[:len(feats)], scales=(8,),
                                  ratios=(1.0,))
        anchors = torch.from_numpy(np.concatenate(lvl)).to(img.device)
        cls = torch.cat([c.reshape(B, -1, self.num_classes)
                         for c in cls_out], 1)
        reg = torch.cat([r.reshape(B, -1, r.shape[-1]) for r in reg_out], 1)
        ctr = torch.cat([c.reshape(B, -1) for c in ctr_out], 1)
        dist = gfl_integral(reg, self.reg_max) if self.reg_max else reg
        boxes = decode_atss_deltas(anchors[None], dist)
        hi = torch.tensor([W, H, W, H], dtype=torch.float32,
                          device=img.device)
        boxes = torch.minimum(boxes.clamp(min=0), hi)
        return anchors, [len(a) for a in lvl], cls, reg, ctr, boxes

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The test path: {"boxes" (B, D, 4), "scores" (B, D), "labels"
        (B, D)}, D = max_dets: the 2048 best (anchor, class) scores (ATSS:
        sigmoid class times sigmoid centerness; GFL: sigmoid class), those
        above 0.05 through a class-aware NMS at 0.6; -inf scores and -1
        labels padded."""
        _, _, cls, _, ctr, boxes = self._outputs(img)
        K = self.num_classes
        out = {k: [] for k in ("boxes", "scores", "labels")}
        for b in range(img.shape[0]):
            scores = torch.sigmoid(cls[b])
            if not self.reg_max:
                scores = scores * torch.sigmoid(ctr[b])[:, None]
            flat = scores.reshape(-1)
            top_s, top_i = stable_top_k(flat, min(2048, flat.shape[0]))
            a_idx = torch.div(top_i, K, rounding_mode="floor")
            labels = (top_i % K).to(torch.int32)
            ob, os_, ol, _ = batched_nms(boxes[b][a_idx], top_s, labels, 0.6,
                                         self.max_dets, valid=top_s > 0.05)
            for k, v in (("boxes", ob), ("scores", os_), ("labels", ol)):
                out[k].append(v)
        return {k: torch.stack(v) for k, v in out.items()}

    def forward_train(self, img: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      generator: torch.Generator = None
                      ) -> Dict[str, torch.Tensor]:
        """The losses of a batch (gt_boxes (B, G, 4) pixel xyxy, gt_labels
        (B, G), gt_valid (B, G)), each the mean over the images: ATSS
        `loss_cls`, `loss_bbox`, `loss_centerness`; GFL `loss_cls`,
        `loss_bbox`, `loss_dfl`; and their sum `loss`. DropPath draws from
        `generator`."""
        anchors, n_lvl, cls, reg, ctr, boxes = self._outputs(img, generator)
        K = self.num_classes
        parts: List[tuple] = []
        for b in range(img.shape[0]):
            gtb, gtl = gt_boxes[b].float(), gt_labels[b].long()
            assigned = atss_assign(anchors, n_lvl, gtb, gt_valid[b])
            pos = assigned >= 0
            safe = assigned.clamp(min=0)
            tgt = gtb[safe]
            labels = torch.where(pos, gtl[safe], K)
            n_pos = pos.sum().float().clamp(min=1.0)
            g = giou(boxes[b], tgt)
            zero = torch.zeros_like(g)
            if self.reg_max:
                with torch.no_grad():
                    best = bbox_overlaps(boxes[b], gtb).max(-1).values
                    quality = torch.where(pos, best.clamp(0, 1), zero)
                loss_cls = quality_focal_loss(cls[b], labels, quality,
                                              K).sum() / n_pos
                ac = _centers(anchors)
                wh = (anchors[:, 2] - anchors[:, 0])[:, None] * 0.125
                t = torch.cat([ac - tgt[:, :2], tgt[:, 2:] - ac], -1) / wh
                dfl = distribution_focal_loss(reg[b], t, self.reg_max)
                loss_dfl = torch.where(pos, dfl, zero).sum() / n_pos * 0.25
                loss_box = torch.where(pos, 1 - g, zero).sum() / n_pos * 2.0
                parts.append((loss_cls, loss_box, loss_dfl))
                continue
            loss_cls = sigmoid_focal_loss(cls[b].float(), one_hot(
                labels, K)).sum() / n_pos
            ct_tgt = centerness_target(anchors, tgt)
            loss_box = (torch.where(pos, (1 - g) * ct_tgt, zero).sum()
                        / torch.where(pos, ct_tgt, zero).sum().clamp(
                            min=1e-6) * 2.0)
            c = ctr[b]
            bce = (c.clamp(min=0) - c * ct_tgt
                   + torch.log1p(torch.exp(-c.abs())))
            loss_ctr = torch.where(pos, bce, zero).sum() / n_pos
            parts.append((loss_cls, loss_box, loss_ctr))
        names = (("loss_cls", "loss_bbox", "loss_dfl") if self.reg_max
                 else ("loss_cls", "loss_bbox", "loss_centerness"))
        losses = {n: torch.stack(v).mean() for n, v in zip(names,
                                                           zip(*parts))}
        losses["loss"] = sum(losses[n] for n in names)
        return losses
