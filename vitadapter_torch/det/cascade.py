"""Cascade Mask R-CNN and HTC++ (counterpart of `vitadapter/det/cascade.py`,
mmdet `CascadeRCNN` / `HybridTaskCascade` as the reference HTC++ configs
set them) and the host-side merge of test-time augmentations.

Three bbox stages with assigner IoUs 0.5/0.6/0.7, class-agnostic
regression and loss weights 1/0.5/0.25; every roi is refined by each
stage's head for the next (no gradient through the refinement); per-stage
mask heads with HTC's information flow (each stage's tower features feed
the next stage's `conv_res_feat`; the JAX module's default, which every
config keeps); optionally `ExtraAttention` on the
coarsest level before the FPN and HTC's semantic branch, whose stride-8
features are RoI-aligned and added to every RoI feature. The test path
averages the stages' class probabilities and their mask logits. As in the
JAX package, training passes no semantic map, so there is no
`loss_semantic` (ROADMAP.md §3). Budgets are static (1000 proposals, 512
sampled rois, 100 detections); the RoI stages take one image at a time.

Keys are mmdet's HTC keys: `neck.0` the ExtraAttention and `neck.1` the
FPN (or `neck` the FPN alone), `rpn_head`, `roi_head.bbox_head.{s}`,
`roi_head.mask_head.{s}`, `roi_head.semantic_head`.

`remove_boxes_by_scale`, `soft_nms` and `merge_aug_detections` are the
reference's HTC-Aug merge (`htc_aug.py:43-65, :203-241`) on the host, in
numpy, copied from the JAX package.
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from vitadapter_torch.det.assign import max_iou_assign, random_sample
from vitadapter_torch.det.boxes import batched_nms, delta2bbox, stable_top_k
from vitadapter_torch.det.necks import FPN, ConvModule, ExtraAttention
from vitadapter_torch.det.roi_align import (crop_resize_masks,
                                            multi_level_roi_align, roi_align)
from vitadapter_torch.det.roi_heads import (FCNMaskHead, Shared2FCBBoxHead,
                                            bbox_head_loss, mask_head_loss)
from vitadapter_torch.det.rpn import (FPN_STRIDES, RPNHead, rpn_loss,
                                      rpn_proposals)
from vitadapter_torch.layers.linear import Conv2d, conv_nhwc
from vitadapter_torch.ops.point_sample import Sampler, uniform_sampler
from vitadapter_torch.utils.resize import resize_2d

STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_WEIGHTS = (1.0, 0.5, 0.25)
# mmdet's cascade target stds tighten stage by stage
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (1 / 30, 1 / 30, 1 / 15, 1 / 15))


class SemanticHead(nn.Module):
    """HTC's semantic branch (mmdet `FusedSemanticHead`): the first four
    FPN levels through 1x1 laterals, bilinearly resized to the stride-8
    level and summed, a tower of 3x3 convs, then the semantic logits
    (`conv_logits`, fp32) and the embedding mixed into the RoI features
    (`conv_embedding`)."""

    fusion_level = 1

    def __init__(self, num_classes: int = 183, in_channels: int = 256,
                 channels: int = 256, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.lateral_convs = nn.ModuleList([
            ConvModule(Conv2d(in_channels, channels, 1, **kw))
            for _ in range(4)])
        self.convs = nn.ModuleList([
            ConvModule(Conv2d(channels, channels, 3, padding=1, **kw))
            for _ in range(4)])
        self.conv_embedding = ConvModule(Conv2d(channels, channels, 1, **kw))
        self.conv_logits = Conv2d(channels, num_classes, 1, device=device)

    def forward(self, feats):
        """NHWC FPN levels -> (logits (B, H/8, W/8, classes) fp32, the
        embedding (B, H/8, W/8, channels))."""
        tgt = feats[self.fusion_level]
        x = conv_nhwc(self.lateral_convs[self.fusion_level], tgt)
        for i, f in enumerate(feats):
            if i != self.fusion_level:
                x = x + resize_2d(conv_nhwc(self.lateral_convs[i], f),
                                  tgt.shape[1:3], "bilinear")
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = torch.relu(conv(x))
        seg = self.conv_logits(x).permute(0, 2, 3, 1)
        return seg, self.conv_embedding(x).permute(0, 2, 3, 1)


class CascadeRCNN(nn.Module):
    """`num_stages` and `with_mask` are accepted at the one value every
    config gives (3, True), as `STAGE_IOUS` fixes three stages."""

    def __init__(self, backbone: nn.Module, num_classes: int = 80,
                 fpn_channels: int = 256, num_stages: int = 3,
                 with_mask: bool = True, use_extra_attention: bool = False,
                 with_semantic: bool = False,
                 num_semantic_classes: int = 183, num_proposals: int = 1000,
                 num_roi_samples: int = 512, max_dets: int = 100,
                 dtype: torch.dtype = torch.float32, device=None):
        if num_stages != len(STAGE_IOUS) or not with_mask:
            raise ValueError(
                f"CascadeRCNN has {len(STAGE_IOUS)} stages with masks; got "
                f"num_stages={num_stages}, with_mask={with_mask}")
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.backbone = backbone
        self.num_classes = num_classes
        self.num_stages = num_stages
        self.num_proposals = num_proposals
        self.num_roi_samples = num_roi_samples
        self.max_dets = max_dets
        dim = backbone.embed_dim
        fpn = FPN([dim] * 4, fpn_channels, num_outs=5, **kw)
        self.neck = (nn.ModuleList([ExtraAttention(dim, **kw), fpn])
                     if use_extra_attention else fpn)
        self.rpn_head = RPNHead(3, fpn_channels, **kw)
        self.roi_head = nn.Module()
        self.roi_head.bbox_head = nn.ModuleList([
            Shared2FCBBoxHead(num_classes, fpn_channels,
                              reg_class_agnostic=True, **kw)
            for _ in range(num_stages)])
        self.roi_head.mask_head = nn.ModuleList([
            FCNMaskHead(num_classes, fpn_channels, fpn_channels,
                        return_feat=True, **kw)
            for _ in range(num_stages)])
        if with_semantic:
            self.roi_head.semantic_head = SemanticHead(
                num_semantic_classes, fpn_channels, fpn_channels, **kw)

    def extract_feats(self, img, generator=None):
        feats = self.backbone(img, generator=generator)
        if isinstance(self.neck, nn.ModuleList):
            feats = self.neck[0](feats)
            return self.neck[1](feats)
        return self.neck(feats)

    def semantic_feats(self, feats):
        """The semantic branch's (logits, embedding), or (None, None)."""
        if not hasattr(self.roi_head, "semantic_head"):
            return None, None
        return self.roi_head.semantic_head(feats[:4])

    def roi_feats(self, fb, sem_b, rois, size):
        """RoIAlign from each roi's FPN level, plus the semantic
        embedding's at stride 8 where the branch exists."""
        rf = multi_level_roi_align(fb, rois, size, FPN_STRIDES[:4])
        if sem_b is not None:
            rf = rf + roi_align(sem_b, rois, size, 1.0 / 8)
        return rf

    def _mask_logits(self, mask_feats, upto: Optional[int] = None):
        """The mask heads of stages 0..upto with the information flow:
        stage `upto`'s logits, or, when `upto` is None, the mean of every
        stage's."""
        heads = self.roi_head.mask_head
        acc, prev = 0.0, None
        for head in heads[:None if upto is None else upto + 1]:
            logits, prev = head(mask_feats, prev)
            acc = acc + logits
        return logits if upto is not None else acc / len(heads)

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The test path: {"boxes" (B, D, 4), "scores" (B, D), "labels"
        (B, D), "masks" (B, D, 28, 28) probabilities of each box's class in
        its box frame}, D = max_dets, -inf scores and -1 labels padded. The
        class scores are the stages' mean softmax, the boxes the last
        stage's regression, the masks the stages' mean logits."""
        B, H, W, _ = img.shape
        feats = self.extract_feats(img)
        _, _, _, (props, _, p_valid) = rpn_proposals(
            self.rpn_head, feats, (H, W), self.num_proposals)
        _, sem = self.semantic_feats(feats)
        K = self.num_classes
        out = {k: [] for k in ("boxes", "scores", "labels", "masks")}
        for b in range(B):
            fb = [f[b] for f in feats[:4]]
            sem_b = None if sem is None else sem[b]
            rois = props[b]
            probs = 0.0
            for s, head in enumerate(self.roi_head.bbox_head):
                cls_logits, deltas = head(self.roi_feats(fb, sem_b, rois, 7))
                probs = probs + torch.softmax(cls_logits, dim=-1)
                rois = delta2bbox(rois, deltas[:, 0], STAGE_STDS[s], (H, W))
            probs = probs / self.num_stages
            R = rois.shape[0]
            flat_scores = probs[:, :K].reshape(-1)
            flat_boxes = rois.repeat_interleave(K, dim=0)
            flat_labels = torch.arange(K, device=img.device).repeat(R)
            ok = (flat_scores > 0.05) & p_valid[b].repeat_interleave(K)
            top_s, top_i = stable_top_k(
                torch.where(ok, flat_scores, -torch.inf), min(2048, R * K))
            boxes, scores, labels, _ = batched_nms(
                flat_boxes[top_i], top_s, flat_labels[top_i], 0.5,
                self.max_dets, valid=torch.isfinite(top_s))
            logits = self._mask_logits(self.roi_feats(fb, sem_b, boxes, 14))
            k = labels.clamp(0, K - 1)
            masks = torch.sigmoid(
                logits[torch.arange(len(k), device=k.device), k])
            for key, v in (("boxes", boxes), ("scores", scores),
                           ("labels", labels), ("masks", masks)):
                out[key].append(v)
        return {k: torch.stack(v) for k, v in out.items()}

    def forward_train(self, img: torch.Tensor, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_masks: torch.Tensor,
                      gt_valid: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      sampler: Optional[Sampler] = None
                      ) -> Dict[str, torch.Tensor]:
        """The losses of a batch (inputs as `MaskRCNN.forward_train`):
        the RPN's two and each stage's `s{s}.loss_cls`, `s{s}.loss_bbox`
        and `s{s}.loss_mask`, weighted by `STAGE_WEIGHTS`, and their sum
        `loss`. The uniforms come from `sampler`: the RPN's of every image
        first, then, image by image, one draw over the rois a stage."""
        B, H, W, _ = img.shape
        if sampler is None:
            sampler = uniform_sampler(generator)
        feats = self.extract_feats(img, generator)
        cls_out, reg_out, anchors, (props, _, p_valid) = rpn_proposals(
            self.rpn_head, feats, (H, W), self.num_proposals)
        losses = rpn_loss(cls_out, reg_out, torch.cat(anchors), gt_boxes,
                          gt_valid, sampler, (H, W))
        # the semantic logits are computed but take no loss: no
        # `gt_semantic` is passed, as in the JAX det loop
        _, sem = self.semantic_feats(feats)
        parts: Dict[str, list] = {}
        for b in range(B):
            fb = [f[b] for f in feats[:4]]
            sem_b = None if sem is None else sem[b]
            gtb, gtv = gt_boxes[b], gt_valid[b]
            # the gts join the proposals (mmdet add_gt_as_proposals)
            rois = torch.cat([props[b], gtb])
            roi_valid = torch.cat([p_valid[b], gtv])
            for s, head in enumerate(self.roi_head.bbox_head):
                thr = STAGE_IOUS[s]
                assigned, _ = max_iou_assign(rois, gtb, gtv, thr, thr, thr,
                                             match_low_quality=False)
                assigned = torch.where(roi_valid, assigned, -2)
                smp = random_sample(sampler(rois.shape[:1]).to(img.device),
                                    assigned, self.num_roi_samples, 0.25)
                sel = rois[smp.idx]
                cls_logits, deltas = head(self.roi_feats(fb, sem_b, sel, 7))
                loss_cls, loss_reg, labels = bbox_head_loss(
                    cls_logits, deltas, smp, rois, gtb, gt_labels[b],
                    self.num_classes)
                logits = self._mask_logits(
                    self.roi_feats(fb, sem_b, sel, 14), upto=s)
                targets = crop_resize_masks(gt_masks[b], sel, smp.gt_idx, 28)
                loss_mask = mask_head_loss(logits, smp, labels, targets)
                w = STAGE_WEIGHTS[s]
                stage = {"loss_cls": loss_cls * w, "loss_bbox": loss_reg * w,
                         "loss_mask": loss_mask * w}
                for k, v in stage.items():
                    parts.setdefault(f"s{s}.{k}", []).append(v)
                if s < self.num_stages - 1:
                    # every roi refined by this stage for the next
                    with torch.no_grad():
                        _, d = head(self.roi_feats(fb, sem_b, rois, 7))
                        rois = delta2bbox(rois, d[:, 0], STAGE_STDS[s],
                                          (H, W))
        losses.update({k: torch.stack(v).mean() for k, v in parts.items()})
        losses["loss"] = sum(losses.values())
        return losses


# ----------------------------------------------------------------- TTA merge

# Named area bands of the reference per-scale gate (`htc_aug.py:43-65`):
# box AREAS in the original image frame, boundaries at 32^2 / 64^2 / 96^2 /
# 512^2 pixels^2. A band list like ['s', 'm'] keeps the union of bands.
_AREA_BANDS = {
    "s": (-1.0, 32.0 ** 2),
    "m": (32.0 ** 2, 96.0 ** 2),
    "m-": (32.0 ** 2, 64.0 ** 2),
    "m+": (64.0 ** 2, 96.0 ** 2),
    "l": (96.0 ** 2, float("inf")),
    "l-": (96.0 ** 2, 512.0 ** 2),
    "l+": (512.0 ** 2, float("inf")),
}

# bands whose upper bound is exclusive in the reference rule
# (`htc_aug.py:59`: 'l-' keeps areas < 512^2, not <=)
_STRICT_HI = {"l-"}


def remove_boxes_by_scale(boxes: np.ndarray, bands) -> np.ndarray:
    """Per-scale TTA box gate (reference `htc_aug.py:43-65`): keep the
    boxes whose AREA falls in any of the named `bands` (e.g. ``['s',
    'm']``), with the reference's boundaries."""
    area = np.clip((boxes[:, 2] - boxes[:, 0])
                   * (boxes[:, 3] - boxes[:, 1]), 0, None)
    keep = np.zeros(len(boxes), bool)
    for band in bands:
        lo, hi = _AREA_BANDS[band]
        up = (area < hi) if band in _STRICT_HI else (area <= hi)
        keep |= (area > lo) & up
    return keep


# the reference merge's mmcv soft-NMS settings
SOFT_NMS_SIGMA = 0.5
SOFT_NMS_SCORE_THR = 1e-3


def soft_nms(boxes: np.ndarray, scores: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side Gaussian soft-NMS (the reference merge step uses mmcv
    soft_nms): (kept indices, their decayed scores)."""
    boxes = boxes.copy().astype(np.float64)
    scores = scores.copy().astype(np.float64)
    keep = []
    idxs = np.arange(len(boxes))
    while len(idxs) > 0:
        i = idxs[np.argmax(scores[idxs])]
        if scores[i] < SOFT_NMS_SCORE_THR:
            break
        keep.append(i)
        idxs = idxs[idxs != i]
        if len(idxs) == 0:
            break
        ix = np.maximum(0, np.minimum(boxes[idxs, 2], boxes[i, 2])
                        - np.maximum(boxes[idxs, 0], boxes[i, 0]))
        iy = np.maximum(0, np.minimum(boxes[idxs, 3], boxes[i, 3])
                        - np.maximum(boxes[idxs, 1], boxes[i, 1]))
        inter = ix * iy
        union = ((boxes[idxs, 2] - boxes[idxs, 0])
                 * (boxes[idxs, 3] - boxes[idxs, 1])
                 + (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
                 - inter)
        iou = inter / np.maximum(union, 1e-9)
        scores[idxs] *= np.exp(-(iou ** 2) / SOFT_NMS_SIGMA)
    keep = np.asarray(keep, np.int64)
    return keep, scores[keep]


def merge_aug_detections(per_aug: List[Dict[str, np.ndarray]],
                         scale_ranges: List, max_dets: int = 100
                         ) -> Dict[str, np.ndarray]:
    """Merge multi-scale and flip detections (already mapped back to the
    original image frame): each aug's boxes gated by its scale range's
    bands (`remove_boxes_by_scale`), all concatenated, a soft-NMS per
    class, the best `max_dets` kept (reference `htc_aug.py:203-241`).

    Each surviving detection keeps the box-frame mask crop (which does not
    depend on the scale) of the aug that produced it. The reference
    instead runs the mask head on the merged boxes under every aug and
    averages; the JAX package, and so the port, keeps the surviving aug's
    crop (ROADMAP.md §3).
    """
    all_b, all_s, all_l, all_m = [], [], [], []
    for r, bands in zip(per_aug, scale_ranges, strict=True):
        b = np.asarray(r["boxes"])
        s = np.asarray(r["scores"])
        ok = np.isfinite(s) & remove_boxes_by_scale(b, bands)
        all_b.append(b[ok])
        all_s.append(s[ok])
        all_l.append(np.asarray(r["labels"])[ok])
        all_m.append(np.asarray(r["masks"])[ok])
    boxes = np.concatenate(all_b)
    scores = np.concatenate(all_s)
    labels = np.concatenate(all_l)
    masks = np.concatenate(all_m)
    out_b, out_s, out_l, out_m = [], [], [], []
    for c in np.unique(labels):
        m = labels == c
        keep, new_s = soft_nms(boxes[m], scores[m])
        out_b.append(boxes[m][keep])
        out_s.append(new_s)
        out_l.append(np.full(len(keep), c, labels.dtype))
        out_m.append(masks[m][keep])
    boxes = np.concatenate(out_b) if out_b else np.zeros((0, 4))
    scores = np.concatenate(out_s) if out_s else np.zeros((0,))
    labels = np.concatenate(out_l) if out_l else np.zeros((0,), np.int64)
    masks = (np.concatenate(out_m) if out_m
             else np.zeros((0, 28, 28), np.float32))
    order = np.argsort(-scores)[:max_dets]
    return {"boxes": boxes[order], "scores": scores[order],
            "labels": labels[order], "masks": masks[order]}
