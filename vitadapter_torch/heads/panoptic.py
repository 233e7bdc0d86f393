"""Panoptic and instance post-processing of MaskFormer-family heads
(counterpart of `vitadapter/heads/panoptic.py`; mmdet
`MaskFormerFusionHead.panoptic_postprocess` / `instance_postprocess` as the
reference COCO-panoptic config uses them, with the reference's
`INSTANCE_OFFSET` convention).

The panoptic map encodes `label * INSTANCE_OFFSET + instance id`, -1 for
void. The JAX package counts each query's winning area through a (Q, H, W)
one-hot, 800 MB in fp32 at the panoptic config's 200 queries and 1024 x
1024; the port counts the same integers by a `bincount` of the winners.
"""

from typing import Dict

import torch

from vitadapter_torch.det.boxes import stable_top_k

INSTANCE_OFFSET = 1000


def panoptic_fuse(cls_pred: torch.Tensor, mask_pred: torch.Tensor,
                  num_things: int, num_stuff: int,
                  object_mask_thr: float = 0.8, iou_thr: float = 0.8,
                  overlap_frac_thr: float = 0.8) -> torch.Tensor:
    """Fuse one image's per-query predictions into a panoptic id map:
    cls_pred (Q, K+1) logits, mask_pred (Q, H, W) logits -> (H, W) int32.
    A query is kept if its best class score passes `object_mask_thr`; each
    pixel goes to the kept query of highest score times mask probability;
    a query survives if its fired mask (probability at least 0.5) is
    non-empty and more than `overlap_frac_thr` of it is won; things get
    the id of their query (index + 1), stuff id 0. `iou_thr` is accepted
    and unused, as in the JAX package."""
    K = num_things + num_stuff
    Q = cls_pred.shape[0]
    probs = torch.softmax(cls_pred.float(), dim=-1)[:, :K]
    scores, labels = probs.max(-1).values, probs.argmax(-1)
    keep = scores > object_mask_thr
    masks = torch.sigmoid(mask_pred.float())
    weighted = torch.where(keep[:, None, None], scores[:, None, None] * masks,
                           torch.full_like(masks, -1.0))
    winner = weighted.argmax(dim=0)          # the first of equals
    has_any = weighted.gather(0, winner[None])[0] > 0
    fired = masks >= 0.5
    # each query's won and fired pixels: its fired mask at the pixels it
    # wins, counted by the winners' ids
    won = fired.gather(0, winner[None])[0] & has_any
    win_area = torch.bincount(winner[won], minlength=Q).float()
    full_area = fired.sum(dim=(1, 2)).float()
    ok = keep & (full_area > 0) & (
        win_area / full_area.clamp(min=1.0) > overlap_frac_thr)
    is_thing = labels < num_things
    inst_id = torch.where(is_thing, torch.arange(1, Q + 1,
                                                 device=cls_pred.device), 0)
    seg_id = labels * INSTANCE_OFFSET + inst_id
    pan = torch.where(has_any & ok[winner], seg_id[winner], -1)
    return pan.to(torch.int32)


def instance_postprocess(cls_pred: torch.Tensor, mask_pred: torch.Tensor,
                         num_things: int, max_per_image: int = 100
                         ) -> Dict[str, torch.Tensor]:
    """The top-k (query, thing class) predictions, each score times its
    mask's mean probability inside the binary mask: {"labels", "scores",
    "masks" (k, H, W) bool}."""
    probs = torch.softmax(cls_pred.float(), dim=-1)[:, :num_things]
    flat = probs.reshape(-1)
    top_s, top_i = stable_top_k(flat, min(max_per_image, flat.shape[0]))
    q_idx = torch.div(top_i, num_things, rounding_mode="floor")
    labels = (top_i % num_things).to(torch.int32)
    masks = torch.sigmoid(mask_pred.float())[q_idx]
    binary = masks >= 0.5
    quality = (masks * binary).sum((1, 2)) / binary.sum((1, 2)).clamp(min=1)
    return {"labels": labels, "scores": top_s * quality, "masks": binary}
