"""Panoptic Quality (PQ) evaluation, self-contained: a copy of
`vitadapter/det/panoptic_eval.py` (numpy only).

Parity target: the COCO panoptic protocol the reference pins
(`detection/configs/mask2former/README.md:84` PQ dict; reference
`panoptic_utils.py` INSTANCE_OFFSET convention). Matches segments between
prediction and gt panoptic id maps by IoU > 0.5 (unique by construction) and
reports PQ = SQ * RQ overall and per things/stuff.
"""

from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np

from vitadapter_torch.heads.panoptic import INSTANCE_OFFSET

VOID = -1


class PQEvaluator:
    def __init__(self, num_things: int, num_stuff: int):
        self.num_things = num_things
        self.K = num_things + num_stuff
        self.iou = np.zeros(self.K)
        self.tp = np.zeros(self.K, np.int64)
        self.fp = np.zeros(self.K, np.int64)
        self.fn = np.zeros(self.K, np.int64)

    @staticmethod
    def _segments(pan: np.ndarray):
        ids, counts = np.unique(pan, return_counts=True)
        return {int(i): int(c) for i, c in zip(ids, counts) if i != VOID}

    def add_image(self, pred_pan: np.ndarray, gt_pan: np.ndarray) -> None:
        self.add_stats(self.image_stats(pred_pan, gt_pan))

    def add_stats(self, stats: Tuple[list, list, list]) -> None:
        """One image's `image_stats`, in the order of the images."""
        tp, fn, fp = stats
        for k, iou in tp:
            self.tp[k] += 1
            self.iou[k] += iou
        for k in fn:
            self.fn[k] += 1
        for k in fp:
            self.fp[k] += 1

    def image_stats(self, pred_pan: np.ndarray, gt_pan: np.ndarray
                    ) -> Tuple[list, list, list]:
        """One image's matches (class, IoU), unmatched gt classes and
        false-positive classes, in the order `add_image` counts them:
        picklable, so that the ranks of a sharded evaluation can gather
        them into image order."""
        tp, fn, fp = [], [], []
        pred_segs = self._segments(pred_pan)
        gt_segs = self._segments(gt_pan)
        # joint histogram of (gt_id, pred_id) pairs
        valid = (gt_pan != VOID)
        combined = gt_pan.astype(np.int64) * (2 ** 32) + \
            (pred_pan.astype(np.int64) + 2)  # shift pred to be >= 1
        ids, counts = np.unique(combined[valid], return_counts=True)
        inter = {}
        for cid, c in zip(ids, counts):
            g = int(cid >> 32)
            p = int((cid & 0xFFFFFFFF) - 2)
            inter[(g, p)] = int(c)

        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if p == VOID or g == VOID:
                continue
            if g // INSTANCE_OFFSET != p // INSTANCE_OFFSET:
                continue  # different class
            union = gt_segs[g] + pred_segs.get(p, 0) - c \
                - inter.get((VOID, p), 0)
            iou = c / max(union, 1)
            if iou > 0.5:
                tp.append((g // INSTANCE_OFFSET, iou))
                matched_gt.add(g)
                matched_pred.add(p)
        for g in gt_segs:
            if g not in matched_gt:
                fn.append(g // INSTANCE_OFFSET)
        for p, area in pred_segs.items():
            if p in matched_pred:
                continue
            # preds mostly covering void are ignored, not FP (COCO rule)
            void_area = int(((pred_pan == p) & ~valid).sum())
            if void_area / max(area, 1) > 0.5:
                continue
            fp.append(p // INSTANCE_OFFSET)
        return tp, fn, fp

    def summarize(self) -> Dict[str, float]:
        denom = self.tp + self.fp / 2 + self.fn / 2
        with np.errstate(divide="ignore", invalid="ignore"):
            pq = np.where(denom > 0, self.iou / np.maximum(denom, 1e-9),
                          np.nan)
            sq = np.where(self.tp > 0, self.iou / np.maximum(self.tp, 1e-9),
                          np.nan)
            rq = np.where(denom > 0, self.tp / np.maximum(denom, 1e-9),
                          np.nan)

        def m(x, sl=slice(None)):
            v = x[sl]
            return float(np.nanmean(v)) if np.isfinite(v).any() else 0.0

        return {
            "PQ": m(pq), "SQ": m(sq), "RQ": m(rq),
            "PQ_th": m(pq, slice(0, self.num_things)),
            "PQ_st": m(pq, slice(self.num_things, self.K)),
        }
