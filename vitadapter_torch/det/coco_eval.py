"""Self-contained COCO-protocol detection evaluation (no pycocotools),
copied from `vitadapter/det/coco_eval.py`. The mask IoU is the native
bit-packed popcount (`ops/native.py`, `ops/host/rle.cpp`), as in the JAX
package; `mask_iou_plain` is its numpy version, which gives the same IoUs.

Implements the COCOeval bbox/segm algorithm: greedy per-category matching at
IoU thresholds .5:.05:.95, 101-point interpolated AP, area-range splits and
AR@maxDets — the metrics the reference pins in its READMEs
(`detection/README.md:202-232`). Matching semantics follow the official
protocol: detections sorted by score, each matches the best unmatched gt
(crowd gts can be matched repeatedly and don't count as FP).
"""

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from vitadapter_torch.ops import native

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def box_iou(dets: np.ndarray, gts: np.ndarray,
            iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU (D, G); for crowd gts, intersection-over-det-area (COCO rule)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    lt = np.maximum(dets[:, None, :2], gts[None, :, :2])
    rb = np.minimum(dets[:, None, 2:], gts[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = np.prod(np.clip(dets[:, 2:] - dets[:, :2], 0, None), -1)
    area_g = np.prod(np.clip(gts[:, 2:] - gts[:, :2], 0, None), -1)
    union = area_d[:, None] + area_g[None, :] - inter
    iou = inter / np.maximum(union, 1e-9)
    if iscrowd is not None and iscrowd.any():
        ioa = inter / np.maximum(area_d[:, None], 1e-9)
        iou = np.where(iscrowd[None, :], ioa, iou)
    return iou


def mask_iou(dets: np.ndarray, gts: np.ndarray,
             iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU between binary masks dets (D, H, W) and gts (G, H, W); for crowd
    gts, intersection over the detection's area (COCO rule). The native
    popcount."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    return native.mask_iou_native(dets, gts, iscrowd)


def mask_iou_plain(dets: np.ndarray, gts: np.ndarray,
                   iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """`mask_iou` in dense numpy (its plain version)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    d = dets.reshape(len(dets), -1).astype(bool)
    g = gts.reshape(len(gts), -1).astype(bool)
    inter = (d[:, None] & g[None, :]).sum(-1).astype(np.float64)
    union = (d[:, None] | g[None, :]).sum(-1).astype(np.float64)
    iou = inter / np.maximum(union, 1e-9)
    if iscrowd is not None and iscrowd.any():
        ioa = inter / np.maximum(d.sum(-1)[:, None], 1e-9)
        iou = np.where(iscrowd[None, :], ioa, iou)
    return iou


def _match_image(iou: np.ndarray, gt_ignore: np.ndarray, n_thr: int,
                 iscrowd: np.ndarray):
    """Greedy matching per IoU threshold (pycocotools `evaluateImg` order).

    iou (D, G) with detections score-sorted and gts sorted ignored-LAST
    (the caller permutes; pycocotools sorts gts by `_ignore` so the
    early-break below never skips a live non-ignored gt). Returns
    (dt_matched (T, D) gt idx or -1, dt_ignore (T, D) bool).
    """
    D, G = iou.shape
    dtm = np.full((n_thr, D), -1, np.int64)
    dtig = np.zeros((n_thr, D), bool)
    for t, thr in enumerate(IOU_THRS[:n_thr]):
        gtm = np.full(G, -1, np.int64)
        for d in range(D):
            best, best_iou = -1, min(thr, 1 - 1e-10)
            for g in range(G):
                if gtm[g] >= 0 and not iscrowd[g]:
                    continue
                # gts are ignored-last: once matched to a real gt, the
                # remaining (all ignored) gts can't improve the match
                if best >= 0 and not gt_ignore[best] and gt_ignore[g]:
                    break
                if iou[d, g] < best_iou:
                    continue
                best_iou = iou[d, g]
                best = g
            if best >= 0:
                dtm[t, d] = best
                dtig[t, d] = gt_ignore[best]
                if not iscrowd[best]:
                    gtm[best] = d
    return dtm, dtig


class COCOEvaluator:
    """Accumulate per-image detections/gts, then compute COCO metrics.

    add_image(dets=dict(boxes (D,4) xyxy, scores (D,), labels (D,),
    optional masks (D,H,W)), gts=dict(boxes, labels, optional masks,
    iscrowd)). Labels are contiguous category ids [0, K).
    """

    def __init__(self, num_classes: int, iou_type: str = "bbox",
                 max_dets: int = 100):
        self.K = num_classes
        self.iou_type = iou_type
        self.max_dets = max_dets
        self._per_cat: Dict[int, List] = defaultdict(list)

    def add_image(self, dets: Dict, gts: Dict) -> None:
        self.add_records(self.image_records(dets, gts))

    def add_records(self, records: Dict[int, Dict]) -> None:
        """One image's `image_records`, in the order of the images."""
        for c, rec in records.items():
            self._per_cat[c].append(rec)

    def image_records(self, dets: Dict, gts: Dict) -> Dict[int, Dict]:
        """One image's matching inputs by category (its scores, IoUs and
        areas): what `add_image` stores, picklable, so that the ranks of a
        sharded evaluation can gather them into image order."""
        records: Dict[int, Dict] = {}
        d_boxes = np.asarray(dets["boxes"], np.float64)
        d_scores = np.asarray(dets["scores"], np.float64)
        d_labels = np.asarray(dets["labels"])
        keep = np.isfinite(d_scores)
        order = np.argsort(-d_scores[keep], kind="mergesort")
        di = np.where(keep)[0][order]

        g_boxes = np.asarray(gts["boxes"], np.float64)
        g_labels = np.asarray(gts["labels"])
        g_crowd = np.asarray(gts.get("iscrowd",
                                     np.zeros(len(g_labels), bool)), bool)
        g_valid = np.asarray(gts.get("valid",
                                     np.ones(len(g_labels), bool)), bool)
        # COCOeval gates gts by the ANNOTATION area (the segmentation area,
        # even in bbox mode) when the dataset provides it
        g_ann_area = (np.asarray(gts["area"], np.float64)
                      if gts.get("area") is not None else None)

        for c in range(self.K):
            # store ALL dets score-sorted; pycocotools truncates to maxDets
            # PER (image, category) at evaluate time, separately per budget
            # (evaluateImg: `dt = dt[0:maxDet]` with useCats=1)
            dc = di[d_labels[di] == c]
            gc = np.where(g_valid & (g_labels == c))[0]
            if len(dc) == 0 and len(gc) == 0:
                continue
            if self.iou_type == "segm":
                d_masks = np.asarray(dets["masks"])[dc]
                iou = mask_iou(d_masks, np.asarray(gts["masks"])[gc],
                               g_crowd[gc])
                # reshape(0, -1) is ambiguous for an empty selection
                g_area = (np.asarray(gts["masks"])[gc].reshape(
                    len(gc), -1).sum(-1).astype(np.float64)
                    if len(gc) else np.zeros(0, np.float64))
                # segm det area = mask area (loadRes: maskUtils.area)
                d_area = (d_masks.reshape(len(dc), -1).astype(bool)
                          .sum(-1).astype(np.float64)
                          if len(dc) else np.zeros(0, np.float64))
            else:
                iou = box_iou(d_boxes[dc], g_boxes[gc], g_crowd[gc])
                g_area = np.prod(np.clip(g_boxes[gc, 2:] - g_boxes[gc, :2],
                                         0, None), -1)
                d_area = np.prod(np.clip(d_boxes[dc, 2:] - d_boxes[dc, :2],
                                         0, None), -1)
            if g_ann_area is not None:
                g_area = g_ann_area[gc]
            records[c] = dict(scores=d_scores[dc], iou=iou,
                              crowd=g_crowd[gc], g_area=g_area,
                              d_area=d_area)
        return records

    def _evaluate_cat(self, records, area_rng, max_dets: int):
        """Returns (tp, ignore, n_gt) pooled over images, per threshold."""
        lo, hi = area_rng
        all_scores, all_tp, all_ig, n_gt = [], [], [], 0
        for r in records:
            gt_ignore = r["crowd"] | (r["g_area"] < lo) | (r["g_area"] > hi)
            n_gt += int((~gt_ignore).sum())
            # per-(image, category) det budget (dets are score-sorted)
            m = min(max_dets, len(r["scores"]))
            # pycocotools sorts gts ignored-LAST per area range
            # (evaluateImg: `gtind = np.argsort([g['_ignore'] ...])`)
            g_ord = np.argsort(gt_ignore, kind="mergesort")
            dtm, dtig = _match_image(r["iou"][:m][:, g_ord],
                                     gt_ignore[g_ord], len(IOU_THRS),
                                     r["crowd"][g_ord])
            # unmatched dets outside the area range are ignored, not FP
            out_rng = (r["d_area"][:m] < lo) | (r["d_area"][:m] > hi)
            dt_ignore = dtig | ((dtm < 0) & out_rng[None, :])
            all_scores.append(r["scores"][:m])
            all_tp.append(dtm >= 0)
            all_ig.append(dt_ignore)
        if not all_scores or n_gt == 0:
            return None
        scores = np.concatenate(all_scores)
        tp = np.concatenate(all_tp, axis=1)
        ig = np.concatenate(all_ig, axis=1)
        order = np.argsort(-scores, kind="mergesort")
        tp, ig = tp[:, order], ig[:, order]
        return tp, ig, n_gt

    def _ap_ar_cat(self, records, rng, max_dets: int):
        """(per-threshold AP vector, AR) for one category/area/maxDets —
        the pycocotools `accumulate` math."""
        res = self._evaluate_cat(records, rng, max_dets)
        if res is None:
            return None
        tp, ig, n_gt = res
        keep = ~ig
        ap_t = np.zeros(len(IOU_THRS))
        recs = []
        for t in range(len(IOU_THRS)):
            tps = (tp[t] & keep[t]).astype(np.float64)
            fps = (~tp[t] & keep[t]).astype(np.float64)
            ctp = np.cumsum(tps)
            cfp = np.cumsum(fps)
            recall = ctp / n_gt
            precision = ctp / np.maximum(ctp + cfp, 1e-9)
            # monotone envelope
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            idx = np.searchsorted(recall, RECALL_THRS, side="left")
            pr = np.zeros(len(RECALL_THRS))
            ok = idx < len(precision)
            pr[ok] = precision[idx[ok]]
            ap_t[t] = pr.mean()
            recs.append(recall[-1] if len(recall) else 0.0)
        return ap_t, float(np.mean(recs))

    def summarize(self) -> Dict[str, float]:
        ap = np.full((len(IOU_THRS), len(AREA_RANGES), self.K), np.nan)
        ar = np.full((len(AREA_RANGES), self.K), np.nan)
        ar_md = {md: np.full(self.K, np.nan) for md in (1, 10)}
        for c, records in self._per_cat.items():
            for ai, (name, rng) in enumerate(AREA_RANGES.items()):
                res = self._ap_ar_cat(records, rng, self.max_dets)
                if res is None:
                    continue
                ap[:, ai, c], ar[ai, c] = res
            # AR@{1,10}: 'all' area at smaller per-(image,cat) det budgets
            for md in ar_md:
                res = self._ap_ar_cat(records, AREA_RANGES["all"], md)
                if res is not None:
                    ar_md[md][c] = res[1]

        def m(x):
            return float(np.nanmean(x)) if np.isfinite(x).any() else float("nan")

        return {
            "bbox_mAP" if self.iou_type == "bbox" else "segm_mAP":
                m(ap[:, 0]),
            "mAP_50": m(ap[0, 0]),
            "mAP_75": m(ap[5, 0]),
            "mAP_s": m(ap[:, 1]),
            "mAP_m": m(ap[:, 2]),
            "mAP_l": m(ap[:, 3]),
            "AR@1": m(ar_md[1]),
            "AR@10": m(ar_md[10]),
            "AR@100": m(ar[0]),
            "AR_s": m(ar[1]),
            "AR_m": m(ar[2]),
            "AR_l": m(ar[3]),
        }
