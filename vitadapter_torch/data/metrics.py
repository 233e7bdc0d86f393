"""Segmentation metrics: confusion matrix -> mIoU / aAcc / mAcc
(counterpart of `vitadapter/data/metrics.py`; mmseg `eval_metrics`)."""

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int, ignore_index: int = 255
                     ) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts[gt, pred] over the pixels
    whose label is not `ignore_index`, on the tensors' device. Pairs that
    fall outside the matrix (a label >= num_classes) are dropped, as the
    JAX scatter drops them."""
    valid = label != ignore_index
    idx = label.long() * num_classes + pred.long()
    idx = idx[valid & (idx >= 0) & (idx < num_classes * num_classes)]
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def miou_from_confusion(cm: np.ndarray):
    """Returns dict with aAcc, mIoU, mAcc (classes absent from the labels
    excluded, as mmseg)."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    gt = cm.sum(1)
    pr = cm.sum(0)
    union = gt + pr - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = tp / union
        acc = tp / gt
    present = gt > 0
    return {
        "aAcc": float(tp.sum() / max(cm.sum(), 1)),
        "mIoU": float(np.nanmean(np.where(present, iou, np.nan))),
        "mAcc": float(np.nanmean(np.where(present, acc, np.nan))),
    }
