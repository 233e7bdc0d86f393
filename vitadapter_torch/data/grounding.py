"""Visual-grounding datasets and metrics (a copy of
`vitadapter/data/grounding.py`, which imports no framework).

Parity targets (reference `wsdm2023/mmdet_custom/datasets/`):
  * `WSDMCocoDataset` (`wsdm2023_coco.py:25`): COCO-format annotations with a
    per-image `question` field; metric = mean IoU of the single top-scoring
    box vs the single gt (`eval_iou:335`).
  * `VGDataset` (`vg_dataset.py:12`): a json list of (image, phrase, box)
    records; metrics Acc@0.5 IoU and mean IoU (`:45-100`).
Pipelines (`apis/pipeline.py:10-80`): LoadRefer / TokenizeRefer (see
`data/tokenization.py`) / RandomParaPhrase (cache lookup) / flip word swap.
`ParaphraseCache.maybe_paraphrase` draws from the RandomState only when the
cache holds alternatives, as the JAX package does, so that one seed gives
both packages the same batches.
"""

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from vitadapter_torch.data.coco import CocoDataset


def box_iou_single(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
          - inter)
    return float(inter / max(ua, 1e-9))


def grounding_metrics(pred_boxes: Sequence[np.ndarray],
                      gt_boxes: Sequence[np.ndarray],
                      thr: float = 0.5) -> Dict[str, float]:
    """Acc@thr-IoU and mean IoU over single-box predictions."""
    ious = [box_iou_single(np.asarray(p, np.float64), np.asarray(g, np.float64))
            for p, g in zip(pred_boxes, gt_boxes)]
    ious = np.asarray(ious)
    return {"mIoU": float(ious.mean()) if len(ious) else 0.0,
            "Acc@%.1f" % thr: float((ious >= thr).mean()) if len(ious) else 0.0}


class WSDMCocoDataset(CocoDataset):
    """COCO-format grounding dataset: one gt box per image + question text."""

    def __init__(self, ann_file: str, img_dir: str):
        super().__init__(ann_file, img_dir, with_masks=False,
                         filter_empty=False)
        with open(ann_file) as f:
            coco = json.load(f)
        self.questions = {im["id"]: im.get("question", "")
                          for im in coco["images"]}

    def load(self, i: int):
        img, targets = super().load(i)
        targets["question"] = self.questions[self.ids[i]]
        return img, targets


class VGDataset:
    """Phrase-grounding records: list of dicts with image / expression / bbox.

    Accepts a json file: [{"image": ..., "expression": ...,
    "bbox": [x1, y1, x2, y2]}, ...].
    """

    def __init__(self, ann_file: str, img_dir: str):
        with open(ann_file) as f:
            self.records = json.load(f)
        self.img_dir = img_dir

    def __len__(self):
        return len(self.records)

    def load(self, i: int):
        r = self.records[i]
        img = np.asarray(Image.open(
            os.path.join(self.img_dir, r["image"])).convert("RGB"))
        return img, {"boxes": np.asarray([r["bbox"]], np.float32),
                     "labels": np.zeros(1, np.int32),
                     # single referred box, never a crowd region — required
                     # by `pad_targets` for the train validity mask
                     "iscrowd": np.zeros(1, bool),
                     "question": r.get("expression", r.get("question", ""))}


class ParaphraseCache:
    """Offline paraphrase lookup for text augmentation (reference
    `RandomParaPhrase` + `tools/paraphrase.py` cache)."""

    def __init__(self, cache_file: Optional[str] = None):
        self.cache: Dict[str, List[str]] = {}
        if cache_file and os.path.exists(cache_file):
            with open(cache_file) as f:
                self.cache = json.load(f)

    def maybe_paraphrase(self, rng: np.random.RandomState, text: str,
                         prob: float = 0.5) -> str:
        alts = self.cache.get(text)
        if alts and rng.rand() < prob:
            return alts[rng.randint(len(alts))]
        return text
