"""Mask utilities (reference `segmentation/mmseg_custom/core/mask/utils.py`),
copied from `vitadapter/det/mask_utils.py`.

`encode_mask_results` -> COCO RLE dicts (via the pure-python codec in
`data/coco.py`); `mask2bbox` -> tight xyxy boxes from binary masks. The
SNIP area tables of the JAX module come with the DETR-family detectors
(ROADMAP.md §1 item 7).
"""

from typing import Dict, List, Sequence

import numpy as np

from vitadapter_torch.data.coco import encode_rle


def mask2bbox(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) binary masks -> (N, 4) xyxy boxes (zeros for empty masks)."""
    N = masks.shape[0]
    out = np.zeros((N, 4), np.float32)
    for i, m in enumerate(np.asarray(masks, bool)):
        ys, xs = np.nonzero(m)
        if len(ys):
            out[i] = [xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]
    return out


def encode_mask_results(masks: Sequence[np.ndarray]) -> List[Dict]:
    """Binary masks -> list of COCO compressed RLE dicts (reference
    `encode_mask_results`, used for result dumps/submissions)."""
    return [encode_rle(np.asarray(m, np.uint8)) for m in masks]
