"""Mask utilities (reference `segmentation/mmseg_custom/core/mask/utils.py`),
copied from `vitadapter/det/mask_utils.py`.

`encode_mask_results` -> COCO RLE dicts (via the pure-python codec in
`data/coco.py`); `mask2bbox` -> tight xyxy boxes from binary masks; the
SNIP area tables of the DINO head (`get_area_thr`, `snip_gt_weights`,
`scale_range_filter`).
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


_MAX_E = 1e10
# (short_edge upper bound, min_edge, max_edge) rows, first match wins —
# exact tables from reference `wsdm2023/.../detr_head.py:_get_area_thr:477-545`
_AREA_THR_TABLES = {
    "v1": [(600, 124, _MAX_E), (800, 92, _MAX_E), (1000, 60, _MAX_E),
           (1200, 28, _MAX_E), (1400, 0, _MAX_E), (np.inf, 0, 6)],
    "v2": [(1000, 112, _MAX_E), (1400, 32, 160), (np.inf, 0, 80)],
    "v3": [(800, 96, _MAX_E), (1000, 64, _MAX_E), (1400, 0, _MAX_E),
           (1600, 0, 96), (np.inf, 0, 64)],
    "v4": [(800, 92, _MAX_E), (1000, 60, _MAX_E), (1400, 0, _MAX_E),
           (1600, 0, 68), (np.inf, 0, 36)],
}


def get_area_thr(short_edge: float, version: str = "v1"):
    """SNIP-style area thresholds (min_area, max_area) for a training scale
    (reference `wsdm2023/.../detr_head.py:_get_area_thr:477-545`, versions
    v1-v4): small scales train only large-enough boxes, very large scales
    train only small boxes."""
    for ub, min_e, max_e in _AREA_THR_TABLES[version]:
        if short_edge <= ub:
            return float(min_e) ** 2, float(max_e) ** 2
    raise AssertionError  # tables end with inf


def snip_gt_weights(areas: np.ndarray, short_edge: float,
                    version: str = "v1", weight: float = 0.0) -> np.ndarray:
    """Per-gt loss weights for scale-aware training (reference
    `detr_head.py:_get_target_single:606-620` with `train_cfg.snip_cfg`):
    gts whose ORIGINAL-image area falls outside [min_area, max_area) get
    `snip_cfg.weight` instead of 1. The reference combines the two bounds
    with `&` (which never fires since min <= max); we apply the intended
    out-of-range `|` semantics.
    """
    min_a, max_a = get_area_thr(short_edge, version)
    invalid = (np.asarray(areas) < min_a) | (np.asarray(areas) >= max_a)
    return np.where(invalid, np.float32(weight), np.float32(1.0))


def scale_range_filter(boxes: np.ndarray, short_edge: int,
                       version: str = "v1") -> np.ndarray:
    """Boolean keep mask over gt boxes: in-range under the `version` area
    table for this training scale (hard-filter view of `snip_gt_weights`)."""
    areas = np.clip((boxes[:, 2] - boxes[:, 0])
                    * (boxes[:, 3] - boxes[:, 1]), 0, None)
    return snip_gt_weights(areas, short_edge, version) > 0.5
