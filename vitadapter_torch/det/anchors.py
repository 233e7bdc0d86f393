"""Anchor generation (counterpart of `vitadapter/det/anchors.py`, mmdet
`AnchorGenerator`): scales [8], ratios [0.5, 1, 2], centers on stride * i,
computed on the host in numpy as the JAX package computes them."""

from typing import List, Sequence, Tuple

import numpy as np


def base_anchors(stride: int, scales: Sequence[float],
                 ratios: Sequence[float], center_offset: float = 0.0
                 ) -> np.ndarray:
    """(len(ratios) * len(scales), 4) xyxy anchors around the cell origin."""
    w = h = float(stride)
    cx, cy = center_offset * w, center_offset * h
    out = []
    for r in ratios:
        h_r = np.sqrt(r)
        w_r = 1.0 / h_r
        for s in scales:
            ws, hs = w * s * w_r, h * s * h_r
            out.append([cx - ws / 2, cy - hs / 2, cx + ws / 2, cy + hs / 2])
    return np.asarray(out, np.float32)


def grid_anchors(feat_hw: Tuple[int, int], stride: int,
                 scales: Sequence[float], ratios: Sequence[float]
                 ) -> np.ndarray:
    """(H * W * A, 4) anchors of one level (row-major, anchors fastest)."""
    H, W = feat_hw
    base = base_anchors(stride, scales, ratios)
    xs = np.arange(W, dtype=np.float32) * stride
    ys = np.arange(H, dtype=np.float32) * stride
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def multi_level_anchors(feat_shapes: Sequence[Tuple[int, int]],
                        strides: Sequence[int],
                        scales: Sequence[float] = (8,),
                        ratios: Sequence[float] = (0.5, 1.0, 2.0)
                        ) -> List[np.ndarray]:
    return [grid_anchors(hw, s, scales, ratios)
            for hw, s in zip(feat_shapes, strides)]
