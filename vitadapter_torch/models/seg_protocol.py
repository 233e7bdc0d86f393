"""The mmseg test-time protocol's host-side helpers (counterpart of
`vitadapter/models/seg_protocol.py`, numpy only).

Reference contract (every published segmentation mIoU was measured under
it):
  1. keep-ratio resize of the raw image to the test `img_scale` canvas
     (under `--aug-test` the canvas is `img_scale * ratio`, mmseg
     MultiScaleFlipAug mode 2),
  2. `ResizeToMultiple(size_divisor=32)`, a second resize, not a pad,
  3. optional horizontal flip, normalize,
  4. slide or whole inference at that scale,
  5. bilinear resize of the count-normalized logits back to `ori_shape`,
     then softmax, then unflip,
  6. average of the per-augmentation probabilities, argmax.
`train/loop.py::run_eval` drives them. The resizes use the port's
`utils/resize.resize_matrix` (PyTorch's `F.interpolate(mode='bilinear',
align_corners=False)` as matrices).
"""

import math
from typing import List, Sequence, Tuple

import numpy as np

from vitadapter_torch.utils.resize import resize_matrix


def rescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmcv.rescale_size: fit (h, w) inside (long, short) keeping the ratio.

    scale_factor = min(max(scale)/max(h,w), min(scale)/min(h,w)); each side
    rounds as int(x * f + 0.5) (mmcv `_scale_size`).
    """
    max_long, max_short = max(scale), min(scale)
    f = min(max_long / max(h, w), max_short / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


def to_multiple(h: int, w: int, divisor: int = 32) -> Tuple[int, int]:
    """mmcv.imresize_to_multiple target size (ceil to the divisor)."""
    return (int(math.ceil(h / divisor)) * divisor,
            int(math.ceil(w / divisor)) * divisor)


def variant_plan(ho: int, wo: int, img_scale: Tuple[int, int], ratio: float,
                 divisor: int = 32):
    """Per-(image, ratio) shapes: canvas -> keep-ratio (h1,w1) -> /32 (h2,w2).

    MultiScaleFlipAug mode 2 truncates each canvas component with int()
    (mmseg test_time_aug.py: `(int(s[0]*r), int(s[1]*r))`).
    """
    canvas = (int(img_scale[0] * ratio), int(img_scale[1] * ratio))
    h1, w1 = rescale_size(ho, wo, canvas)
    h2, w2 = to_multiple(h1, w1, divisor)
    return (h1, w1), (h2, w2)


def _two_taps(m: np.ndarray):
    """A bilinear interpolation matrix (n_out, n_in) as each row's two taps:
    (first column, its weight, last column, its weight or 0 where the row
    has one nonzero)."""
    nz = m != 0
    rows = np.arange(m.shape[0])
    first = nz.argmax(1)
    last = m.shape[1] - 1 - nz[:, ::-1].argmax(1)
    w_last = np.where(last != first, m[rows, last], 0).astype(np.float32)
    return first, m[rows, first], last, w_last


def _resize_axis0(m: np.ndarray, x: np.ndarray) -> np.ndarray:
    i0, w0, i1, w1 = _two_taps(m)
    shape = (-1,) + (1,) * (x.ndim - 1)
    return w0.reshape(shape) * x[i0] + w1.reshape(shape) * x[i1]


def resize_np(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Exact-bilinear (H, W, C) resize on the host by the interpolation
    matrices (half-pixel centres, as mmcv/cv2 INTER_LINEAR): rows, then
    columns. Each output takes the two taps of its matrix row, the product
    by the matrix without its zero terms, so the result is bitwise the
    JAX package's `np.einsum` by the whole matrices, in a small part of
    the time."""
    h, w = img.shape[:2]
    ho, wo = out_hw
    x = np.asarray(img, np.float32)
    if (h, w) == (ho, wo):
        return x
    x = _resize_axis0(resize_matrix(h, ho), x)
    x = _resize_axis0(resize_matrix(w, wo), x.transpose(1, 0, 2))
    return np.ascontiguousarray(x.transpose(1, 0, 2))


def prepare_variant_image(img: np.ndarray, h1w1: Tuple[int, int],
                          h2w2: Tuple[int, int], flip: bool) -> np.ndarray:
    """Steps 1-3 of the protocol on the host: two successive resizes (the
    reference applies Resize then ResizeToMultiple as separate bilinear
    passes, not one direct resize), then the horizontal flip."""
    x = resize_np(resize_np(img, h1w1), h2w2)
    return flipped(x) if flip else np.ascontiguousarray(x, np.float32)


def flipped(x: np.ndarray) -> np.ndarray:
    """The horizontal flip of a prepared (H, W, C) image (it comes after
    both resizes, so flipping the resized image gives the same pixels)."""
    return np.ascontiguousarray(x[:, ::-1], np.float32)


def slide_grid(size: int, crop: int, stride: int) -> List[int]:
    """Reference slide start offsets: i*stride clamped so the window ends
    inside the image; windows never read padding."""
    if size <= crop:
        return [0]
    n = (size - crop + stride - 1) // stride + 1
    return sorted({min(i * stride, size - crop) for i in range(n)})


def slide_plan(h2: int, w2: int, crop: Tuple[int, int],
               stride: Tuple[int, int]):
    """(effective crop, y-starts, x-starts). When the scaled image is smaller
    than the crop in a dimension, the reference scores the small patch
    directly: the effective crop clamps to the image."""
    ce = (min(crop[0], h2), min(crop[1], w2))
    ys = slide_grid(h2, ce[0], stride[0])
    xs = slide_grid(w2, ce[1], stride[1])
    return ce, tuple(ys), tuple(xs)


def count_map(h2: int, w2: int, ce: Tuple[int, int], ys: Sequence[int],
              xs: Sequence[int]) -> np.ndarray:
    """Window counts per pixel of the slide grid (the reference divides the
    summed crop logits by them before the resize to ori_shape)."""
    cnt = np.zeros((h2, w2, 1), np.float32)
    for y in ys:
        for x in xs:
            cnt[y:y + ce[0], x:x + ce[1]] += 1.0
    if not (cnt > 0).all():
        raise ValueError(f"the slide grid {ys} x {xs} of {ce} crops leaves "
                         f"pixels of the {h2}x{w2} image uncovered")
    return cnt


def ori_matrices(h2: int, w2: int, ho: int, wo: int,
                 flip: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(ho, h2) / (wo, w2) interpolation matrices resizing the
    scaled-canvas logits to the true ori_shape. A flipped variant is
    un-flipped by reversing the rows of the column matrix. (The JAX twin
    pads them to shape buckets, which keep its compiled shapes few; the
    eager port needs no padding.)"""
    rm = resize_matrix(w2, wo)
    return (np.asarray(resize_matrix(h2, ho), np.float32),
            np.ascontiguousarray(rm[::-1] if flip else rm, np.float32))


def extract_crops(x: np.ndarray, ce: Tuple[int, int], ys: Sequence[int],
                  xs: Sequence[int]) -> np.ndarray:
    """All slide windows of one scaled image, crop-major:
    (n_y * n_x, ch, cw, C)."""
    return np.stack([x[y:y + ce[0], x0:x0 + ce[1]] for y in ys for x0 in xs])
