"""Host-side training pipeline transforms for semantic segmentation
(numpy/PIL; `train_transform` and its helpers, copied from
`vitadapter/data/transforms.py`).

Parity targets: the mmseg train pipeline used by the reference configs
(`mask2former_beit_adapter_large_896_80k_ade20k_ss.py` train_pipeline):
Resize(ratio_range) -> RandomCrop(cat_max_ratio) -> RandomFlip ->
PhotoMetricDistortion -> Pad(to crop, seg 255). Normalization runs on the
device (`data/preprocess.py`), so the host ships uint8 images and int32
labels.
"""

from typing import Optional, Tuple

import numpy as np
from PIL import Image


def _pil_resize(arr: np.ndarray, size_wh: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    im = Image.fromarray(arr)
    return np.asarray(im.resize(size_wh,
                                Image.NEAREST if nearest else Image.BILINEAR))


def resize_keep_ratio(img: np.ndarray, seg: Optional[np.ndarray],
                      scale: Tuple[int, int], ratio: float = 1.0):
    """mmseg Resize(keep_ratio=True): fit (max_long, max_short)*ratio."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    f = min(max_long * ratio / max(h, w), max_short * ratio / min(h, w))
    nw, nh = max(int(w * f + 0.5), 1), max(int(h * f + 0.5), 1)
    img = _pil_resize(img, (nw, nh))
    if seg is not None:
        seg = _pil_resize(seg, (nw, nh), nearest=True)
    return img, seg


def random_resize(rng: np.random.RandomState, img, seg,
                  scale: Tuple[int, int], ratio_range=(0.5, 2.0)):
    r = rng.uniform(*ratio_range)
    return resize_keep_ratio(img, seg, scale, r)


def random_crop(rng: np.random.RandomState, img, seg,
                crop_size: Tuple[int, int], cat_max_ratio: float = 0.75,
                ignore_index: int = 255, max_tries: int = 10):
    """Crop with re-tries until no single class dominates > cat_max_ratio."""
    ch, cw = crop_size
    h, w = img.shape[:2]

    def rand_box():
        y = rng.randint(0, max(h - ch, 0) + 1)
        x = rng.randint(0, max(w - cw, 0) + 1)
        return y, x

    y, x = rand_box()
    if seg is not None and cat_max_ratio < 1.0:
        for _ in range(max_tries):
            patch = seg[y:y + ch, x:x + cw]
            labels, counts = np.unique(patch, return_counts=True)
            counts = counts[labels != ignore_index]
            if len(counts) > 1 and counts.max() / counts.sum() < cat_max_ratio:
                break
            y, x = rand_box()
    img = img[y:y + ch, x:x + cw]
    if seg is not None:
        seg = seg[y:y + ch, x:x + cw]
    return img, seg


def random_flip(rng: np.random.RandomState, img, seg, prob: float = 0.5):
    if rng.rand() < prob:
        img = img[:, ::-1]
        if seg is not None:
            seg = seg[:, ::-1]
    return img, seg


def photometric_distortion(rng: np.random.RandomState, img: np.ndarray,
                           brightness_delta: int = 32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta: int = 18) -> np.ndarray:
    """mmseg PhotoMetricDistortion: random brightness/contrast/sat/hue with
    the contrast-first/last coin flip."""
    img = img.astype(np.float32)

    def clip(x):
        return np.clip(x, 0, 255)

    if rng.randint(2):
        img = clip(img + rng.uniform(-brightness_delta, brightness_delta))
    contrast_last = rng.randint(2)
    if not contrast_last and rng.randint(2):
        img = clip(img * rng.uniform(*contrast_range))
    # saturation / hue in HSV
    if rng.randint(2) or rng.randint(2):
        hsv = np.asarray(Image.fromarray(img.astype(np.uint8)).convert("HSV"),
                         dtype=np.float32)
        if rng.randint(2):
            hsv[..., 1] = np.clip(hsv[..., 1] * rng.uniform(*saturation_range),
                                  0, 255)
        if rng.randint(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-hue_delta, hue_delta)) % 256
        img = np.asarray(Image.fromarray(hsv.astype(np.uint8), "HSV")
                         .convert("RGB"), dtype=np.float32)
    if contrast_last and rng.randint(2):
        img = clip(img * rng.uniform(*contrast_range))
    return img.astype(np.uint8)


def pad_to(img, seg, size: Tuple[int, int], seg_pad_val: int = 255):
    ch, cw = size
    h, w = img.shape[:2]
    img = np.pad(img, ((0, ch - h), (0, cw - w), (0, 0)))
    if seg is not None:
        seg = np.pad(seg, ((0, ch - h), (0, cw - w)),
                     constant_values=seg_pad_val)
    return img, seg


def train_transform(rng: np.random.RandomState, img: np.ndarray,
                    seg: np.ndarray, crop_size: Tuple[int, int],
                    scale: Tuple[int, int], ratio_range=(0.5, 2.0),
                    cat_max_ratio: float = 0.75):
    """Full reference train pipeline for semantic segmentation."""
    img, seg = random_resize(rng, img, seg, scale, ratio_range)
    img, seg = random_crop(rng, img, seg, crop_size, cat_max_ratio)
    img, seg = random_flip(rng, img, seg)
    img = photometric_distortion(rng, img)
    img, seg = pad_to(img, seg, crop_size)
    return np.ascontiguousarray(img), np.ascontiguousarray(seg)
