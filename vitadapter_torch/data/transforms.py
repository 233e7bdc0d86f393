"""Host-side training pipeline transforms (numpy/PIL, copied from
`vitadapter/data/transforms.py`): `train_transform` and its helpers for
semantic segmentation, and the `det_*` detection pipeline with
`DET_SCALES`.

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


DET_SCALES = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
DET_SCALES_SMALL = (400, 500, 600)


def det_flip(rng: np.random.RandomState, img, boxes, masks, prob=0.5):
    if rng.rand() < prob:
        w = img.shape[1]
        img = img[:, ::-1]
        boxes = boxes[:, [2, 1, 0, 3]] * np.asarray(
            [-1, 1, -1, 1], np.float32) + np.asarray([w, 0, w, 0], np.float32)
        if masks is not None and len(masks):
            masks = masks[:, :, ::-1]
    return img, boxes, masks


def det_resize_short(img, boxes, masks, short: int, max_long: int = 1333):
    """mmdet Resize(keep_ratio): short edge -> `short`, long edge <= 1333."""
    h, w = img.shape[:2]
    f = min(short / min(h, w), max_long / max(h, w))
    nw, nh = max(int(w * f + 0.5), 1), max(int(h * f + 0.5), 1)
    sx, sy = nw / w, nh / h
    img = _pil_resize(img, (nw, nh))
    boxes = boxes * np.asarray([sx, sy, sx, sy], np.float32)
    if masks is not None and len(masks):
        masks = np.stack([_pil_resize(m.astype(np.uint8), (nw, nh),
                                      nearest=True) for m in masks])
    elif masks is not None:
        masks = np.zeros((0, nh, nw), np.uint8)
    return img, boxes, masks


def det_random_crop(rng: np.random.RandomState, img, boxes, masks,
                    crop_range: Tuple[int, int]):
    """mmdet RandomCrop(crop_type='absolute_range'): sample the crop h/w
    uniformly from [lo, hi] (capped at the image), random position, shift and
    clip boxes (allow_negative_crop semantics: empty result is fine)."""
    lo, hi = crop_range
    h, w = img.shape[:2]
    ch = min(h, rng.randint(min(lo, h), min(hi, h) + 1))
    cw = min(w, rng.randint(min(lo, w), min(hi, w) + 1))
    y = rng.randint(0, h - ch + 1)
    x = rng.randint(0, w - cw + 1)
    return _apply_crop(img, boxes, masks, y, x, ch, cw)


def _apply_crop(img, boxes, masks, y, x, ch, cw):
    img = img[y:y + ch, x:x + cw]
    boxes = boxes - np.asarray([x, y, x, y], np.float32)
    boxes = np.clip(boxes, 0, [cw, ch, cw, ch]).astype(np.float32)
    if masks is not None and len(masks):
        masks = masks[:, y:y + ch, x:x + cw]
    elif masks is not None:
        masks = np.zeros((0, ch, cw), np.uint8)
    return img, boxes, masks


def det_autoaugment(rng: np.random.RandomState, img, boxes, masks,
                    scales=DET_SCALES, scales_small=DET_SCALES_SMALL,
                    crop_range=(384, 600), max_long: int = 1333):
    """The two-policy AutoAugment: plain multi-scale resize, or
    resize-crop-resize (policy list at `..._tiny_fpn_3x_coco.py:44-72`)."""
    if rng.randint(2) == 0:
        short = scales[rng.randint(len(scales))]
        return det_resize_short(img, boxes, masks, short, max_long)
    short = scales_small[rng.randint(len(scales_small))]
    img, boxes, masks = det_resize_short(img, boxes, masks, short, max_long)
    img, boxes, masks = det_random_crop(rng, img, boxes, masks, crop_range)
    short = scales[rng.randint(len(scales))]
    return det_resize_short(img, boxes, masks, short, max_long)


def det_train_transform(rng: np.random.RandomState, img, boxes, masks,
                        crop_size: Tuple[int, int], autoaug: bool = True,
                        photometric: bool = False, max_long: int = 1333,
                        flip: Optional[bool] = None,
                        scales=DET_SCALES, scales_small=DET_SCALES_SMALL,
                        crop_range=(384, 600)):
    """Full reference det train pipeline into a STATIC (ch, cw) canvas.

    RandomFlip -> AutoAugment (or a single multi-scale resize) ->
    random-crop to at most the static crop -> photometric (HTC++-style
    configs) -> zero-pad to (ch, cw). Returns (img uint8 (ch, cw, 3), boxes
    (N, 4) xyxy in crop coords, masks (N, ch, cw) uint8 or None, keep mask).
    """
    ch, cw = crop_size
    # caller may pin the flip decision (grounding must swap left/right words
    # in the referring text on flip — reference `RandomFlipWithRefer`)
    img, boxes, masks = det_flip(rng, img, boxes, masks,
                                 prob=(0.5 if flip is None else float(flip)))
    if autoaug:
        img, boxes, masks = det_autoaugment(
            rng, img, boxes, masks, scales=scales,
            scales_small=scales_small, crop_range=crop_range,
            max_long=max_long)
    else:
        short = scales[rng.randint(len(scales))]
        img, boxes, masks = det_resize_short(img, boxes, masks, short,
                                             max_long)
    h, w = img.shape[:2]
    if h > ch or w > cw:
        hh, ww = min(h, ch), min(w, cw)
        y = rng.randint(0, h - hh + 1)
        x = rng.randint(0, w - ww + 1)
        img, boxes, masks = _apply_crop(img, boxes, masks, y, x, hh, ww)
    if photometric:
        img = photometric_distortion(rng, img)
    h, w = img.shape[:2]
    img = np.pad(img, ((0, ch - h), (0, cw - w), (0, 0)))
    if masks is not None:
        masks = np.pad(masks, ((0, 0), (0, ch - h), (0, cw - w)))
    keep = ((boxes[:, 2] - boxes[:, 0] > 1) & (boxes[:, 3] - boxes[:, 1] > 1))
    return np.ascontiguousarray(img), boxes, masks, keep
