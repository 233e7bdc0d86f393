"""Segmentation evaluation under the reference test protocol (counterpart
of `vitadapter/train/loop.py::run_eval`, on one device).

The JAX version batches images of one shape signature over a device mesh
and caches one compiled program per signature; on one card the port runs
each image eagerly, in the same order of operations.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from vitadapter_torch.data.metrics import confusion_matrix, miou_from_confusion
from vitadapter_torch.data.preprocess import normalize
from vitadapter_torch.models import seg_protocol as SP

# the reference `--aug-test` ratios (segmentation/test.py:131-136)
AUG_TEST = dict(img_ratios=[0.5, 0.75, 1.0, 1.25, 1.5, 1.75], flip=True)


def _score_crops(model, crops: np.ndarray, chunk: int,
                 device: torch.device) -> torch.Tensor:
    """Per-class logits (N, ch, cw, K) fp32 of raw-pixel crops (N, ch, cw, 3),
    `chunk` crops per model call."""
    outs = []
    for s in range(0, crops.shape[0], chunk):
        x = torch.from_numpy(crops[s:s + chunk]).to(device)
        outs.append(model(normalize(x)).float())
    return torch.cat(outs)


def run_eval(cfg: Dict[str, Any], model: torch.nn.Module, dataset,
             aug_test: bool = False, max_images: Optional[int] = None,
             log_fn=print) -> Dict[str, Any]:
    """mIoU of `model` on `dataset` under the reference protocol
    (`test.py --eval mIoU [--aug-test]`, see `models/seg_protocol.py`):
    keep-ratio resize to the test `img_scale` -> ResizeToMultiple(32) ->
    flip -> slide or whole scoring -> count-normalize -> resize to the
    original shape (the unflip folded into the column matrix) -> softmax ->
    average over the augmentations -> argmax -> confusion against the
    255-masked original-resolution labels.

    `cfg` is a plain dict with the JAX config's keys: `num_classes`,
    `test_cfg` (`mode` "whole" or "slide", `crop_size`, `stride`,
    `img_scale`, `size_divisor`, `pad_bucket`, `crops_per_device`: the
    crops per model call here; `ori_bucket`, the JAX side's shape bucket,
    has no use in eager mode and is ignored), `data.scale` (or
    `data.test_scale`) and `aug_test` (`img_ratios`, `flip`), which
    overrides the reference `--aug-test` set when `aug_test` is true.
    Ratios scale the `img_scale` canvas (MultiScaleFlipAug mode 2).
    `dataset` has `__len__` and `load(i) -> (uint8 HxWx3, int HxW)`. The
    model runs on the device of its parameters, in eval mode. Returns
    aAcc, mIoU, mAcc and `confusion`, the (K, K) int64 counts[gt, pred].
    """
    num_classes = cfg["num_classes"]
    test_cfg = dict(cfg.get("test_cfg") or {})
    data_cfg = cfg.get("data") or {}
    mode = test_cfg.get("mode", "whole")
    img_scale = (test_cfg.get("img_scale") or data_cfg.get("test_scale")
                 or data_cfg.get("scale"))
    divisor = test_cfg.get("size_divisor", 32)
    if img_scale is None and mode == "whole":
        # out-of-protocol configs (no test scale): a coarser multiple
        divisor = test_cfg.get("pad_bucket", 128)
    img_scale = tuple(img_scale) if img_scale is not None else None

    ms_cfg = dict(cfg.get("aug_test") or AUG_TEST) if aug_test else None
    ratios = tuple(ms_cfg["img_ratios"]) if ms_cfg else (1.0,)
    do_flip = bool(ms_cfg.get("flip", True)) if ms_cfg else False
    flips = (False, True) if do_flip else (False,)
    n_aug = len(ratios) * len(flips)

    crop = tuple(test_cfg["crop_size"]) if mode == "slide" else None
    stride = tuple(test_cfg.get("stride") or crop) if mode == "slide" else None
    chunk = test_cfg.get("crops_per_device", 2)
    device = next(model.parameters()).device

    cm = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                     device=device)
    n = min(len(dataset), max_images or len(dataset))
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for i in range(n):
                img, seg = dataset.load(i)
                img = np.asarray(img)
                seg = np.asarray(seg, np.int32)
                ho, wo = seg.shape[:2]
                acc = None
                for r in ratios:
                    if img_scale is None:
                        h1w1, h2w2 = (ho, wo), SP.to_multiple(ho, wo, divisor)
                    else:
                        h1w1, h2w2 = SP.variant_plan(ho, wo, img_scale, r,
                                                     divisor)
                    h2, w2 = h2w2
                    ce, ys, xs = (SP.slide_plan(h2, w2, crop, stride)
                                  if mode == "slide"
                                  else ((h2, w2), (0,), (0,)))
                    cnt = torch.from_numpy(
                        SP.count_map(h2, w2, ce, ys, xs)).to(device)
                    for fl in flips:
                        x = SP.prepare_variant_image(img, h1w1, h2w2, fl)
                        logits = _score_crops(
                            model, SP.extract_crops(x, ce, ys, xs), chunk,
                            device)
                        canvas = torch.zeros((h2, w2, num_classes),
                                             dtype=torch.float32,
                                             device=device)
                        k = 0
                        for y in ys:
                            for x0 in xs:
                                canvas[y:y + ce[0], x0:x0 + ce[1]] += logits[k]
                                k += 1
                        canvas = canvas / cnt
                        mh, mw = (torch.from_numpy(m).to(device)
                                  for m in SP.ori_matrices(h2, w2, ho, wo,
                                                           fl))
                        o = torch.einsum("oh,hwk->owk", mh, canvas)
                        o = torch.einsum("ow,hwk->hok", mw, o)
                        probs = torch.softmax(o, dim=-1)
                        acc = probs if acc is None else acc + probs
                acc = acc / n_aug
                cm += confusion_matrix(acc.argmax(dim=-1),
                                       torch.from_numpy(seg).to(device),
                                       num_classes)
                if (i + 1) % 50 == 0 or i + 1 == n:
                    log_fn(f"eval {i + 1}/{n}")
    finally:
        model.train(was_training)
    cm = cm.cpu().numpy()
    metrics: Dict[str, Any] = miou_from_confusion(cm)
    log_fn(f"aAcc {metrics['aAcc']*100:.2f} | mIoU {metrics['mIoU']*100:.2f} "
           f"| mAcc {metrics['mAcc']*100:.2f}")
    metrics["confusion"] = cm
    return metrics
