"""Config-driven detection training and evaluation (counterpart of
`vitadapter/train/det_loop.py`, on one device), for Mask R-CNN, Cascade
Mask R-CNN / HTC++ and the DINO detectors, GroundingDINO among them.

`run_det_training` is the reference's `detection/train.py` on the port's
step loop (`train/loop.py::train_steps`): the COCO pipeline (flip,
AutoAugment or one multi-scale resize, crop and zero pad to the static
`crop_size` canvas) or synthetic batches, checkpoints, resume and the
in-training `bbox`/`segm` evaluation. `run_det_eval` is `test.py --eval
bbox segm [--aug-test]`: keep-ratio resize to `test_cfg.img_scale` (or to
each `tta` scale, flipped and not), zero pad to one of two canvases
(landscape or portrait), detections mapped back to the original frame
(and the augs merged), masks pasted from their 28x28 box crops, COCO
metrics. `run_grounding_eval` is `test.py --eval IoU [--aug-test]`: the
top box of each image (or the vote over the scales and flips), Acc@0.5
and mIoU against its one gt box.
The JAX version shards images over a device mesh with one compiled program
per canvas; the port runs `test_cfg.images_per_device` images of a canvas
a model call, eagerly. Ground-truth masks travel as bool and are read as
they are on the device. As the JAX loop does, training takes the config's
optimizer with 500 warmup steps and the poly schedule, whatever its
`lr_config` says, and reads `checkpoint_config.interval` in steps.
"""

import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
from PIL import Image

from vitadapter_torch.data import transforms as T
from vitadapter_torch.data.coco import CocoDataset, pad_targets
from vitadapter_torch.data.grounding import (ParaphraseCache, VGDataset,
                                             WSDMCocoDataset,
                                             grounding_metrics)
from vitadapter_torch.data.tokenization import ClipTokenizer, random_flip_refer
from vitadapter_torch.data.loader import EpochSampler, prefetch
from vitadapter_torch.data.preprocess import normalize
from vitadapter_torch.det.cascade import merge_aug_detections
from vitadapter_torch.det.coco_eval import COCOEvaluator
from vitadapter_torch.det.grounding_dino import aug_test_vote
from vitadapter_torch.train.loop import build_train_state, train_steps
from vitadapter_torch.train.trainer import TrainState, make_det_train_step
from vitadapter_torch.zoo import resolve_device

# the root `train.py`'s detector types: `tools.train` sends these here, and
# `build_model` names the ROADMAP.md item of those not ported yet (ATSS,
# SparseRCNN)
DETECTORS = ("MaskRCNN", "CascadeRCNN", "ATSS", "SparseRCNN", "DINO",
             "GroundingDINO")
# the detectors trained on masks
MASK_DETECTORS = ("MaskRCNN", "CascadeRCNN")
DET_DATASETS = {"CocoDataset": CocoDataset,
                "WSDMCocoDataset": WSDMCocoDataset, "VGDataset": VGDataset}


def build_det_dataset(data_cfg: Dict[str, Any], split: str,
                      with_masks: bool = True):
    cls = DET_DATASETS[data_cfg["dataset_type"]]
    sub = data_cfg[split]
    root = data_cfg.get("data_root", "")
    kwargs = {"with_masks": with_masks} if cls is CocoDataset else {}
    return cls(os.path.join(root, sub["ann_file"]),
               os.path.join(root, sub["img_dir"]), **kwargs)


def det_train_batches(dataset, data_cfg, batch_size: int, seed: int = 0,
                      tokenizer=None,
                      sampler=None) -> Iterator[Dict[str, np.ndarray]]:
    """The reference det pipeline into static-shape batches, as the JAX
    package's `det_train_batches` (same draws from `seed`): RandomFlip ->
    AutoAugment (11-scale short-edge resize | resize -> absolute-range crop
    -> resize) -> crop and pad to the static canvas, photometric distortion
    where the config asks; targets padded to `max_instances`. Images ship
    as uint8 and masks as bool. With a `tokenizer` (grounding) each image's
    question rides along: a paraphrase from `data.paraphrase_cache` where
    it holds one, the left/right words swapped with the flip, then
    `refer`/`r_mask` ids and mask padded to `max_sent_len`."""
    rng = np.random.RandomState(seed)
    max_sent = data_cfg.get("max_sent_len", 128)
    para = None
    if tokenizer is not None and data_cfg.get("paraphrase_cache"):
        para = ParaphraseCache(data_cfg["paraphrase_cache"])
    ch, cw = data_cfg["crop_size"]
    max_inst = data_cfg.get("max_instances", 100)
    kw = dict(autoaug=data_cfg.get("autoaug", True),
              photometric=data_cfg.get("photometric", False),
              max_long=data_cfg.get("max_long_edge", 1333),
              scales=tuple(data_cfg.get("det_scales", T.DET_SCALES)),
              scales_small=tuple(data_cfg.get("det_scales_small",
                                              T.DET_SCALES_SMALL)),
              crop_range=tuple(data_cfg.get("det_crop_range", (384, 600))))
    n = len(dataset)
    order = rng.permutation(n)
    pos = 0
    while True:
        if sampler is not None:
            idxs = sampler.take(batch_size)
        else:
            idxs = []
            for _ in range(batch_size):
                if pos >= n:
                    order = rng.permutation(n)
                    pos = 0
                idxs.append(int(order[pos]))
                pos += 1
        imgs, targets, refs = [], [], []
        for idx in idxs:
            img, t = dataset.load(idx)
            flip = bool(rng.rand() < 0.5)
            img2, boxes, masks, keep = T.det_train_transform(
                rng, img, t["boxes"].astype(np.float32), t.get("masks"),
                (ch, cw), flip=flip, **kw)
            t2 = {k: (v[keep] if isinstance(v, np.ndarray)
                      and len(v) == len(keep) else v) for k, v in t.items()}
            t2["boxes"] = boxes[keep]
            t2["masks"] = masks[keep] if masks is not None else None
            targets.append(pad_targets(t2, max_inst))
            imgs.append(img2)
            if tokenizer is not None:
                q = t.get("question", "")
                if para is not None:
                    q = para.maybe_paraphrase(rng, q)
                if flip:
                    q = random_flip_refer(q)
                refs.append(tokenizer.tokenize_refer(q, max_sent))
        batch = {"image": np.stack(imgs).astype(np.uint8),
                 "gt_boxes": np.stack([t["boxes"] for t in targets]),
                 "gt_labels": np.stack([t["labels"] for t in targets]),
                 "gt_valid": np.stack([t["valid"] for t in targets])}
        if targets[0].get("masks") is not None:
            batch["gt_masks"] = np.stack(
                [t["masks"] for t in targets]).astype(bool)
        if tokenizer is not None:
            batch["refer"] = np.asarray([r[0] for r in refs], np.int32)
            batch["r_mask"] = np.asarray([r[1] for r in refs], np.int32)
        yield batch


def synthetic_det_batches(batch: int, crop, max_inst: int,
                          num_classes: int, masks: bool = True,
                          text: Optional[tuple] = None
                          ) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX loop's synthetic batches (`max_inst` random boxes of 8-40
    pixels in the canvas's top-left quarter, random labels and pixels),
    with random masks drawn as bits where `masks`: each pixel of each
    instance is set with probability 1/2, as the JAX loop's `rand > 0.5`,
    but from random bytes (0.1 s for 100 masks of 1024x1024, where `rand`
    takes 1.8). With `text` = (vocab size, sentence length), random
    `refer` ids and an all-ones `r_mask`, as the JAX loop's grounding
    batches."""
    rng = np.random.RandomState(0)
    ch, cw = crop
    while True:
        xy = rng.rand(batch, max_inst, 2) * (min(ch, cw) // 2)
        wh = rng.rand(batch, max_inst, 2) * 32 + 8
        b = {"image": rng.rand(batch, ch, cw, 3).astype(np.float32) * 255,
             "gt_boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
             "gt_labels": rng.randint(0, num_classes, (batch, max_inst)
                                      ).astype(np.int32),
             "gt_valid": np.ones((batch, max_inst), bool)}
        if masks:
            bits = rng.randint(0, 256, (batch, max_inst, ch, -(-cw // 8)),
                               dtype=np.uint8)
            b["gt_masks"] = np.unpackbits(bits, axis=-1)[..., :cw].astype(
                bool)
        if text is not None:
            vocab, max_sent = text
            b["refer"] = rng.randint(0, vocab, (batch, max_sent)).astype(
                np.int32)
            b["r_mask"] = np.ones((batch, max_sent), np.int32)
        yield b


def det_batch_to_device(b: Dict[str, np.ndarray], device: torch.device):
    out = {"image": normalize(torch.from_numpy(b["image"]).to(device)),
           "gt_boxes": torch.from_numpy(b["gt_boxes"]).to(device).float(),
           "gt_labels": torch.from_numpy(b["gt_labels"]).to(device).long(),
           "gt_valid": torch.from_numpy(b["gt_valid"]).to(device)}
    for k in ("gt_masks", "refer", "r_mask"):
        if k in b:
            out[k] = torch.from_numpy(b[k]).to(device)
    return out


def _iou_types(metric) -> tuple:
    mets = [metric] if isinstance(metric, str) else list(metric)
    return tuple(m for m in ("bbox", "segm") if m in mets)


def run_det_training(cfg, work_dir: str, resume: bool = False,
                     max_iters: Optional[int] = None, synthetic: bool = False,
                     device=None, log_fn=print) -> TrainState:
    """Train the config's detector on `device` (CUDA when None; raises
    where there is none): `samples_per_chip` images a step, resume from
    the latest checkpoint in `work_dir/ckpt`, logs, checkpoints and, with
    real data, the `evaluation.interval` hook (`bbox`/`segm` metrics, the
    best step's state in `work_dir/best_<key>` with `save_best`). As in
    the JAX loop, synthetic data runs no evaluation, the run is
    `runner.max_iters` steps (90000 when the config counts epochs), a
    resumed run starts the data stream and the DropPath generator anew,
    and `pretrained` weights are not loaded. Returns the final state."""
    device = resolve_device(device)
    total = max_iters or cfg.get("runner", {}).get("max_iters", 90000)
    model, state, schedule, start = build_train_state(
        cfg, device, total, 500, "poly", work_dir, resume, log_fn)
    batch = cfg.data.get("samples_per_chip", 2)
    crop = tuple(cfg.data["crop_size"])
    max_inst = cfg.data.get("max_instances", 100)
    needs_masks = cfg.model["type"] in MASK_DETECTORS
    grounding = cfg.model["type"] == "GroundingDINO"
    if synthetic:
        text = ((cfg.model["backbone"].get("vocab_size", 49411),
                 cfg.data.get("max_sent_len", 128)) if grounding else None)
        it = synthetic_det_batches(batch, crop, max_inst,
                                   cfg.model.get("num_classes", 80),
                                   masks=needs_masks, text=text)
    else:
        ds = build_det_dataset(cfg.data, "train", with_masks=needs_masks)
        tok = ClipTokenizer(cfg.data.get("bpe_vocab")) if grounding else None
        sampler = EpochSampler(len(ds), seed=0)
        it = prefetch(lambda s: det_train_batches(ds, cfg.data, batch,
                                                  seed=s, tokenizer=tok,
                                                  sampler=sampler),
                      num_threads=cfg.data.get("workers", 4))

    # the in-training evaluation (mmcv EvalHook; the det configs set
    # `evaluation = dict(metric=['bbox', 'segm'])`). As in the JAX loop it
    # is `run_det_eval` for every detector: the GQA grounding configs'
    # `interval=1` hook calls GroundingDINO without its text and raises
    # (ROADMAP.md §3)
    ev_cfg = dict(cfg.get("evaluation", {}))
    evaluate = None
    if ev_cfg.get("interval") and not synthetic:
        try:
            val_ds = build_det_dataset(cfg.data, "val",
                                       with_masks=needs_masks)
        except (KeyError, FileNotFoundError) as e:
            log_fn(f"eval hook disabled (no val dataset: {e})")
            val_ds = None
        if val_ds is not None:
            def evaluate():
                return run_det_eval(
                    cfg, model, val_ds,
                    _iou_types(ev_cfg.get("metric", ["bbox"])),
                    max_images=ev_cfg.get("max_images"), log_fn=log_fn)

    return train_steps(cfg, state, make_det_train_step(model), it,
                       lambda b: det_batch_to_device(b, device), start, total,
                       schedule, work_dir, device, evaluate,
                       ckpt_interval=5000, log_fn=log_fn)


def test_canvas(scale, size_divisor: int = 32):
    """Static pad canvases for a keep-ratio test scale: (landscape,
    portrait), each side rounded up to `size_divisor`."""
    ml, ms = max(scale), min(scale)
    long_p = -(-ml // size_divisor) * size_divisor
    short_p = -(-ms // size_divisor) * size_divisor
    return (short_p, long_p), (long_p, short_p)


def _prep_one_aug(img, scale, flip: bool):
    """Keep-ratio resize, optional hflip, zero pad to the orientation's
    canvas. Returns (padded float32 input, meta for mapping back)."""
    h0, w0 = img.shape[:2]
    im2, _ = T.resize_keep_ratio(img, None, scale)
    rh, rw = im2.shape[:2]
    if flip:
        im2 = im2[:, ::-1]
    land, port = test_canvas(scale)
    ch, cw = land if rw >= rh else port
    x = np.zeros((ch, cw, 3), np.float32)
    x[:rh, :rw] = im2
    return x, (rh, rw, flip, h0, w0)


def _map_back_one_aug(dets, meta):
    """Detections back to the original frame (reference
    `bbox_mapping_back`: unflip in the aug frame, then unscale); those
    wholly in the zero padding get score 0."""
    rh, rw, flip, h0, w0 = meta
    boxes = dets["boxes"].astype(np.float32)
    if "scores" in dets:
        pad_det = (boxes[:, 0] >= rw) | (boxes[:, 1] >= rh)
        dets["scores"] = np.where(pad_det, 0.0, dets["scores"])
    if flip:
        boxes = np.stack([rw - boxes[:, 2], boxes[:, 1],
                          rw - boxes[:, 0], boxes[:, 3]], -1)
        if "masks" in dets:
            dets["masks"] = dets["masks"][:, :, ::-1]
    boxes = boxes * np.asarray([w0 / rw, h0 / rh, w0 / rw, h0 / rh],
                               np.float32)
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w0)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h0)
    dets["boxes"] = boxes
    return dets


def paste_mask_crops(dets: Dict[str, np.ndarray], H: int, W: int
                     ) -> np.ndarray:
    """Paste each detection's box-frame mask crop into a full-size binary
    mask (a PIL resize of the crop to its rounded box)."""
    full = np.zeros((len(dets["boxes"]), H, W), bool)
    for d, (box, m) in enumerate(zip(dets["boxes"], dets["masks"])):
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        x2, y2 = min(max(x2, x1 + 1), W), min(max(y2, y1 + 1), H)
        x1, y1 = max(x1, 0), max(y1, 0)
        if x2 <= x1 or y2 <= y1:
            continue
        mm = np.asarray(Image.fromarray(
            (m * 255).astype(np.uint8)).resize((x2 - x1, y2 - y1))) > 127
        full[d, y1:y2, x1:x2] = mm
    return full


def run_det_eval(cfg, model: torch.nn.Module, dataset, iou_types=("bbox",),
                 aug_test: bool = False, max_images: Optional[int] = None,
                 log_fn=print) -> Dict[str, Any]:
    """COCO-protocol metrics of `model` on `dataset` (reference
    `detection/test.py --eval bbox segm`): images keep-ratio resized to
    `test_cfg.img_scale` ((1333, 800) by default) and padded to one of two
    static canvases, `test_cfg.images_per_device` (2) inputs of a canvas a
    model call, detections mapped back to the original frame. With
    `aug_test` and the config's `tta` scales (HTC++'s `_ms` configs), the
    reference HTC-Aug protocol (`htc_aug.py:203-241`): every scale with and
    without the flip, each aug's boxes gated by its `tta.scale_ranges`
    entry (the JAX package's `ranges[i // 2]` over the (scale 0, scale 0
    flipped, scale 1, ...) order), then `det/cascade.py::
    merge_aug_detections`. The model runs on the device of its parameters,
    in eval mode. Returns the metrics, and under `timing` the seconds spent
    in model calls (to a synchronize) and on the host (load, resize, merge,
    paste, evaluator)."""
    tcfg = dict(cfg.get("test_cfg") or {})
    img_scale = tuple(tcfg.get("img_scale", (1333, 800)))
    tta = dict(cfg.get("tta") or {}) if aug_test else {}
    if aug_test and not (tta.get("scales") and tta.get("scale_ranges")):
        raise ValueError(
            "--aug-test requires a `tta = dict(scales=[...], "
            "scale_ranges=[...])` config (see configs/htc/htc++_..._ms.py)")
    if aug_test:
        scales = [tuple(sc) for sc in tta["scales"]]
        flips = (False, True)
        per_aug_ranges = [bands for bands in tta["scale_ranges"]
                          for _ in flips]
    else:
        scales, flips, per_aug_ranges = [img_scale], (False,), None
    augs = [(sc, f) for sc in scales for f in flips]
    evaluators = {t: COCOEvaluator(dataset.num_classes, iou_type=t)
                  for t in iou_types}
    per_call = int(tcfg.get("images_per_device", 2))
    device = next(model.parameters()).device
    n = min(len(dataset), max_images or len(dataset))
    results: Dict[int, list] = {}
    per_img: Dict[int, tuple] = {}
    pending: Dict[tuple, list] = {}
    forward_s = 0.0
    done = 0

    def finalize(i):
        nonlocal done
        per_aug = results.pop(i)
        H, W, gts = per_img.pop(i)
        if aug_test:
            dets = merge_aug_detections(
                per_aug, scale_ranges=per_aug_ranges,
                max_dets=tta.get("max_per_img", 100))
        else:
            dets = per_aug[0]
        if "masks" in dets and "segm" in evaluators:
            dets["masks"] = paste_mask_crops(dets, H, W)
        for ev in evaluators.values():
            ev.add_image(dets, gts)
        done += 1
        if done % 100 == 0 or done == n:
            log_fn(f"eval {done}/{n}")

    def flush(key):
        nonlocal forward_s
        items = pending.pop(key, [])
        if not items:
            return
        t0 = time.perf_counter()
        x = torch.from_numpy(np.stack([it[0] for it in items])).to(device)
        out = {k: v.float().cpu().numpy() if v.is_floating_point()
               else v.cpu().numpy() for k, v in model(normalize(x)).items()}
        forward_s += time.perf_counter() - t0
        for j, (_, meta, i, a) in enumerate(items):
            results[i][a] = _map_back_one_aug(
                {k: v[j].copy() for k, v in out.items()}, meta)
            if all(r is not None for r in results[i]):
                finalize(i)

    t_start = time.perf_counter()
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for i in range(n):
                img, gts = dataset.load(i)
                results[i] = [None] * len(augs)
                per_img[i] = (img.shape[0], img.shape[1], gts)
                for a, (sc, flip) in enumerate(augs):
                    x, meta = _prep_one_aug(img, sc, flip)
                    key = x.shape[:2]
                    pending.setdefault(key, []).append((x, meta, i, a))
                    if len(pending[key]) == per_call:
                        flush(key)
            for key in list(pending):
                flush(key)
    finally:
        model.train(was_training)
    metrics: Dict[str, Any] = {}
    for ev in evaluators.values():
        metrics.update(ev.summarize())
    log_fn(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    total_s = time.perf_counter() - t_start
    metrics["timing"] = {"images": n, "augs": len(augs),
                         "forward_s": forward_s,
                         "host_s": total_s - forward_s}
    log_fn(f"eval time: {n} images x {len(augs)} augs, model calls "
           f"{forward_s:.3f} s, host {total_s - forward_s:.3f} s")
    return metrics


def grounding_tta_scales(cfg, aug_test: bool):
    """(scales, flips) of a grounding test run: `test_cfg.img_scale`
    ((1333, 800) by default) unflipped, or with `aug_test` the config's
    `tta.scales` ((long, short) pairs, or floats as ratios of img_scale;
    (1333, 600), (1333, 800), (1333, 1000) by default), each unflipped and,
    unless `tta.flip` is False, flipped."""
    img_scale = tuple((cfg.get("test_cfg") or {}).get("img_scale",
                                                       (1333, 800)))
    if not aug_test:
        return [img_scale], (False,)
    tta = dict(cfg.get("tta") or {})
    raw = tta.get("scales", [(1333, 600), (1333, 800), (1333, 1000)])
    scales = [tuple(sc) if isinstance(sc, (tuple, list))
              else (int(max(img_scale) * sc), int(min(img_scale) * sc))
              for sc in raw]
    return scales, ((False, True) if tta.get("flip", True) else (False,))


def run_grounding_eval(cfg, model: torch.nn.Module, dataset,
                       aug_test: bool = False,
                       max_images: Optional[int] = None, log_fn=print,
                       tokenizer=None) -> Dict[str, Any]:
    """Single-box grounding metrics of `model` on `dataset` (`test.py
    --eval IoU`; reference `vg_dataset.py:45-100`): each image keep-ratio
    resized to each test scale (`grounding_tta_scales`), flipped where the
    aug says (its question's left/right words swapped), zero padded to the
    scale's landscape or portrait canvas, `test_cfg.images_per_device` (2)
    inputs of a canvas a model call (the last call of a canvas filled up by
    repeating its last input, whose results are dropped, as the JAX
    package's batch slack); boxes unflipped in the aug's frame, then
    unscaled. The prediction is the top-scoring box, or with `aug_test`
    `det/grounding_dino.py::aug_test_vote` over the augs. Returns mIoU and
    Acc@0.5 against each image's first gt box, the predictions
    (`boxes`, (n, 4) in original pixels) and under `timing` the seconds in
    model calls (to a synchronize) and on the host."""
    if tokenizer is None:
        tokenizer = ClipTokenizer(cfg.data.get("bpe_vocab"))
    max_sent = cfg.data.get("max_sent_len", 128)
    scales, flips = grounding_tta_scales(cfg, aug_test)
    per_call = int((cfg.get("test_cfg") or {}).get("images_per_device", 2))
    device = next(model.parameters()).device
    n = min(len(dataset), max_images or len(dataset))
    n_aug = len(scales) * len(flips)
    results: Dict[int, list] = {}
    preds: Dict[int, np.ndarray] = {}
    gts: Dict[int, np.ndarray] = {}
    pending: Dict[tuple, list] = {}
    forward_s = 0.0

    def finalize(i):
        per_aug = results.pop(i)
        if len(per_aug) == 1:
            preds[i] = per_aug[0]["boxes"][int(np.argmax(
                per_aug[0]["scores"]))]
        else:
            preds[i] = aug_test_vote(per_aug)
        if len(preds) % 100 == 0 or len(preds) == n:
            log_fn(f"eval {len(preds)}/{n}")

    def flush(key):
        nonlocal forward_s
        items = pending.pop(key, [])
        if not items:
            return
        k_real = len(items)
        items = items + [items[-1]] * (-k_real % per_call)
        t0 = time.perf_counter()
        x = torch.from_numpy(np.stack([it[0] for it in items])).to(device)
        ids = torch.from_numpy(np.stack([it[1] for it in items])).to(device)
        rm = torch.from_numpy(np.stack([it[2] for it in items])).to(device)
        out = model(normalize(x), ids, rm)
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        forward_s += time.perf_counter() - t0
        for j in range(k_real):
            _, _, _, (rh, rw, fl, h0, w0), i, a = items[j]
            boxes = out["boxes"][j].astype(np.float32)
            if fl:      # unflip in the aug's frame, then unscale
                boxes = np.stack([rw - boxes[:, 2], boxes[:, 1],
                                  rw - boxes[:, 0], boxes[:, 3]], -1)
            results[i][a] = {
                "boxes": boxes * np.asarray([w0 / rw, h0 / rh, w0 / rw,
                                             h0 / rh], np.float32),
                "scores": out["scores"][j]}
            if all(r is not None for r in results[i]):
                finalize(i)

    t_start = time.perf_counter()
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for i in range(n):
                img, t = dataset.load(i)
                question = t.get("question", "")
                toks = {fl: tokenizer.tokenize_refer(
                    random_flip_refer(question) if fl else question,
                    max_sent) for fl in flips}
                gts[i] = np.asarray(t["boxes"][0], np.float32)
                results[i] = [None] * n_aug
                a = 0
                for sc in scales:
                    im2, _ = T.resize_keep_ratio(img, None, sc)
                    rh, rw = im2.shape[:2]
                    land, port = test_canvas(sc)
                    ch, cw = land if rw >= rh else port
                    for fl in flips:
                        x = np.zeros((ch, cw, 3), np.float32)
                        x[:rh, :rw] = im2[:, ::-1] if fl else im2
                        ids, r_mask = toks[fl]
                        pending.setdefault((ch, cw), []).append(
                            (x, np.asarray(ids, np.int32),
                             np.asarray(r_mask, np.int32),
                             (rh, rw, fl, img.shape[0], img.shape[1]), i, a))
                        if len(pending[(ch, cw)]) == per_call:
                            flush((ch, cw))
                        a += 1
            for key in list(pending):
                flush(key)
    finally:
        model.train(was_training)
    metrics: Dict[str, Any] = grounding_metrics(
        [preds[i] for i in range(n)], [gts[i] for i in range(n)])
    log_fn(" ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    total_s = time.perf_counter() - t_start
    metrics["boxes"] = np.stack([preds[i] for i in range(n)]) if n else \
        np.zeros((0, 4), np.float32)
    metrics["timing"] = {"images": n, "augs": n_aug, "forward_s": forward_s,
                         "host_s": total_s - forward_s}
    log_fn(f"eval time: {n} images x {n_aug} augs, model calls "
           f"{forward_s:.3f} s, host {total_s - forward_s:.3f} s")
    return metrics
