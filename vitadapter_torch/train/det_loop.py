"""Config-driven detection training and evaluation (counterpart of
`vitadapter/train/det_loop.py`, on one device), for Mask R-CNN.

`run_det_training` is the reference's `detection/train.py` on the port's
step loop (`train/loop.py::train_steps`): the COCO pipeline (flip,
AutoAugment or one multi-scale resize, crop and zero pad to the static
`crop_size` canvas) or synthetic batches, checkpoints, resume and the
in-training `bbox`/`segm` evaluation. `run_det_eval` is `test.py --eval
bbox segm`: keep-ratio resize to `test_cfg.img_scale`, zero pad to one of
two canvases (landscape or portrait), detections mapped back to the
original frame, masks pasted from their 28x28 box crops, COCO metrics.
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
from vitadapter_torch.data.loader import EpochSampler, prefetch
from vitadapter_torch.data.preprocess import normalize
from vitadapter_torch.det.coco_eval import COCOEvaluator
from vitadapter_torch.train.loop import build_train_state, train_steps
from vitadapter_torch.train.trainer import TrainState, make_det_train_step
from vitadapter_torch.zoo import resolve_device

# the root `train.py`'s detector types: `tools.train` sends these here, and
# `build_model` names the ROADMAP.md item of those not ported yet
DETECTORS = ("MaskRCNN", "CascadeRCNN", "ATSS", "SparseRCNN", "DINO",
             "GroundingDINO")
# the grounding datasets come with ROADMAP.md §1 item 8
DET_DATASETS = {"CocoDataset": CocoDataset}


def build_det_dataset(data_cfg: Dict[str, Any], split: str,
                      with_masks: bool = True):
    cls = DET_DATASETS[data_cfg["dataset_type"]]
    sub = data_cfg[split]
    root = data_cfg.get("data_root", "")
    return cls(os.path.join(root, sub["ann_file"]),
               os.path.join(root, sub["img_dir"]), with_masks=with_masks)


def det_train_batches(dataset, data_cfg, batch_size: int, seed: int = 0,
                      sampler=None) -> Iterator[Dict[str, np.ndarray]]:
    """The reference det pipeline into static-shape batches, as the JAX
    package's `det_train_batches` (same draws from `seed`): RandomFlip ->
    AutoAugment (11-scale short-edge resize | resize -> absolute-range crop
    -> resize) -> crop and pad to the static canvas, photometric distortion
    where the config asks; targets padded to `max_instances`. Images ship
    as uint8 and masks as bool."""
    rng = np.random.RandomState(seed)
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
        imgs, targets = [], []
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
        batch = {"image": np.stack(imgs).astype(np.uint8),
                 "gt_boxes": np.stack([t["boxes"] for t in targets]),
                 "gt_labels": np.stack([t["labels"] for t in targets]),
                 "gt_valid": np.stack([t["valid"] for t in targets])}
        if targets[0].get("masks") is not None:
            batch["gt_masks"] = np.stack(
                [t["masks"] for t in targets]).astype(bool)
        yield batch


def synthetic_det_batches(batch: int, crop, max_inst: int,
                          num_classes: int) -> Iterator[Dict[str, np.ndarray]]:
    """The JAX loop's synthetic batches (`max_inst` random boxes of 8-40
    pixels in the canvas's top-left quarter, random labels and pixels),
    with random masks drawn as bits: each pixel of each instance is set
    with probability 1/2, as the JAX loop's `rand > 0.5`, but from random
    bytes (0.1 s for 100 masks of 1024x1024, where `rand` takes 1.8)."""
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
        bits = rng.randint(0, 256, (batch, max_inst, ch, -(-cw // 8)),
                           dtype=np.uint8)
        b["gt_masks"] = np.unpackbits(bits, axis=-1)[..., :cw].astype(bool)
        yield b


def det_batch_to_device(b: Dict[str, np.ndarray], device: torch.device):
    return {"image": normalize(torch.from_numpy(b["image"]).to(device)),
            "gt_boxes": torch.from_numpy(b["gt_boxes"]).to(device).float(),
            "gt_labels": torch.from_numpy(b["gt_labels"]).to(device).long(),
            "gt_valid": torch.from_numpy(b["gt_valid"]).to(device),
            "gt_masks": torch.from_numpy(b["gt_masks"]).to(device)}


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
    if synthetic:
        it = synthetic_det_batches(batch, crop, max_inst,
                                   cfg.model.get("num_classes", 80))
    else:
        ds = build_det_dataset(cfg.data, "train")
        sampler = EpochSampler(len(ds), seed=0)
        it = prefetch(lambda s: det_train_batches(ds, cfg.data, batch,
                                                  seed=s, sampler=sampler),
                      num_threads=cfg.data.get("workers", 4))

    # the in-training evaluation (mmcv EvalHook; the det configs set
    # `evaluation = dict(metric=['bbox', 'segm'])`)
    ev_cfg = dict(cfg.get("evaluation", {}))
    evaluate = None
    if ev_cfg.get("interval") and not synthetic:
        try:
            val_ds = build_det_dataset(cfg.data, "val")
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
    static canvases, `test_cfg.images_per_device` (2) images of a canvas a
    model call, detections mapped back to the original frame. `--aug-test`
    needs the config's `tta` scales (HTC++'s); the merge of augmented
    detections comes with Cascade/HTC (ROADMAP.md §1 item 7). The model
    runs on the device of its parameters, in eval mode. Returns the
    metrics, and under `timing` the seconds spent in model calls (to a
    synchronize) and on the host (load, resize, paste, evaluator)."""
    tcfg = dict(cfg.get("test_cfg") or {})
    img_scale = tuple(tcfg.get("img_scale", (1333, 800)))
    if aug_test:
        if not dict(cfg.get("tta") or {}).get("scales"):
            raise ValueError(
                "--aug-test requires a `tta = dict(scales=[...])` config "
                "(see configs/htc/htc++_..._ms.py)")
        raise NotImplementedError(
            "--aug-test's merge of augmented detections is not ported yet: "
            "ROADMAP.md §1 item 7 (Cascade/HTC)")
    evaluators = {t: COCOEvaluator(dataset.num_classes, iou_type=t)
                  for t in iou_types}
    per_call = int(tcfg.get("images_per_device", 2))
    device = next(model.parameters()).device
    n = min(len(dataset), max_images or len(dataset))
    pending: Dict[tuple, list] = {}
    forward_s = 0.0
    done = 0

    def flush(key):
        nonlocal forward_s, done
        items = pending.pop(key, [])
        if not items:
            return
        t0 = time.perf_counter()
        x = torch.from_numpy(np.stack([it[0] for it in items])).to(device)
        out = {k: v.float().cpu().numpy() if v.is_floating_point()
               else v.cpu().numpy() for k, v in model(normalize(x)).items()}
        forward_s += time.perf_counter() - t0
        for j, (_, meta, H, W, gts) in enumerate(items):
            dets = _map_back_one_aug({k: v[j].copy() for k, v in out.items()},
                                     meta)
            if "segm" in evaluators:
                dets["masks"] = paste_mask_crops(dets, H, W)
            for ev in evaluators.values():
                ev.add_image(dets, gts)
            done += 1
            if done % 100 == 0 or done == n:
                log_fn(f"eval {done}/{n}")

    t_start = time.perf_counter()
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for i in range(n):
                img, gts = dataset.load(i)
                x, meta = _prep_one_aug(img, img_scale, False)
                key = x.shape[:2]
                pending.setdefault(key, []).append(
                    (x, meta, img.shape[0], img.shape[1], gts))
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
    metrics["timing"] = {"images": n, "forward_s": forward_s,
                         "host_s": total_s - forward_s}
    log_fn(f"eval time: {n} images, model calls {forward_s:.3f} s, host "
           f"{total_s - forward_s:.3f} s")
    return metrics
