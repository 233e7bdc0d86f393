"""Config-driven training and evaluation for segmentation (counterpart of
`vitadapter/train/loop.py`), on one card or data-parallel over the ranks
of a process group (`parallel/`).

`run_training` replaces the reference's mm runner (IterBasedRunner and its
hooks): the model and optimizer from the config, resume, a host data
pipeline (folder datasets with the train transforms, or synthetic
batches), logging (lr, time, data time, ETA, memory), checkpoints and an
in-training mIoU evaluation with best-checkpoint selection. `run_eval` is
the reference test protocol. The JAX version batches images of one shape
signature over a device mesh and caches one compiled program per
signature; the port runs each image eagerly, in the same order of
operations, each rank taking every W-th image.

With W ranks a step takes `samples_per_chip` images on each rank, W times
that in all, as JAX's step over a W-device mesh; rank 0 alone logs and
writes checkpoints, the others waiting for it at a barrier.
"""

import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from vitadapter_torch.builder import build_model
from vitadapter_torch.data import transforms as T
from vitadapter_torch.data.datasets import DATASETS
from vitadapter_torch.data.loader import EpochSampler, image_rng, prefetch
from vitadapter_torch.data.metrics import confusion_matrix, miou_from_confusion
from vitadapter_torch.data.preprocess import normalize
from vitadapter_torch.models import seg_protocol as SP
from vitadapter_torch.parallel.collectives import barrier, broadcast_object
from vitadapter_torch.parallel.mesh import (rank_generator, rank_rows,
                                            replicate, shard_batch, world)
from vitadapter_torch.train.optim import make_optimizer
from vitadapter_torch.train.trainer import (TrainState, make_m2f_train_step,
                                            make_seg_train_step)
from vitadapter_torch.utils.checkpoint_io import (latest_step,
                                                  restore_checkpoint,
                                                  save_checkpoint)
from vitadapter_torch.utils.profiling import StepTimer, device_memory_stats
from vitadapter_torch.zoo import resolve_device

def build_dataset(data_cfg: Dict[str, Any], split: str):
    ds_cls = DATASETS[data_cfg["dataset_type"]]
    sub = data_cfg[split]
    root = data_cfg.get("data_root", "")
    return ds_cls(os.path.join(root, sub["img_dir"]),
                  os.path.join(root, sub["ann_dir"]) if sub.get("ann_dir")
                  else None)


def _seg_aug(data_cfg) -> tuple:
    """`transforms.train_transform`'s arguments after the draws: crop,
    scale, ratio range, cat_max_ratio."""
    return (tuple(data_cfg["crop_size"]), tuple(data_cfg["scale"]),
            tuple(data_cfg.get("ratio_range", (0.5, 2.0))),
            data_cfg.get("cat_max_ratio", 0.75))


def _seg_batch(samples) -> Dict[str, np.ndarray]:
    return {"image": np.stack([s[0] for s in samples]).astype(np.float32),
            "label": np.stack([s[1] for s in samples]).astype(np.int32)}


def step_batches(dataset, data_cfg, batch_size: int, seed: int = 0,
                 num_threads: int = 4) -> Iterator[Dict[str, np.ndarray]]:
    """This rank's rows of each step's global batch of `batch_size` images
    (`parallel.rank_rows`), prefetched in step order: step k takes
    positions [k * batch_size, (k + 1) * batch_size) of an `EpochSampler`
    stream (every image once an epoch) and each image's augmentation draws
    from `image_rng(seed, k, position)`, so that W ranks load the rows of
    the batch one process would load."""
    sampler = EpochSampler(len(dataset), seed)
    rows = rank_rows(batch_size)
    aug = _seg_aug(data_cfg)

    def make(step):
        idxs = sampler.indices(step * batch_size + rows.start, len(rows))
        return _seg_batch([T.train_transform(image_rng(seed, step, j),
                                             *dataset.load(i), *aug)
                           for j, i in zip(rows, idxs)])

    return prefetch(make, num_threads=num_threads)


def synthetic_batches(batch_size: int, crop, num_classes: int):
    rng = np.random.RandomState(0)
    while True:
        yield {
            "image": rng.randint(0, 256, (batch_size, *crop, 3)).astype(
                np.float32),
            "label": rng.randint(0, num_classes,
                                 (batch_size, *crop)).astype(np.int32),
        }


class SyntheticSegDataset:
    """Tiny fixed in-memory (img, seg) set for the synthetic-mode eval hook."""

    def __init__(self, n: int, crop, num_classes: int, seed: int = 7):
        rng = np.random.RandomState(seed)
        self.items = [
            (rng.randint(0, 256, (*crop, 3)).astype(np.uint8),
             rng.randint(0, num_classes, crop).astype(np.int32))
            for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def load(self, i: int):
        return self.items[i]


def eval_config(cfg) -> Dict[str, Any]:
    """The plain dict `run_eval` takes, from a segmentation config."""
    return {"num_classes": cfg["model"]["decode_head"]["num_classes"],
            "test_cfg": dict(cfg.get("test_cfg") or {}),
            "data": dict(cfg.get("data") or {}),
            "aug_test": cfg.get("aug_test")}


def _to_device(batch: Dict[str, np.ndarray], device: torch.device):
    return {"image": normalize(torch.from_numpy(batch["image"]).to(device)),
            "label": torch.from_numpy(batch["label"]).to(device).long()}


def _memory_words(device: torch.device) -> str:
    """The device's peak allocation so far, as the reference logs it."""
    if device.type != "cuda":
        return ""
    stats = device_memory_stats()[f"cuda:{device.index or 0}"]
    return f" memory={stats['peak_bytes_in_use'] / 2 ** 20:.0f}MiB"


def build_train_state(cfg, device: torch.device, total: int,
                      warmup_steps: int, lr_policy: str, work_dir: str,
                      resume: bool, log_fn):
    """The config's model on `device`, its optimizer (AdamW with layer
    decay over the backbone's `depth`) and schedule, and the train state,
    restored from the latest checkpoint in `work_dir/ckpt` when `resume`
    (the step rank 0 finds, on every rank); the model's parameters and
    buffers are rank 0's on every rank. Returns (model, state, schedule,
    the step to start at)."""
    # `build_model` refuses the types not ported yet, naming their item
    model = build_model(dict(cfg.model), device=device)
    opt = cfg.optimizer
    optimizer, schedule = make_optimizer(
        model, base_lr=opt["lr"], weight_decay=opt["weight_decay"],
        depth=cfg.model["backbone"]["depth"],
        layer_decay_rate=opt.get("layer_decay_rate", 1.0),
        total_steps=total, warmup_steps=warmup_steps,
        grad_clip=opt.get("grad_clip"), lr_policy=lr_policy)
    state = TrainState.create(model, optimizer)
    n_params = sum(p.numel() for p in model.parameters())
    # fp32 parameters, their gradients and AdamW's two moments
    log_fn(f"{cfg.model['type']} with {cfg.model['backbone']['type']}: "
           f"{n_params} parameters; parameters, gradients and AdamW moments "
           f"take {16 * n_params / 2 ** 30:.2f} GiB on {device}, a "
           f"checkpoint {12 * n_params / 2 ** 30:.2f} GiB on disk")
    start = 0
    ckpt_dir = os.path.join(work_dir, "ckpt")
    step = broadcast_object(latest_step(ckpt_dir) if resume else None)
    if step is not None:
        restore_checkpoint(ckpt_dir, state, step)
        start = state.step
        log_fn(f"resumed from step {start}")
    replicate(model)
    return model, state, schedule, start


def run_training(cfg, work_dir: str, resume: bool = False,
                 max_iters: Optional[int] = None, synthetic: bool = False,
                 device=None, log_fn=print) -> TrainState:
    """Train the config's segmentor on `device` (CUDA when None, this
    rank's card under a process group; raises where there is none):
    `samples_per_chip` images a step on each rank (times the world size in
    all), the config's optimizer and schedule, resume from the latest
    checkpoint in `work_dir/ckpt`, logs every `log_config.interval` steps,
    checkpoints every `checkpoint_config.interval` steps and at the end,
    and the in-training evaluation every `evaluation.interval` steps (with
    `save_best`, the best step's state in `work_dir/best_<key>`). As in
    the JAX loop, a resumed run starts the data stream and the DropPath
    generator anew, and the config's `pretrained` weights are not loaded.
    Returns the final `TrainState`."""
    device = resolve_device(device)
    rank, size, _ = world()
    if rank:
        log_fn = silent
    total = max_iters or cfg.runner["max_iters"]
    model, state, schedule, start = build_train_state(
        cfg, device, total, cfg.lr_config.get("warmup_iters", 1500),
        cfg.lr_config.get("policy", "poly"), work_dir, resume, log_fn)
    mtype = cfg.model["type"]
    num_classes = cfg.model["decode_head"]["num_classes"]
    crop = tuple(cfg.data["crop_size"])
    batch = cfg.data.get("samples_per_chip", 2) * size
    if size > 1:
        log_fn(f"data parallel over {size} ranks: {batch} images a step")
    if mtype == "EncoderDecoderMask2Former":
        tc = cfg.get("train_cfg", {})
        step_fn = make_m2f_train_step(
            model, num_classes=num_classes,
            max_instances=tc.get("max_instances", 60),
            num_points=tc.get("num_points", 12544))
    else:
        step_fn = make_seg_train_step(model, cfg.get("aux_loss_weight", 0.4))

    if synthetic:
        it = map(shard_batch, synthetic_batches(batch, crop, num_classes))
    else:
        # threaded prefetch hides host-side decode/augment behind device
        # compute
        it = step_batches(build_dataset(cfg.data, "train"), cfg.data, batch,
                          num_threads=cfg.data.get("workers", 4))

    # in-training evaluation + best-checkpoint selection (the reference's
    # mmcv EvalHook: `evaluation = dict(interval=8000, metric='mIoU',
    # save_best='mIoU')`)
    ev_cfg = dict(cfg.get("evaluation", {}))
    evaluate = None
    if ev_cfg.get("interval"):
        if synthetic:
            val_ds = SyntheticSegDataset(2, crop, num_classes)
        else:
            try:
                val_ds = build_dataset(cfg.data, "val")
            except (KeyError, FileNotFoundError) as e:
                log_fn(f"eval hook disabled (no val dataset: {e})")
                val_ds = None
        if val_ds is not None:
            def evaluate():
                return run_eval(eval_config(cfg), model, val_ds,
                                max_images=ev_cfg.get("max_images"),
                                log_fn=log_fn)

    return train_steps(cfg, state, step_fn, it,
                       lambda b: _to_device(b, device), start, total,
                       schedule, work_dir, device, evaluate,
                       ckpt_interval=1000, log_fn=log_fn)


def train_steps(cfg, state: TrainState, step_fn, it, to_device, start: int,
                total: int, schedule, work_dir: str, device, evaluate,
                ckpt_interval: int, log_fn=print) -> TrainState:
    """The step loop that the segmentation and detection runs share: steps
    [start, total) of `step_fn(state, batch, generator)` on batches of `it`
    put on the device by `to_device` (the next one while the device runs
    the step), DropPath's generator seeded from (1, rank); logs every
    `log_config.interval` steps (loss, lr, time, data time, ETA, grad norm,
    peak memory), checkpoints every `checkpoint_config.interval` steps
    (`ckpt_interval` by default) and at the end, and every
    `evaluation.interval` steps and at the end `evaluate()`, when given,
    whose metrics pick the best checkpoint (`evaluation.save_best`) into
    `work_dir/best_<key>`. Only rank 0 writes checkpoints (the others
    wait for it); `log_fn` should log on rank 0 alone. Returns the final
    `TrainState`."""
    log_int = cfg.get("log_config", {}).get("interval", 50)
    ckpt_cfg = cfg.get("checkpoint_config", {})
    ckpt_int = ckpt_cfg.get("interval", ckpt_interval)
    ckpt_dir = os.path.join(work_dir, "ckpt")
    ev_cfg = dict(cfg.get("evaluation", {}))
    ev_int = ev_cfg.get("interval") if evaluate is not None else None
    best = -float("inf")

    generator = rank_generator(device, 1)
    timer = StepTimer(device)
    # the next batch is fetched and copied while the device runs the step
    b = to_device(next(it))
    for i in range(start, total):
        state, logs = step_fn(state, b, generator)
        timer.step()
        t0 = time.perf_counter()
        if i + 1 < total:
            b = to_device(next(it))
        timer.data_tick(time.perf_counter() - t0)
        if (i + 1) % log_int == 0:
            logs = {k: float(v) for k, v in logs.items()}
            s = timer.summary(total - i - 1)
            log_fn(f"iter {i + 1}/{total} loss={logs['loss']:.4f} "
                   f"lr={schedule(i):.3e} time={s['time']:.3f}s "
                   f"data_time={s['data_time']:.3f}s "
                   f"eta={s['eta_hours']:.2f}h "
                   f"grad_norm={logs['grad_norm']:.2f}"
                   f"{_memory_words(device)}")
            timer.reset()
        if (i + 1) % ckpt_int == 0 or (i + 1) == total:
            _save(ckpt_dir, i + 1, state, ckpt_cfg.get("max_keep_ckpts", 1),
                  log_fn)
            timer.reset()  # a checkpoint is not counted in step time
        if ev_int and ((i + 1) % ev_int == 0 or (i + 1) == total):
            metrics = evaluate()
            key = ev_cfg.get("save_best")
            if key and metrics.get(key, -float("inf")) > best:
                best = metrics[key]
                _save(os.path.join(work_dir, f"best_{key}"), i + 1, state, 1,
                      log_fn)
                log_fn(f"iter {i + 1}: new best {key}={best:.4f} "
                       f"-> {work_dir}/best_{key}")
            timer.reset()  # nor an evaluation
    return state


def _save(ckpt_dir: str, step: int, state: TrainState, max_keep: int,
          log_fn) -> None:
    """Rank 0 writes the checkpoint; every rank leaves when it is on
    disk."""
    if world()[0] == 0:
        t0 = time.perf_counter()
        path = save_checkpoint(ckpt_dir, step, state, max_keep)
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        log_fn(f"checkpoint of step {step}: {size} bytes in "
               f"{time.perf_counter() - t0:.2f} s -> {path}")
    barrier()


def silent(*args) -> None:
    """The `log_fn` of the ranks other than 0."""


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
    model runs on the device of its parameters, in eval mode. Under a
    process group rank r scores images r, r + W, ... and the confusion
    matrix is summed over the ranks, so every rank returns the metrics of
    the whole set. Returns aAcc, mIoU, mAcc and `confusion`, the (K, K)
    int64 counts[gt, pred].
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
    rank, size, _ = world()
    mine = range(rank, n, size)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for done, i in enumerate(mine, 1):
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
                    # resized once a ratio; the flip comes after both
                    # resizes, so the flipped image is the resized one's
                    base = SP.prepare_variant_image(img, h1w1, h2w2, False)
                    for fl in flips:
                        x = SP.flipped(base) if fl else base
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
                if done % 50 == 0 or done == len(mine):
                    log_fn(f"eval {done}/{len(mine)}")
            if size > 1:
                dist.all_reduce(cm)
    finally:
        model.train(was_training)
    cm = cm.cpu().numpy()
    metrics: Dict[str, Any] = miou_from_confusion(cm)
    log_fn(f"aAcc {metrics['aAcc']*100:.2f} | mIoU {metrics['mIoU']*100:.2f} "
           f"| mAcc {metrics['mAcc']*100:.2f}")
    metrics["confusion"] = cm
    return metrics
