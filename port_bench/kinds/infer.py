"""Inference (`"kind": "infer"` mixes) on one card: the model from
`builder.build_model`, one closed-loop client sending requests of a seeded
pool of images, each cut into its slide crops on the host, uploaded,
normalized and scored (`model(normalize(x))`, as
`train.loop._score_crops`) and synchronized. The logits of the first
serving of each seed-drawn checked image go to the host, after its
latency is read, so that the card's peak holds none of them. The window
closes once `--seconds` have passed and every checked image has been
served."""

from __future__ import annotations

import gc
import random
import time
from typing import Callable, Dict, List

import torch

from port_bench import check, spec
from port_bench import traffic_gen as tg
from port_bench.harness import (Context, EventHooks, make_weights,
                                process_age_s, summary, sync, traced_span)


def slide_starts(size: int, crop: int, stride: int) -> List[int]:
    """The reference's slide grid along one side."""
    n = max(-(-(size - crop) // stride), 0) + 1
    return [min(i * stride, size - crop) for i in range(n)]


def infer_pool(cell: spec.Cell, seed: int, device):
    """The seeded pool of request images, uint8 (n, H, W, 3) on the host."""
    t = cell.traffic
    g = torch.Generator(device).manual_seed(tg.sub_seed(seed, 1))
    n = t["pool_images"]
    counts = tg.class_counts(n, *t["classes_per_image"], g)
    imgs, _ = tg.scenes(n, tuple(t["image"]), counts,
                        cell.config["model"]["decode_head"]["num_classes"],
                        0.0, g)
    return imgs.round().to(torch.uint8).cpu().numpy()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device, log=print, wrap_model: Callable = None,
        lower_control: bool = False) -> Dict:
    import numpy as np

    from vitadapter_torch.builder import build_model
    from vitadapter_torch.data.preprocess import normalize

    cfg = cell.config
    t = cell.traffic
    t_build = time.perf_counter()
    model = build_model(dict(cfg["model"]), device=device)
    sync(device)
    build_s = time.perf_counter() - t_build
    model.load_state_dict(make_weights(cfg, seed, device), strict=True)
    model.eval()
    call = model if wrap_model is None else wrap_model(model)
    pool = infer_pool(cell, seed, device)
    H, Wd = t["image"]
    ch, cw = cfg["test_cfg"]["crop_size"]
    sh, sw = cfg["test_cfg"]["stride"]
    ys, xs = slide_starts(H, ch, sh), slide_starts(Wd, cw, sw)
    n_crops = len(ys) * len(xs)
    rng = random.Random(tg.sub_seed(seed, 3))
    sample = sorted(rng.sample(range(len(pool)), t["checked_images"]))
    kept: Dict[int, torch.Tensor] = {}

    def request(i: int):
        img = pool[i % len(pool)]
        crops = np.stack([img[y:y + ch, x:x + cw] for y in ys for x in xs])
        x = torch.from_numpy(crops).to(device)
        out = call(normalize(x)).float()
        sync(device)
        return out

    with torch.inference_mode():
        for i in range(t["warmup_requests"]):
            request(i)
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = process_age_s()
        hooks = EventHooks() if trace else None
        if trace:
            hooks.module("backbone", model.backbone)
            hooks.module("head", model.decode_head)
        lat: List[float] = []
        span = None
        t0 = time.perf_counter()
        i = 0
        while True:
            if trace and i == 1:
                span = traced_span(lambda k: request(i + k),
                                   t["traced_requests"], device)
                i += span.units
            else:
                s = time.perf_counter()
                out = request(i)
                lat.append(time.perf_counter() - s)
                j = i % len(pool)
                if j in sample and j not in kept:
                    kept[j] = out.cpu()
                del out
                i += 1
            if (time.perf_counter() - t0 >= seconds
                    and len(kept) == len(sample)):
                break
        window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    log(f"window: {i} requests in {window:.3f} s; set-up {setup_s:.2f} s")
    ctx = Context.of_window("infer", cell, n_crops, i, window, span,
                            build_s=build_s, setup_s=setup_s, peak=peak,
                            latencies=lat,
                            hooks=hooks.ms() if trace else {},
                            trace=summary(span), log=log)
    result = {"attempted": i, "failed": 0, "ctx": ctx}
    del model, call, hooks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    crops = [torch.from_numpy(np.stack(
        [pool[j][y:y + ch, x:x + cw] for y in ys for x in xs]))
        for j in sample]
    t_ref = time.perf_counter()
    ref_state = make_weights(cfg, seed, device)
    prog = [kept[j] for j in sample]
    if lower_control:
        prog = check.infer_readings(cfg, ref_state, crops, device,
                                    lower=True)
    ref = check.infer_readings(cfg, ref_state, crops, device)
    log(f"reference: {time.perf_counter() - t_ref:.2f} s")
    result["numbers"] = check.compare_infer(prog, ref)
    return result
