"""Training (`"kind": "train"` mixes) on one card: the model, its optimizer
and schedule from `train.loop.build_train_state`, the weights replaced by
the seed's (`weights.py`), a pool of seeded batches made on the device, and
the step `run_training` would choose (`make_m2f_train_step` or
`make_seg_train_step`). Set-up drives that step through its first three
steps on three distinct batches, which the reference follows; the window
loops the same step over the rest of the pool until `--seconds` have
passed, then synchronizes."""

from __future__ import annotations

import contextlib
import gc
import os
import time
from typing import Callable, Dict

import torch

from port_bench import check, spec
from port_bench import traffic_gen as tg
from port_bench.harness import (CHECK_STEPS, Context, EventHooks, Phases,
                                make_weights, process_age_s, summary,
                                sync, traced_span)


def train_pool(cell: spec.Cell, seed: int, device):
    """The seeded pool of batches: (raw images (n, H, W, 3) fp32 0-255,
    labels (n, H, W) int64), n = batches x images a batch."""
    t = cell.traffic
    cfg = cell.config
    n = t["pool_batches"] * t["batch_per_rank"]
    hw = tuple(cfg["data"]["crop_size"])
    g = torch.Generator(device).manual_seed(tg.sub_seed(seed, 1))
    counts = tg.class_counts(n, *t["classes_per_image"], g)
    return tg.scenes(n, hw, counts,
                     cfg["model"]["decode_head"]["num_classes"],
                     t["ignore_share"], g)


def build_program_train(cfg: Dict, device, log):
    from vitadapter_torch.train.loop import build_train_state
    from vitadapter_torch.utils.config import Config

    c = Config(cfg)
    t0 = time.perf_counter()
    model, state, _, _ = build_train_state(
        c, device, cfg["runner"]["max_iters"],
        cfg["lr_config"].get("warmup_iters", 1500),
        cfg["lr_config"].get("policy", "poly"),
        work_dir=os.devnull, resume=False, log_fn=log)
    sync(device)
    return model, state, time.perf_counter() - t0


@contextlib.contextmanager
def program_choices(cfg: Dict):
    """Inside, the program's Mask2Former loss keeps its discrete choices
    and what it chose them from: each step's matches (the auction's
    output, (L * B, Q)) with the costs and valid gt counts the auction was
    given, and each layer's uncertain points (B * Q, P, 2), on the host.
    The reference follows the matches and points and judges them
    (`check.train_readings`): at random weights the queries' costs lie
    within rounding of each other, so matches and points chosen from the
    program's bf16 logits and from the reference's fp32 ones differ by far
    more than the arithmetic does. The auction itself is judged on the
    costs it was given (`check.auction_gap`)."""
    kept = {"assign": [], "points": [], "cost": [], "n_valid": []}
    spent = [0.0]
    if cfg["model"]["type"] != "EncoderDecoderMask2Former":
        yield {}, spent
        return
    from vitadapter_torch.heads import mask2former_loss as loss

    real = (loss.hungarian_assign, loss.get_uncertain_point_coords)

    def assign(cost, n_valid, *a, **k):
        out = real[0](cost, n_valid, *a, **k)
        t = time.perf_counter()
        kept["assign"].append(out.cpu())
        kept["cost"].append(cost.detach().float().cpu())
        kept["n_valid"].append(n_valid.detach().cpu())
        kept["points"].append([])
        spent[0] += time.perf_counter() - t
        return out

    def points(*a, **k):
        out = real[1](*a, **k)
        t = time.perf_counter()
        kept["points"][-1].append(out.cpu())
        spent[0] += time.perf_counter() - t
        return out

    loss.hungarian_assign, loss.get_uncertain_point_coords = assign, points
    try:
        yield kept, spent
    finally:
        loss.hungarian_assign, loss.get_uncertain_point_coords = real


def program_train_step(cfg: Dict, model):
    from vitadapter_torch.train.trainer import (make_m2f_train_step,
                                                make_seg_train_step)
    if cfg["model"]["type"] == "EncoderDecoderMask2Former":
        tc = cfg.get("train_cfg", {})
        return make_m2f_train_step(
            model, num_classes=cfg["model"]["decode_head"]["num_classes"],
            max_instances=tc.get("max_instances", 60),
            num_points=tc.get("num_points", 12544))
    return make_seg_train_step(model, cfg.get("aux_loss_weight", 0.4))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device, log=print, wrap_step: Callable = None,
        lower_control: bool = False) -> Dict:
    """One training run on `device`; `wrap_step` (a test's) wraps the
    program's step; `lower_control` puts the reference one precision
    step lower in the program's place for the checked steps."""
    from vitadapter_torch.data.preprocess import normalize

    cfg = cell.config
    t = cell.traffic
    B = t["batch_per_rank"]
    clock = Phases(log, device)
    model, state, build_s = build_program_train(cfg, device, log)
    clock("build_train_state")
    init = make_weights(cfg, seed, device)
    model.load_state_dict(init, strict=True)
    del init
    clock("weights")
    raw, labels = train_pool(cell, seed, device)
    clock("batches")
    n_batches = raw.shape[0] // B
    pool = [{"image": normalize(raw[i * B:(i + 1) * B]),
             "label": labels[i * B:(i + 1) * B]} for i in range(n_batches)]
    step_fn = program_train_step(cfg, model)
    if wrap_step is not None:
        step_fn = wrap_step(step_fn)
    gen_seed = tg.sub_seed(seed, 2)
    gen = torch.Generator(device).manual_seed(gen_seed)
    names = {id(p): n for n, p in model.named_parameters()}
    beta1 = cfg["optimizer"]["betas"][0]

    # set-up: the checked steps, which also warm up every shape; the time
    # the check's own readings take is not set-up's
    losses, grads, check_s, head = [], None, 0.0, []
    with program_choices(cfg) as (choices, spent):
        for k in range(CHECK_STEPS):
            with check.head_logits(model, head, spent) if k == 0 \
                    else contextlib.nullcontext():
                state, logs = step_fn(state, pool[k], gen)
            losses.append(float(logs["loss"]))
            clock(f"checked step {k + 1}")
            if k == 0:
                g = check.first_moments(state.optimizer.adamw, names, beta1)
                grads = {n: t.to("cpu", copy=True) for n, t in g.items()}
                del g
                check_s += clock("first gradient read")
    check_s += spent[0]
    prog = {"losses": losses, "grads": check.norms(grads),
            "grad_full": grads, "after": check.host_copy(model),
            "choices": choices, "logits": head[0] if head else None}
    check_s += clock("parameters after the checked steps copied")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = process_age_s() - check_s

    hooks = EventHooks() if trace else None
    if trace:
        hooks.module("backbone", model.backbone)
        hooks.module("head", model.decode_head)
        state.optimizer.step = hooks.wrap("optimizer", state.optimizer.step)
    steps, span = 0, None
    t0 = time.perf_counter()
    while True:
        if trace and steps == 1:
            span = traced_span(
                lambda i: step_fn(state, pool[(CHECK_STEPS + steps + i)
                                              % n_batches], gen),
                t["traced_steps"], device)
            steps += span.units
        else:
            b = pool[(CHECK_STEPS + steps) % n_batches]
            state, _ = step_fn(state, b, gen)
            steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    log(f"window: {steps} steps in {window:.3f} s; set-up {setup_s:.2f} s")
    ctx = Context.of_window("train", cell, B, steps, window, span,
                            build_s=build_s, setup_s=setup_s, peak=peak,
                            hooks=hooks.ms() if trace else {},
                            trace=summary(span), log=log)
    result = {"attempted": steps, "failed": 0, "ctx": ctx}

    del model, state, step_fn, pool, hooks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    clock.t = time.perf_counter()
    ref_state = make_weights(cfg, seed, device)
    checked = [{"image": raw[k * B:(k + 1) * B],
                "label": labels[k * B:(k + 1) * B]}
               for k in range(CHECK_STEPS)]
    if lower_control:
        prog = check.train_readings(cfg, ref_state, checked, gen_seed,
                                    device, lower=True)
        clock("control")
    ref = check.train_readings(cfg, ref_state, checked, gen_seed, device,
                               choices=prog["choices"])
    clock("reference")
    result["numbers"] = check.compare_train(prog, ref, ref_state, log)
    return result
