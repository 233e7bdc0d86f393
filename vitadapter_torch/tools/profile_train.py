#!/usr/bin/env python3
"""Where the time of one flagship train step of the PyTorch/CUDA port goes.

Run from the repository root on a machine with one NVIDIA H100:

    python3 -m vitadapter_torch.tools.profile_train [--steps 3]

Builds the flagship ViT-Adapter-L + Mask2Former in bf16 (fp32 parameters)
from seed 0 and the train step of `chip_smoke.py` phase 6 (batch 2 at
512x512, DropPath 0.4, 12544 points, auction assignment, AdamW with layer
decay), warms it up for two steps, then:

  1. times the step's parts on the host clock with a synchronize at each
     boundary (forward, loss, backward, optimizer), over `--steps` steps;
  2. traces `--steps` whole steps with `torch.profiler` and prints the
     device's busy share of the wall time (the union of its kernels'
     intervals) and the kernels with the most device time.

Prints the card's name and power limit first. Needs one card.
"""

import argparse
import subprocess
import sys
import time

import torch


def busy_union_us(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from vitadapter_torch import zoo
    from vitadapter_torch.heads.mask2former_loss import mask2former_loss
    from vitadapter_torch.ops.point_sample import uniform_sampler
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    model = zoo.mask2former_vit_adapter(
        "large", dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(0))
    opt, _ = make_optimizer(model, depth=24, total_steps=1000,
                            warmup_steps=10, grad_clip=0.01)
    state = TrainState.create(model, opt)
    step = make_m2f_train_step(model, num_classes=150, max_instances=60,
                               num_points=12544)
    gen = torch.Generator("cuda").manual_seed(3)
    img = torch.randn(2, 512, 512, 3, generator=gen,
                      device="cuda").to(torch.bfloat16)
    label = torch.randint(0, 150, (2, 512, 512), generator=gen, device="cuda")
    batch = {"image": img, "label": label}
    for _ in range(2):
        state, logs = step(state, batch, gen)
    torch.cuda.synchronize()

    # 1. the parts of a step, host clock, a synchronize at each boundary
    parts = {"forward": 0.0, "loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    sampler = uniform_sampler(gen)
    for _ in range(args.steps):
        t0 = time.perf_counter()
        model.train()
        cls_list, mask_list = model(img, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, _ = mask2former_loss(sampler, cls_list, mask_list, label,
                                   num_classes=150, max_instances=60,
                                   num_points=12544)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.zero_grad()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            parts[k] += dt / args.steps
    total = sum(parts.values())
    print(f"parts of a train step (s, host clock, synchronized at each "
          f"boundary, mean of {args.steps}): "
          + ", ".join(f"{k} {v:.4f} ({100 * v / total:.1f}%)"
                      for k, v in parts.items()) + f"; sum {total:.4f}")

    # 2. whole steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, logs = step(state, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side work only: kernels, copies and sets, not the ranges that
    # annotate them (the optimizer's step shows as one such range)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_union_us([(e.time_range.start, e.time_range.end)
                          for e in kernels]) / 1e6
    print(f"profiled {args.steps} steps: wall {wall:.4f} s "
          f"({wall / args.steps:.4f} s/step), device busy {busy:.4f} s, "
          f"busy share {busy / wall:.3f}, idle share {1 - busy / wall:.3f}, "
          f"{len(kernels)} device events ({len(kernels) / args.steps:.0f} "
          f"per step), loss {float(logs['loss']):.4f}")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
    print("device time by kernel (ms per step, calls per step):")
    for name, (n, t) in top:
        print(f"  {t / 1e3 / args.steps:9.3f}  {n / args.steps:7.1f}  "
              f"{name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
