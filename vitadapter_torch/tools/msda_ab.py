#!/usr/bin/env python3
"""Card time of one checkout's fused MSDA kernels (`msda_fwd`, `msda_bwd`)
on `chip_smoke.py`'s clock, so that two commits can be compared on one
card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/msda_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.msda` has `_kernel_forward` and `_kernel_backward`
(this one, or an older commit unpacked with `git archive`); its kernels
build there. The clock (`chip_smoke.time_ms`) and the inputs (`chip_smoke.
msda_inputs`' uniform locations and `msda_model_locations`' model-shaped
ones, from one seed) are this file's own checkout's, so both commits are
timed alike. A third set puts every point at the map's centre, so that
every corner after the first is an L1 hit: what is left is the kernels'
work per (query, head) without the gathers' traffic. It times one call of
each kernel at the flagship's geometries (`chip_smoke.MSDA_GEOMETRIES`,
batch 2) in bf16 and fp32 and sums them per forward (msda_fwd) and per
train step (msda_bwd) with the geometries' calls, as the kernels' table
rows do; and in fp32 at `chip_smoke.MSDA_PATH_CASES` (batch 1), summed per
path (the backward where the path takes one). Prints the card's name and
power limit, then one JSON line.
"""

import json
import sys

import torch

ITERS = 10
PATH_ITERS = 5


def main(argv=None):
    # the sibling tool: this directory is on sys.path when this file runs
    from attention_ab import load_checkout

    args = sys.argv[1:] if argv is None else argv
    smoke, msda = load_checkout(args, "ops.msda", __doc__)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    cases = []
    for dtype in ("bfloat16", "float32"):
        for name, (shapes, Lq, M, calls) in smoke.MSDA_GEOMETRIES.items():
            cases.append((f"{name} {dtype}", shapes, Lq, M,
                          smoke.MSDA_QUERY_GRID[name], dtype, 2,
                          ("forward", "step"), calls, True, ITERS))
    for name, (shapes, Lq, M, grid, path, calls, backward) in \
            smoke.MSDA_PATH_CASES.items():
        cases.append((name, shapes, Lq, M, grid, "float32", 1, (path, path),
                      calls, backward, PATH_ITERS))
    per_call, sums = {}, {}
    for (name, shapes, Lq, M, grid, dtype, B, per, calls, backward,
         iters) in cases:
        value, loc, attn, g = smoke.msda_inputs(
            shapes, Lq, M, getattr(torch, dtype), gen, B=B)
        loc_m = smoke.msda_model_locations(shapes, grid, M, 4, gen, B=B)
        for kind, lc in (("uniform", loc), ("model_shaped", loc_m),
                         ("one_cell", torch.full_like(loc, 0.5))):
            with torch.no_grad():
                ms = {"msda_fwd": smoke.time_ms(
                    lambda: msda._kernel_forward(value, shapes, lc, attn),
                    flush, iters)}
                if backward:
                    ms["msda_bwd"] = smoke.time_ms(
                        lambda: msda._kernel_backward(value, shapes, lc,
                                                      attn, g), flush, iters)
            per_call[f"{name} {kind}"] = ms
            for (kernel, t), unit in zip(ms.items(), per):
                key = f"{kernel} per {unit} ({dtype}, {kind})"
                sums[key] = sums.get(key, 0.0) + calls * t
        del value, loc, loc_m, attn, g
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": args[0], "sums_ms": sums,
                      "per_call_ms": per_call}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
