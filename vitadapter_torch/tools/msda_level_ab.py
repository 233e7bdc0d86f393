#!/usr/bin/env python3
"""Card time of one checkout's per-level MSDA kernels (`msda_level_fwd`,
`msda_level_dgrid`, `msda_level_dv`) on `chip_smoke.py`'s clock, so that
two commits can be compared on one card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/msda_level_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.msda` has `level_forward`, `level_grad_grid` and
`level_grad_value` (this one, or an older commit unpacked with `git
archive`); its kernels build there. The clock (`chip_smoke.time_ms`) and
the inputs (`chip_smoke.msda_inputs`' uniform locations and
`msda_model_locations`' model-shaped ones, from one seed) are this file's
own checkout's, so both commits are timed alike. A third set puts every
point at the map's centre, so that every corner after the first is an L1
hit: what is left is the kernels' work per (query, head) without the
gathers' traffic (and, for the d value, every atomic on four rows a
head). At the shapes of the
per-level calls of whole-image evaluation (ratio 1.5 of a 1024x2048 image)
and of the over-line train step (`chip_smoke.LEVEL_GEOMETRIES` with a
path), it times each level's launch of the forward and d grid kernels,
and on the over-line step's shapes of the d value kernel too (into an
fp32 buffer, as `MSDeformAttnLevelFunction` launches it), and sums them
per forward or step as the kernels' table rows do (6 pixel-decoder and 4
injector calls of 3 levels each); beside them, one PyTorch add over the
fp32 accumulator (`acc_add_ms`: the forward's read and write of it at a
memory-bound rate). Prints the card's name and power limit, then one JSON
line.
"""

import json
import sys

import torch

ITERS = 10


def main(argv=None):
    # the sibling tool: this directory is on sys.path when this file runs
    from attention_ab import load_checkout

    args = sys.argv[1:] if argv is None else argv
    smoke, msda = load_checkout(args, "ops.msda", __doc__)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    levels, sums = {}, {}
    for name, (shapes, Lq, M, _, on_path) in smoke.LEVEL_GEOMETRIES.items():
        if on_path is None:
            continue
        path, calls = on_path
        value, loc, attn, g = smoke.msda_inputs(shapes, Lq, M, torch.float32,
                                                gen, B=1)
        loc_m = smoke.msda_model_locations(
            shapes, smoke.LEVEL_QUERY_GRID[name], M, 4, gen)
        out = torch.zeros((1, Lq, M, value.shape[-1]), device="cuda")
        dloc, dattn = torch.empty_like(loc), torch.empty_like(attn)
        dvalue = (torch.zeros(value.shape, device="cuda")
                  if path == "train_overline" else None)
        levels[f"{name} acc_add_ms"] = smoke.time_ms(lambda: out.add_(1.0),
                                                     flush, ITERS)
        for kind, lc in (("uniform", loc), ("model_shaped", loc_m),
                         ("one_cell", torch.full_like(loc, 0.5))):
            for lvl in range(len(shapes)):
                with torch.no_grad():
                    ms = {
                        "msda_level_fwd": smoke.time_ms(
                            lambda: msda.level_forward(
                                value, shapes, lvl, lc, attn, out),
                            flush, ITERS),
                        "msda_level_dgrid": smoke.time_ms(
                            lambda: msda.level_grad_grid(
                                value, shapes, lvl, lc, attn, g, dloc,
                                dattn), flush, ITERS)}
                    if dvalue is not None:
                        ms["msda_level_dv"] = smoke.time_ms(
                            lambda: msda.level_grad_value(
                                value, shapes, lvl, lc, attn, g, dvalue),
                            flush, ITERS)
                levels[f"{name} {kind} level {lvl}"] = ms
                for kernel, t in ms.items():
                    key = f"{kernel} per {path} ({kind})"
                    sums[key] = sums.get(key, 0.0) + calls * t
        del value, loc, loc_m, attn, g, out, dloc, dattn, dvalue
        torch.cuda.empty_cache()
    print(json.dumps({"checkout": args[0], "sums_ms": sums,
                      "levels_ms": levels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
