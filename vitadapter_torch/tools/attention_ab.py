#!/usr/bin/env python3
"""Card time of one checkout's attention beside SDPA, on `chip_smoke.py`'s
clock, so that two commits can be compared on one card.

Run on a machine with one NVIDIA H100, once per checkout, one after
another on the same card (order A, B, B, A):

    python3 vitadapter_torch/tools/attention_ab.py CHECKOUT

CHECKOUT is the root of a checkout of this repository whose
`vitadapter_torch.ops.attention` has `fused_attention` (this one, or an
older commit unpacked with `git archive`); its kernels build there. The
clock (`chip_smoke.time_ms`: CUDA events, L2 flushed and the launches
queued before each call) is this file's own checkout's, so both commits are
timed alike.
It times, per call, the forward without a gradient (`fused_attention`)
and the backward through autograd (`torch.autograd.grad` of
`fused_attention`'s output), and `scaled_dot_product_attention` both ways:
at the flagship's shape (2, 16, 1024, 64) in bf16 and in fp32, and in fp32
at `chip_smoke.ATTN_PATH_CASES`' lengths (B 1, 16 heads, D 64; the
backward only where that path takes one). Prints the card's name and power
limit, then one JSON line.
"""

import importlib.util
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPE = (2, 16, 1024, 64)
ITERS = 20
PATH_ITERS = 5  # the path lengths' calls take 2-90 ms


def load_checkout(args, module, doc):
    """(this checkout's `chip_smoke` module, the checkout's
    `vitadapter_torch.<module>`) for a tool called with one argument, the
    checkout's root; prints the card's name and power limit. Exits when
    there is no card or the module comes from elsewhere."""
    if len(args) != 1:
        raise SystemExit(doc)
    root = os.path.abspath(args[0])
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_clock", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, root)
    mod = importlib.import_module(f"vitadapter_torch.{module}")
    if not mod.__file__.startswith(root + os.sep):
        raise SystemExit(f"FAIL: imported {mod.__file__}, not from {root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0])
    return smoke, mod


def time_case(smoke, at, shape, dtype, backward, iters):
    """ms per call of the checkout's attention and of SDPA at one shape."""
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                  .to(dtype) for _ in range(4))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    with torch.no_grad():
        ms = {"fwd_ms": smoke.time_ms(lambda: at.fused_attention(q, k, v),
                                      flush, iters),
              "sdpa_ms": smoke.time_ms(
                  lambda: F.scaled_dot_product_attention(q, k, v), flush,
                  iters)}
    if backward:
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = at.fused_attention(*ins)
        lib_out = F.scaled_dot_product_attention(*lib)
        ms["bwd_ms"] = smoke.time_ms(lambda: torch.autograd.grad(
            out, ins, g, retain_graph=True), flush, iters)
        ms["sdpa_bwd_ms"] = smoke.time_ms(lambda: torch.autograd.grad(
            lib_out, lib, g, retain_graph=True), flush, iters)
        ms["bwd_ratio"] = ms["bwd_ms"] / ms["sdpa_bwd_ms"]
    ms["fwd_ratio"] = ms["fwd_ms"] / ms["sdpa_ms"]
    return ms


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    smoke, at = load_checkout(args, "ops.attention", __doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {"flagship_bf16": (SHAPE, torch.bfloat16, True, ITERS),
             "flagship_fp32": (SHAPE, torch.float32, True, ITERS)}
    for name, (n, _path, _calls, backward) in smoke.ATTN_PATH_CASES.items():
        cases[name] = ((1, 16, n, 64), torch.float32, backward, PATH_ITERS)
    result = {"checkout": os.path.abspath(args[0])}
    for name, (shape, dtype, backward, iters) in cases.items():
        result[name] = {"shape": shape, "dtype": str(dtype),
                        **time_case(smoke, at, shape, dtype, backward, iters)}
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
