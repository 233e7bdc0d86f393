#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`vitadapter_torch`) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. builds every CUDA kernel of the port from `vitadapter_torch/ops/csrc`;
  3. holds each kernel against its plain PyTorch version on the card, fp32
     and bf16, at the flagship's shapes: the forward kernels, and the
     backward kernels reached through the autograd wrappers (so the
     gradients of MSDA and attention on the card are checked too); the
     auction (fp32 costs only) for equal matches and for a total cost within
     its bound of scipy's optimum. It times each kernel beside its bound,
     its plain version and, where one PyTorch call computes the same
     function, that call (`scaled_dot_product_attention` and its backward,
     `F.grid_sample` and its backward);
  4. serves a few batch-2 requests of raw uint8 512x512 images with the
     flagship ViT-Adapter-L + Mask2Former (ADE20K, 150 classes) in bf16 from
     random seeded weights, and checks the launch counts of the kernels;
  5. runs a reduced-depth, full-width model in fp32 on the card (kernels)
     and on the CPU (plain versions) and compares the logits;
  6. trains the flagship for a few steps (batch 2, 512x512, fp32 parameters
     and bf16 compute, DropPath 0.4, the Mask2Former loss at 12544 points
     with the auction assignment, AdamW with layer decay) and checks the
     launch counts per step;
  7. takes one train step of a reduced-depth, full-width model in fp32 on
     the card and on the CPU and compares the loss and the gradient norm;
  8. evaluates the flagship in fp32 on one 1024x2048 image through
     `train.loop.run_eval` (whole mode, img_scale (2048, 1024), ratios 1.0
     and 1.5 with flip): at ratio 1.5 the injectors' and the pixel
     decoder's values pass the 8 MiB line and take the per-level MSDA
     kernels; checks the launch counts, finite logits and the confusion
     matrix;
  9. takes one fp32 train step of the reduced-depth, full-width model at
     1792x1792, where those values pass the line too, and checks the
     launch counts of all ten kernels;
 10. evaluates the reduced model in fp32 through `run_eval` on two odd-sized
     non-square images (whole mode, ratios 0.75 and 1.0 with flip) on the
     card and on the CPU and compares the confusion matrices.
Phase 3 also holds the per-level MSDA kernels against their plain versions,
and the per-level route against the fused kernels, at the shapes of every
MSDA call that takes that route in phases 8 and 9 (and at a few thousand
queries in fp32 and bf16). The last two lines are a JSON object of the
kernels' numbers and {"ok": true, "device": {...}}.
"""

import copy
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores, dense
              torch.float32: 67e12}     # CUDA cores

# tolerances of kernel vs plain version on the same inputs (both sum in
# fp32 in another order): fp32 differs by float rounding; bf16 outputs are
# both rounded from fp32 sums, so they differ by at most ~1 bf16 ulp (2^-8
# relative), allowed twice over.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# gradients (backward kernels with fp32 atomics, or another summation
# order): each element within 1e-5 of the reference's max |value| plus the
# relative rounding of its dtype (1e-5 for fp32, 2^-7 for bf16)
GRAD_TOL = 1e-5
# reduced-depth model, card (kernels, cuDNN convs) vs CPU, fp32, TF32 off:
# float reassociation across ~60 layers, relative to the logits' scale
E2E_RTOL = 1e-3
# reduced-depth train step, card vs CPU, fp32, TF32 off: besides the
# reassociation, the loss samples bf16-rounded mask logits, where a 1e-6
# difference can flip one rounding and move an uncertainty-selected point
# (1.8e-5 seen on the H100)
TRAIN_RTOL = 1e-3

MSDA_GEOMETRIES = {
    # name: (spatial shapes of the value, Lq, heads, calls per forward)
    "injector": (((64, 64), (32, 32), (16, 16)), 1024, 16, 4),
    "extractor": (((32, 32),), 5376, 16, 6),
    "pixel_decoder": (((16, 16), (32, 32), (64, 64)), 5376, 32, 6),
}
ATTN_SHAPE = (2, 16, 1024, 64)   # 24 calls per forward
ATTN_CALLS = 24
# point sampling in one flagship train step (batch 2, 200 queries, 60 gt
# classes, 10 decoder outputs, 12544 points):
# name: (masks N, H, W, points per mask, points sorted by y, calls)
POINT_GEOMETRIES = {
    "assign_pred": (4000, 128, 128, 12544, True, 1),
    "assign_gt": (120, 512, 512, 125440, True, 1),
    "uncertainty": (400, 128, 128, 37632, False, 10),
    "loss_pred": (400, 128, 128, 12544, True, 10),
    "loss_gt": (400, 512, 512, 12544, True, 10),
}
POINT_BWD = "loss_pred"          # the one sampling call with a gradient
# the assignment of one flagship train step: 10 decoder outputs x batch 2
# cost matrices of 200 queries x 60 gts, solved in one launch
AUCTION_SHAPE = (20, 200, 60)
SERVE_REQUESTS = 4   # batch-2 requests of the main path (phase 4)
TRAIN_STEPS = 6      # flagship train steps (phase 6)
TRAIN_LAUNCHES = {   # kernel launches per train step
    "msda_fwd": 16, "msda_bwd": 16, "attention_fwd": 24, "attention_bwd": 24,
    "point_sample_fwd": 32, "point_sample_bwd": 10, "auction": 1}
# the per-level MSDA route (phase 3), batch 1, head dim 32.
# name: (spatial shapes of the value, Lq, heads, dtypes, None or (the main
# path, MSDA calls of these shapes per forward or step there))
# - the calls of the main paths, in fp32 as both paths run: the flagship's
#   forward at ratio 1.5 of a 1024x2048 image (1536x3072; phase 8) and the
#   reduced model's step at 1792x1792 (phase 9). The pixel decoder queries
#   all its value rows, levels coarse first; the injectors query the 1/16
#   token grid, levels fine first. These give the kernels' table rows:
#   msda_level_fwd per eval forward, msda_level_dv/_dgrid per train step;
# - off the paths: a few thousand queries at the ratio-1.5 pixel-decoder
#   levels, fp32 and bf16, and a case whose first level has H * W <= 1024
#   (`_sample_kernel_onehot_pf`'s levels)
F32, BF16 = torch.float32, torch.bfloat16
R15 = ((48, 96), (96, 192), (192, 384))
OVER = ((56, 56), (112, 112), (224, 224))
LEVEL_GEOMETRIES = {
    "eval_pixel_decoder": (R15, 96768, 32, (F32,), ("eval_whole", 6)),
    "eval_injector": (R15[::-1], 18432, 16, (F32,), ("eval_whole", 4)),
    "overline_pixel_decoder": (OVER, 65856, 32, (F32,),
                               ("train_overline", 6)),
    "overline_injector": (OVER[::-1], 12544, 16, (F32,),
                          ("train_overline", 4)),
    "pixel_decoder_r1.5": (R15, 4096, 32, (F32, BF16), None),
    "small_level": (((32, 32), (96, 192), (192, 384)), 4096, 32, (F32, BF16),
                    None),
}
# the table row of each per-level kernel comes from its main path's calls
LEVEL_ROW_PATH = {"msda_level_fwd": "eval_whole",
                  "msda_level_dv": "train_overline",
                  "msda_level_dgrid": "train_overline"}
# phase 8: the flagship in fp32, whole mode, on one Cityscapes-sized image
EVAL_HW = (1024, 2048)
EVAL_CFG = {"num_classes": 150,
            "test_cfg": {"mode": "whole", "img_scale": (2048, 1024)},
            "aug_test": {"img_ratios": [1.0, 1.5], "flip": True}}
# 4 forwards: 16 fused MSDA calls at ratio 1.0, 6 (the extractors) at 1.5,
# where the 4 injectors and 6 pixel-decoder layers take 3 level launches
EVAL_LAUNCHES = {"msda_fwd": 2 * 16 + 2 * 6, "msda_level_fwd": 2 * 30,
                 "attention_fwd": 4 * 24}
# phase 9: S = 50176 + 12544 + 3136 rows x 32 x 4 bytes = 8.04 MiB per head
OVERLINE_HW = 1792
OVERLINE_QUERIES = 200
OVERLINE_LAUNCHES = {
    "msda_fwd": 6, "msda_bwd": 6, "msda_level_fwd": 30, "msda_level_dv": 30,
    "msda_level_dgrid": 30, "attention_fwd": 4, "attention_bwd": 4,
    "point_sample_fwd": 32, "point_sample_bwd": 10, "auction": 1}
# phase 10: card vs CPU confusion matrices, at most this share of the
# labelled pixels predicted differently (argmax flips where two classes'
# probabilities tie within float reassociation)
EVAL_CM_SHARE = 1e-3
REPLACES = {
    "msda_fwd": "vitadapter/ops/msda_pallas.py:316",
    "msda_bwd": "vitadapter/ops/msda_pallas.py:1179",
    "msda_level_fwd": "vitadapter/ops/msda_pallas.py:121",
    "msda_level_dv": "vitadapter/ops/msda_pallas.py:905",
    "msda_level_dgrid": "vitadapter/ops/msda_pallas.py:1034",
    "attention_fwd": "vitadapter/ops/attention_pallas.py:57",
    "attention_bwd": "vitadapter/ops/attention_pallas.py:72",
    "point_sample_fwd": "vitadapter/ops/point_sample_pallas.py:46",
    "point_sample_bwd": "vitadapter/ops/point_sample_pallas.py:101",
    "auction": "vitadapter/ops/auction_pallas.py:33",
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, flush, iters=10):
    """Mean ms of fn on the card, CUDA events around each call, L2 flushed
    before each (the main path finds its inputs mostly cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    err = (got.detach().float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max())


def close_grad(got, ref):
    """A gradient against the plain one (see GRAD_TOL); not None."""
    if got is None:
        return False, float("inf")
    rtol = GRAD_TOL if got.dtype == torch.float32 else 2.0 ** -7
    r = ref.float()
    err = (got.float() - r).abs()
    ok = bool((err <= GRAD_TOL * float(r.abs().max()) + rtol * r.abs()).all())
    return ok and got.dtype == ref.dtype, float(err.max())


def bound_ms(nbytes, flops, dtype):
    """Least time for the work: bytes over HBM rate, or operations over the
    peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def corners_in_map(x01, y01, H, W):
    """Bilinear corners inside an (H, W) map of points (x, y) in [0, 1]."""
    x0 = torch.floor(x01 * W - 0.5)
    y0 = torch.floor(y01 * H - 0.5)
    n = 0
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            n += int(((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)).sum())
    return n


def touched_rows(loc_l, H, W):
    """Distinct (batch, head, cell) rows of one (H, W) level that the
    in-map bilinear corners of the points loc_l (B, Lq, M, P, 2) read: the
    value rows a sampling function must load at least once."""
    B, _, M = loc_l.shape[:3]
    dev = loc_l.device
    x0 = torch.floor(loc_l[..., 0] * W - 0.5).long()
    y0 = torch.floor(loc_l[..., 1] * H - 0.5).long()
    bm = (torch.arange(B, device=dev)[:, None, None, None] * M
          + torch.arange(M, device=dev)[None, None, :, None]) * (H * W)
    seen = torch.zeros(B * M * H * W, dtype=torch.bool, device=dev)
    for dx in (0, 1):
        for dy in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            seen[(bm + yi * W + xi)[inside]] = True
    return int(seen.sum())


def msda_touched_bytes(shapes, value, loc):
    """Bytes of the value rows that the points of all levels read."""
    row = value.shape[-1] * value.element_size()
    return row * sum(touched_rows(loc[:, :, :, lvl], H, W)
                     for lvl, (H, W) in enumerate(shapes))


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def new_row(library=True):
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                library_ms=0.0 if library else None, bound_by=set())


def add_to_row(row, calls, err, k_ms, p_ms, b, lib_ms=None):
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row["ms"] += calls * k_ms
    row["plain_ms"] += calls * p_ms
    row["bound_ms"] += calls * b[0]
    row["bound_by"].add(b[1])
    if lib_ms is not None:
        row["library_ms"] += calls * lib_ms


def msda_inputs(shapes, Lq, M, dtype, gen, B=2, D=32, P=4):
    dev = "cuda"
    L = len(shapes)
    S = sum(h * w for h, w in shapes)
    value = torch.randn(B, S, M, D, generator=gen, device=dev).to(dtype)
    loc = torch.rand(B, Lq, M, L, P, 2, generator=gen, device=dev) * 1.2 - 0.1
    # some integer-valued pixel coordinates (loc * size - 0.5 integer) ...
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32,
                        device=dev)[None, None, None, :, None, :]
    snap = torch.rand(B, Lq, M, L, P, 1, generator=gen, device=dev) < 0.1
    loc = torch.where(snap, (torch.floor(loc * size) + 0.5) / size, loc)
    # ... and some far off the map
    far = torch.rand(B, Lq, M, L, P, 1, generator=gen, device=dev) < 0.02
    loc = torch.where(far, loc * 7.0 - 3.0, loc)
    attn = torch.softmax(torch.randn(B, Lq, M, L * P, generator=gen,
                                     device=dev), -1).reshape(B, Lq, M, L, P)
    g = torch.randn(B, Lq, M * D, generator=gen, device=dev).to(dtype)
    return value, loc.contiguous(), attn.contiguous(), g


def msda_corners(shapes, loc):
    return sum(corners_in_map(loc[:, :, :, lvl, :, 0], loc[:, :, :, lvl, :, 1],
                              H, W) for lvl, (H, W) in enumerate(shapes))


def unported_msda_bounds(shapes, value, loc, attn):
    """(bound ms, bound by) of one call at these inputs for each MSDA
    kernel of the JAX package not ported yet (ROADMAP section 2, item 10):
    the band-matmul forward, which computes the whole forward and which the
    JAX dispatch takes only with VITADAPTER_MSDA_BANDMM=1."""
    D = value.shape[-1]
    g_bytes = loc.shape[0] * loc.shape[1] * loc.shape[2] * D \
        * value.element_size()
    return {"msda_pallas.py:514 _fwd_ml_bandmm_kernel": bound_ms(
        msda_touched_bytes(shapes, value, loc) + nbytes(loc, attn) + g_bytes,
        2 * D * msda_corners(shapes, loc), torch.float32)}


def auction_costs(gen, B, Q, G, contested, P=12544, K=150):
    """Cost matrices as the loss builds them (class, point BCE and dice
    costs with the loss's weights) for random logits against random binary
    gt masks at P points: (B, Q, G) fp32. `contested`: the gt masks are
    sparse (one pixel in K, as uniform labels over K classes make them) and
    the queries' mask logits share one map and differ mostly by an offset,
    as in an untrained model, so every gt prefers the same few queries and
    the auction runs hundreds of rounds; otherwise every query and gt is
    independent and a few rounds settle it."""
    from vitadapter_torch.ops import matching as mt

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    labels = torch.randint(0, K, (B, G), generator=gen, device="cuda")
    if contested:
        cls = 0.3 * randn(B, Q, K + 1)
        pred = (2 * randn(B, 1, P) + 0.5 * randn(B, Q, 1)
                + 0.5 * randn(B, Q, P))
        density = 1 / K
    else:
        cls, pred, density = 2 * randn(B, Q, K + 1), 3 * randn(B, Q, P), 0.3
    gt = (torch.rand(B, G, P, generator=gen, device="cuda") < density).float()
    return (mt.classification_cost(cls, labels, 2.0)
            + mt.bce_mask_cost(pred, gt, 5.0)
            + mt.dice_cost(pred, gt, 5.0)).contiguous()


def scipy_totals(cost, n_valid):
    """Optimal total matched cost of each matrix (scipy, float64)."""
    from scipy.optimize import linear_sum_assignment

    c = cost.double().cpu().numpy()
    out = []
    for b, n in enumerate(n_valid.tolist()):
        rows, cols = linear_sum_assignment(c[b, :, :n]) if n else ([], [])
        out.append(float(c[b][rows, cols].sum()))
    return out


def check_auction(rows, flush, gen):
    """auction: the kernel against the plain auction on the card (the same
    matches), and its total matched cost against scipy's optimum: within
    n_valid * eps above it (the auction's bound) plus fp32 rounding. At the
    flagship step's shapes with every gt valid and contested costs (the
    timed case), then on independent costs with 0 to 60 valid gts."""
    from vitadapter_torch.ops import matching as mt

    ok = True
    B, Q, G = AUCTION_SHAPE
    for case, nv in (("flagship", [G] * B),
                     ("n_valid", [G, 37, 7, 1, 0, G, 12, 2])):
        cost = auction_costs(gen, len(nv), Q, G,
                             contested=case == "flagship")
        n_valid = torch.tensor(nv, device="cuda")
        owner, iters = mt._kernel_auction(cost, n_valid)
        ref, ref_iters = mt.auction_assign_plain(cost, n_valid)
        torch.cuda.synchronize()
        same = bool((owner.long() == ref).all()) and bool(
            (iters.long() == ref_iters).all())
        err = float((owner.long() - ref).abs().max())
        scipy_totals(cost[:1], n_valid[:1])      # import scipy untimed
        t0 = time.perf_counter()
        opt = scipy_totals(cost, n_valid)
        scipy_ms = (time.perf_counter() - t0) * 1e3
        own = owner.long()
        got = torch.where(own >= 0, cost.gather(2, own.clamp(min=0)[..., None])
                          [..., 0], 0.0).double().sum(1).tolist()
        span = torch.where(torch.arange(G, device="cuda")[None, None]
                           < n_valid[:, None, None], cost.abs(), 0.0).amax(
            dim=(1, 2)).clamp(min=1e-6)
        gap = [g - o for g, o in zip(got, opt)]
        within = all(-1e-5 * abs(o) <= d <= n * float(s) / mt.EPS_DIV
                     + 1e-5 * abs(o)
                     for d, o, n, s in zip(gap, opt, nv, span.tolist()))
        matched = [int((own[b] >= 0).sum()) for b in range(len(nv))]
        good = same and within and matched == nv
        ok &= good
        k_ms = time_ms(lambda: mt._kernel_auction(cost, n_valid), flush)
        p_ms = time_ms(lambda: mt.auction_assign_plain(cost, n_valid), flush,
                       iters=3)
        # per round, each free gt scans its Q values (a subtraction and two
        # comparisons) and each query its G bids: 4 G Q operations at most
        rounds = iters.long().tolist()
        ops = sum(4 * G * Q * r for r in rounds)
        b = bound_ms(nbytes(cost, n_valid, owner, iters), ops, torch.float32)
        log(f"auction {case:8s} ({len(nv)}, {Q}, {G}) fp32 n_valid={nv[:8]} "
            f"same matches as plain={same} max_abs_err={err:.1f} total - "
            f"scipy optimum max {max(gap):.3e} within n_valid*eps={within} "
            f"rounds min/mean/max {min(rounds)}/"
            f"{sum(rounds) / len(rounds):.1f}/{max(rounds)} ok={good} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"scipy_host_ms={scipy_ms:.2f} bound_ms={b[0]:.6f} ({b[1]})")
        if case == "flagship":
            add_to_row(rows["auction"], 1, err, k_ms, p_ms, b)
    return ok


def check_msda(rows, flush, gen, unported):
    """msda_fwd and msda_bwd (through `MSDeformAttnFunction`)."""
    from vitadapter_torch.ops import msda

    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for name, (shapes, Lq, M, calls) in MSDA_GEOMETRIES.items():
            value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen)
            ins = [t.detach().clone().requires_grad_()
                   for t in (value, loc, attn)]
            got = msda.ms_deform_attn(ins[0], shapes, ins[1], ins[2])
            got.backward(g)
            ref = msda.ms_deform_attn_plain(value, shapes, loc, attn)
            ref_g = msda.ms_deform_attn_plain_backward(value, shapes, loc,
                                                       attn, g)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good_b = all(c[0] for c in checks)
            err_b = max(c[1] for c in checks)
            ok &= good and good_b
            corners = msda_corners(shapes, loc)
            D = value.shape[-1]

            def fwd():
                return msda.ms_deform_attn(value, shapes, loc, attn)

            def bwd():
                return msda._kernel_backward(value, shapes, loc, attn, g)

            def plain_bwd():
                return msda.ms_deform_attn_plain_backward(value, shapes, loc,
                                                          attn, g)

            with torch.no_grad():
                k_ms = time_ms(fwd, flush)
                p_ms = time_ms(lambda: msda.ms_deform_attn_plain(
                    value, shapes, loc, attn), flush, iters=3)
                kb_ms = time_ms(bwd, flush)
            pb_ms = time_ms(plain_bwd, flush, iters=3)
            # the sampling arithmetic is fp32 whatever the value dtype:
            # forward 2 flops per channel per in-map corner, backward 4
            # (the g.v dot and the scaled scatter into d value); bytes: the
            # value rows the points touch, read once; the output (the size
            # and dtype of g) written once; backward reads g and writes the
            # whole d value, d loc and d attn
            touched = msda_touched_bytes(shapes, value, loc)
            fb = bound_ms(touched + nbytes(loc, attn, g), 2 * D * corners,
                          torch.float32)
            bb = bound_ms(touched + nbytes(value) + 2 * nbytes(loc, attn)
                          + nbytes(g), 4 * D * corners, torch.float32)
            log(f"msda_fwd {name:13s} {str(dtype):14s} B=2 Lq={Lq} M={M} "
                f"S={value.shape[1]} max_abs_err={err:.3e} ok={good} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={fb[0]:.4f} ({fb[1]})")
            log(f"msda_bwd {name:13s} {str(dtype):14s} grads via the "
                f"autograd wrapper: max_abs_err (value, loc, attn)="
                f"{[f'{c[1]:.3e}' for c in checks]} ok={good_b} "
                f"kernel_ms={kb_ms:.4f} plain_ms={pb_ms:.4f} "
                f"bound_ms={bb[0]:.4f} ({bb[1]})")
            if dtype == torch.bfloat16:
                add_to_row(rows["msda_fwd"], calls, err, k_ms, p_ms, fb)
                add_to_row(rows["msda_bwd"], calls, err_b, kb_ms, pb_ms, bb)
                for k, (b_ms, b_by) in unported_msda_bounds(
                        shapes, value, loc, attn).items():
                    u = unported.setdefault(k, [0.0, set()])
                    u[0] += calls * b_ms
                    u[1].add(b_by)
    return ok


def grid_sample_inputs(value_l, loc_l, H, W):
    """One level as `F.grid_sample` takes it (the yardstick): the value as
    fp32 (B * M, D, H, W) maps, the points as (B * M, Lq, P, 2) in [-1, 1]."""
    B, _, M, D = value_l.shape
    Lq, P = loc_l.shape[1], loc_l.shape[3]
    inp = value_l.float().reshape(B, H, W, M, D).permute(0, 3, 4, 1, 2)
    grid = (loc_l * 2 - 1).permute(0, 2, 1, 3, 4)
    return (inp.reshape(B * M, D, H, W).contiguous(),
            grid.reshape(B * M, Lq, P, 2).contiguous())


def check_msda_levels(rows, flush, gen):
    """msda_level_fwd, msda_level_dv and msda_level_dgrid: each level's
    launch against its plain version (`_sample_one_level`, `level_dv_plain`,
    `level_dgrid_plain`), then the whole per-level route through the
    wrapper (`MSDeformAttnLevelFunction`) against `ms_deform_attn_plain`
    and its autograd, and in fp32 against the fused kernels
    (`MSDeformAttnFunction`, which takes any S): output and all three
    gradients within 1e-5 of the fused result's largest entry. Times each
    level's launch beside its bound, its plain version and `F.grid_sample`
    (forward; backward to the input for d value, to the grid for d loc).
    Bounds count the value rows the points touch, read once, and each
    output written once: the forward's fp32 (B, Lq, M, D), d value's whole
    level, d loc's and d attn's level slices."""
    from vitadapter_torch.ops import msda

    ok = True
    sample = dict(mode="bilinear", padding_mode="zeros", align_corners=False)
    for name, (shapes, Lq, M, dtypes, on_path) in LEVEL_GEOMETRIES.items():
        for dtype in dtypes:
            value, loc, attn, g = msda_inputs(shapes, Lq, M, dtype, gen, B=1)
            B, S, _, D = value.shape
            # the fp32 values pass the 8 MiB line; the bf16 one, half the
            # bytes, stays under it (the route test below then applies
            # `MSDeformAttnLevelFunction` itself)
            route = msda.msda_route(value.shape, dtype)
            ok &= route == ("level" if dtype == F32 else "fused")
            g4 = g.reshape(B, Lq, M, D)
            starts = msda.level_start_index(shapes)
            out = torch.zeros((B, Lq, M, D), dtype=F32, device="cuda")
            dv = torch.zeros((B, S, M, D), dtype=F32, device="cuda")
            dloc = torch.empty_like(loc)
            dattn = torch.empty_like(attn)
            for lvl, (H, W) in enumerate(shapes):
                rows_l = slice(starts[lvl], starts[lvl] + H * W)
                value_l = value[:, rows_l]
                loc_l, attn_l = loc[:, :, :, lvl], attn[:, :, :, lvl]
                out.zero_()
                msda.level_forward(value, shapes, lvl, loc, attn, out)
                msda.level_grad_value(value, shapes, lvl, loc, attn, g, dv)
                msda.level_grad_grid(value, shapes, lvl, loc, attn, g, dloc,
                                     dattn)
                ref = msda._sample_one_level(value_l, loc_l, attn_l, H, W)
                ref_dv = msda.level_dv_plain(loc_l, attn_l, g4, H, W)
                ref_dl, ref_da = msda.level_dgrid_plain(value_l, loc_l,
                                                        attn_l, g4, H, W)
                torch.cuda.synchronize()
                good_f, err_f = close(out, ref, F32)
                good_v, err_v = close_grad(dv[:, rows_l], ref_dv)
                c_l = close_grad(dloc[:, :, :, lvl], ref_dl)
                c_a = close_grad(dattn[:, :, :, lvl], ref_da)
                good_g, err_g = c_l[0] and c_a[0], max(c_l[1], c_a[1])
                ok &= good_f and good_v and good_g
                del ref, ref_dv, ref_dl, ref_da

                corners = corners_in_map(loc_l[..., 0], loc_l[..., 1], H, W)
                touched = touched_rows(loc_l, H, W) * D \
                    * value.element_size()
                ops = 2 * D * corners
                la = nbytes(loc_l, attn_l)
                fb = bound_ms(touched + la + B * Lq * M * D * 4, ops, F32)
                vb = bound_ms(la + nbytes(g) + B * H * W * M * D * 4, ops,
                              F32)
                gb = bound_ms(touched + nbytes(g) + 2 * la, ops, F32)
                inp, grid = grid_sample_inputs(value_l, loc_l, H, W)
                with torch.no_grad():
                    k_f = time_ms(lambda: msda.level_forward(
                        value, shapes, lvl, loc, attn, out), flush)
                    k_v = time_ms(lambda: msda.level_grad_value(
                        value, shapes, lvl, loc, attn, g, dv), flush)
                    k_g = time_ms(lambda: msda.level_grad_grid(
                        value, shapes, lvl, loc, attn, g, dloc, dattn),
                        flush)
                    p_f = time_ms(lambda: msda._sample_one_level(
                        value_l, loc_l, attn_l, H, W), flush, iters=3)
                    l_f = time_ms(lambda: F.grid_sample(inp, grid, **sample),
                                  flush)
                p_v = time_ms(lambda: msda.level_dv_plain(
                    loc_l, attn_l, g4, H, W), flush, iters=3)
                p_g = time_ms(lambda: msda.level_dgrid_plain(
                    value_l, loc_l, attn_l, g4, H, W), flush, iters=3)
                inp.requires_grad_()
                grid.requires_grad_()
                lib_out = F.grid_sample(inp, grid, **sample)
                go = torch.randn(lib_out.shape, generator=gen, device="cuda")
                l_v = time_ms(lambda: torch.autograd.grad(
                    lib_out, inp, go, retain_graph=True), flush)
                l_g = time_ms(lambda: torch.autograd.grad(
                    lib_out, grid, go, retain_graph=True), flush)
                del inp, grid, lib_out, go
                which = ("_sample_kernel_onehot_pf" if H * W <= 1024
                         else "_sample_kernel")
                head = (f"{name} {str(dtype):14s} level {lvl} ({H}, {W}) "
                        f"B=1 Lq={Lq} M={M}")
                log(f"msda_level_fwd {head} (the TPU's {which}) "
                    f"max_abs_err={err_f:.3e} ok={good_f} kernel_ms="
                    f"{k_f:.4f} plain_ms={p_f:.4f} grid_sample_ms={l_f:.4f} "
                    f"bound_ms={fb[0]:.4f} ({fb[1]}; {touched / 2 ** 20:.1f}"
                    f" of the level's {nbytes(value_l) / 2 ** 20:.1f} MiB of "
                    f"value touched)")
                log(f"msda_level_dv {head} max_abs_err={err_v:.3e} "
                    f"ok={good_v} kernel_ms={k_v:.4f} plain_ms={p_v:.4f} "
                    f"grid_sample_bwd_input_ms={l_v:.4f} "
                    f"bound_ms={vb[0]:.4f} ({vb[1]})")
                log(f"msda_level_dgrid {head} max_abs_err (loc, attn)="
                    f"({c_l[1]:.3e}, {c_a[1]:.3e}) ok={good_g} "
                    f"kernel_ms={k_g:.4f} plain_ms={p_g:.4f} "
                    f"grid_sample_bwd_grid_ms={l_g:.4f} "
                    f"bound_ms={gb[0]:.4f} ({gb[1]})")
                for kernel, numbers in (
                        ("msda_level_fwd", (err_f, k_f, p_f, fb, l_f)),
                        ("msda_level_dv", (err_v, k_v, p_v, vb, l_v)),
                        ("msda_level_dgrid", (err_g, k_g, p_g, gb, l_g))):
                    if on_path and on_path[0] == LEVEL_ROW_PATH[kernel]:
                        add_to_row(rows[kernel], on_path[1], *numbers)
                if dtype == F32 and H * W <= 1024:
                    rows["msda_level_fwd"]["small_level"] = dict(
                        shape=[H, W], ms=k_f, plain_ms=p_f, library_ms=l_f,
                        bound_ms=fb[0], bound_by=fb[1], max_abs_err=err_f)

            # the whole route, through the wrapper where it takes it
            ins = [t.detach().clone().requires_grad_()
                   for t in (value, loc, attn)]
            fn = (msda.ms_deform_attn if route == "level"
                  else msda.MSDeformAttnLevelFunction.apply)
            got = fn(ins[0], tuple(shapes), ins[1], ins[2])
            got.backward(g)
            ref = msda.ms_deform_attn_plain(value, shapes, loc, attn)
            ref_g = msda.ms_deform_attn_plain_backward(value, shapes, loc,
                                                       attn, g)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good_b = all(c[0] for c in checks)
            ok &= good and good_b
            del ref, ref_g
            vs_fused = ""
            if dtype == F32:
                fused = [t.detach().clone().requires_grad_()
                         for t in (value, loc, attn)]
                f_out = msda.MSDeformAttnFunction.apply(
                    fused[0], tuple(shapes), fused[1], fused[2])
                f_out.backward(g)
                rel = [float((a - b).abs().max() / b.abs().max())
                       for a, b in zip((got.detach(), *(t.grad for t in ins)),
                                       (f_out.detach(),
                                        *(t.grad for t in fused)))]
                good_fused = all(r <= 1e-5 for r in rel)
                ok &= good_fused
                vs_fused = (f" vs the fused kernels (out, d value, d loc, "
                            f"d attn) err/max={[f'{r:.2e}' for r in rel]} "
                            f"ok={good_fused}")
                del fused, f_out
            log(f"msda route {name} {str(dtype):14s} S={S} "
                f"({S * D * value.element_size() / 2 ** 20:.2f} MiB per "
                f"head) route={route}: out max_abs_err={err:.3e} ok={good}; "
                f"grads via MSDeformAttnLevelFunction max_abs_err (value, "
                f"loc, attn)={[f'{c[1]:.3e}' for c in checks]} ok={good_b}"
                + vs_fused)
            del value, loc, attn, g, g4, out, dv, dloc, dattn, ins, got
            torch.cuda.empty_cache()
    return ok


def check_attention(rows, flush, gen):
    """attention_fwd and attention_bwd (through `FusedAttentionFunction`)."""
    from vitadapter_torch.ops import attention as at

    ok = True
    sdpa = F.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        cases = [ATTN_SHAPE, (2, 16, 1000, 64), (1, 3, 130, 32),
                 (1, 2, 77, 128)]
        for shape in cases:
            q, k, v, g = (torch.randn(*shape, generator=gen, device="cuda")
                          .to(dtype) for _ in range(4))
            ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            got = at.fused_attention(*ins)
            got.backward(g)
            ref = at.attention_plain(q, k, v)
            ref_g = at.attention_plain_backward(q, k, v, g)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            checks = [close_grad(t.grad, r) for t, r in zip(ins, ref_g)]
            good_b = all(c[0] for c in checks)
            err_b = max(c[1] for c in checks)
            ok &= good and good_b
            scale = shape[-1] ** -0.5
            lib = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib_out = sdpa(*lib)
            with torch.no_grad():
                k_ms = time_ms(lambda: at.fused_attention(q, k, v), flush)
                p_ms = time_ms(lambda: at.attention_plain(q, k, v), flush)
                kb_ms = time_ms(lambda: at._kernel_backward(q, k, v, g,
                                                            scale), flush)
                lib_ms = time_ms(lambda: sdpa(q, k, v), flush)
            pb_ms = time_ms(lambda: at.attention_plain_backward(q, k, v, g),
                            flush)
            libb_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, lib, g, retain_graph=True), flush)
            B, H, N, D = shape
            fb = bound_ms(4 * nbytes(q), 4 * B * H * N * N * D, dtype)
            # backward: q k^T again, dv = P^T dO, dP = dO v^T, dq, dk
            bb = bound_ms(7 * nbytes(q), 10 * B * H * N * N * D, dtype)
            log(f"attention_fwd {str(shape):18s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} ok={good} kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"bound_ms={fb[0]:.4f} ({fb[1]})")
            log(f"attention_bwd {str(shape):18s} {str(dtype):14s} grads via "
                f"the autograd wrapper: max_abs_err (q, k, v)="
                f"{[f'{c[1]:.3e}' for c in checks]} ok={good_b} "
                f"kernel_ms={kb_ms:.4f} plain_ms={pb_ms:.4f} "
                f"sdpa_bwd_ms={libb_ms:.4f} bound_ms={bb[0]:.4f} ({bb[1]})")
            if dtype == torch.bfloat16 and shape == ATTN_SHAPE:
                add_to_row(rows["attention_fwd"], ATTN_CALLS, err, k_ms, p_ms,
                           fb, lib_ms)
                add_to_row(rows["attention_bwd"], ATTN_CALLS, err_b, kb_ms,
                           pb_ms, bb, libb_ms)
    return ok


def check_point_sample(rows, flush, gen):
    """point_sample_fwd and point_sample_bwd (through
    `PointSampleFunction`). The yardstick is `F.grid_sample` on fp32 copies
    of the masks, the points mapped to [-1, 1]."""
    from vitadapter_torch.ops import point_sample as ps

    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        for name, (N, H, W, P, sort, calls) in POINT_GEOMETRIES.items():
            masks = torch.randn(N, H, W, generator=gen, device="cuda") \
                .to(dtype)
            pts = torch.rand(N, P, 2, generator=gen, device="cuda")
            if sort:
                pts = ps.sort_points_by_y(pts)
            has_grad = name == POINT_BWD
            m_in = masks.detach().clone().requires_grad_(has_grad)
            got = ps.point_sample(m_in, pts)
            ref = ps.point_sample_plain(masks, pts)
            good, err = close(got, ref, torch.float32)
            checks = []
            if has_grad:
                g = torch.randn(N, P, generator=gen, device="cuda")
                got.backward(g)
                checks = [close_grad(m_in.grad, ps.point_sample_plain_backward(
                    masks, pts, g))]
            torch.cuda.synchronize()
            good_b = all(c[0] for c in checks)
            ok &= good and good_b
            corners = corners_in_map(pts[..., 0], pts[..., 1], H, W)
            m4 = masks.float()[:, None]
            grid = (pts * 2 - 1)[:, None]
            with torch.no_grad():
                k_ms = time_ms(lambda: ps.point_sample(masks, pts), flush)
                p_ms = time_ms(lambda: ps.point_sample_plain(masks, pts),
                               flush, iters=3)
                lib_ms = time_ms(lambda: F.grid_sample(
                    m4, grid, mode="bilinear", padding_mode="zeros",
                    align_corners=False), flush)
            fb = bound_ms(nbytes(masks, pts) + N * P * 4, 2 * corners,
                          torch.float32)
            log(f"point_sample_fwd {name:12s} {str(dtype):14s} "
                f"({N}, {H}, {W}) x {P} points max_abs_err={err:.3e} "
                f"ok={good} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"grid_sample_ms={lib_ms:.4f} bound_ms={fb[0]:.4f} "
                f"({fb[1]})")
            if dtype == torch.bfloat16:
                add_to_row(rows["point_sample_fwd"], calls, err, k_ms, p_ms,
                           fb, lib_ms)
            if not has_grad:
                continue
            m4r = m4.detach().clone().requires_grad_()
            lib_out = F.grid_sample(m4r, grid, mode="bilinear",
                                    padding_mode="zeros", align_corners=False)
            g4 = g[:, None, None, :]
            with torch.no_grad():
                kb_ms = time_ms(lambda: ps._kernel_backward(masks, pts, g),
                                flush)
            pb_ms = time_ms(lambda: ps.point_sample_plain_backward(
                masks, pts, g), flush, iters=3)
            libb_ms = time_ms(lambda: torch.autograd.grad(
                lib_out, m4r, g4, retain_graph=True), flush)
            bb = bound_ms(nbytes(pts, g, masks), 2 * corners, torch.float32)
            log(f"point_sample_bwd {name:12s} {str(dtype):14s} d masks via "
                f"the autograd wrapper: max_abs_err={checks[0][1]:.3e} "
                f"ok={good_b} kernel_ms={kb_ms:.4f} plain_ms={pb_ms:.4f} "
                f"grid_sample_bwd_ms={libb_ms:.4f} bound_ms={bb[0]:.4f} "
                f"({bb[1]})")
            if dtype == torch.bfloat16:
                add_to_row(rows["point_sample_bwd"], calls, checks[0][1],
                           kb_ms, pb_ms, bb, libb_ms)
    return ok


def check_kernels(flush):
    """Phase 3. Returns each kernel's numbers at the flagship's bf16 shapes,
    summed over its calls in one batch-2 forward (forward kernels) or one
    batch-2 train step (the others; one forward runs in each step); the
    per-level MSDA kernels' in fp32 at their main path's shapes, summed
    over its level launches in one flagship forward at ratio 1.5
    (msda_level_fwd, phase 8) or in one over-line train step (msda_level_dv
    and _dgrid, phase 9)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    rows = {name: new_row(library=name not in ("msda_fwd", "msda_bwd",
                                                 "auction"))
            for name in REPLACES}
    unported = {}
    ok = check_msda(rows, flush, gen, unported)
    ok &= check_msda_levels(rows, flush, gen)
    ok &= check_attention(rows, flush, gen)
    ok &= check_point_sample(rows, flush, gen)
    ok &= check_auction(rows, flush, gen)
    if not ok:
        raise SystemExit("FAIL: a kernel disagrees with its plain version")
    log("bounds of the TPU kernels not ported yet, ms per flagship bf16 "
        "batch-2 forward at the shapes above (not launched by the JAX "
        "dispatch by default): "
        + json.dumps({k: [round(v[0], 6), "/".join(sorted(v[1]))]
                      for k, v in unported.items()}))
    for r in rows.values():
        r["bound_by"] = "/".join(sorted(r["bound_by"]))
    return rows


def serve_flagship(requests=SERVE_REQUESTS):
    """Phase 4: the flagship eval forward on batch-2 uint8 requests."""
    from vitadapter_torch import zoo
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext

    t0 = time.perf_counter()
    model = zoo.mask2former_vit_adapter(
        "large", dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship built: {n_params / 1e6:.1f} M params fp32, "
        f"{time.perf_counter() - t0:.1f} s")
    host = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, 256, (2, 512, 512, 3), dtype=torch.uint8,
                             generator=host) for _ in range(requests)]
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    times = []
    with torch.inference_mode():
        for img in batches:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = model(normalize(img.cuda(), dtype=torch.bfloat16))
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
            if tuple(out.shape) != (2, 512, 512, 150):
                raise SystemExit(f"FAIL: logits shape {tuple(out.shape)}")
            if not bool(torch.isfinite(out).all()):
                raise SystemExit("FAIL: non-finite logits")
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {"msda_fwd": 16 * requests, "attention_fwd": 24 * requests}
    log(f"flagship requests (ms, CUDA events, host->device copy included): "
        f"{[round(t, 2) for t in times]}")
    steady = times[1:]
    log(f"flagship bf16 batch 2: {2 * len(steady) / (sum(steady) / 1e3):.3f} "
        f"img/s over requests 2..{requests}, first request "
        f"{times[0]:.1f} ms, peak memory {peak:.2f} GiB")
    log(f"launches in {requests} requests: {counts} (want {want})")
    if counts != want:
        raise SystemExit("FAIL: the flagship path did not launch each "
                         "kernel as often as expected")
    del model
    torch.cuda.empty_cache()
    return counts


def randomize(model, gen):
    """Give every zero/one-initialized weight random values (injector gamma,
    MSDA offset and weight heads, biases, norm scales, BN statistics)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1 and (name.endswith("weight") or "gamma" in name):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=gen))
            elif p.ndim == 1:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith(("sampling_offsets.weight",
                                "attention_weights.weight")):
                p.copy_(torch.randn(p.shape, generator=gen)
                        / p.shape[1] ** 0.5)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.3 * torch.randn(m.running_mean.shape,
                                                       generator=gen))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=gen))


def reduced_model(gen, **kw):
    """Depth 4 at full width on the CPU, one block per interaction."""
    from vitadapter_torch import zoo

    model = zoo.mask2former_vit_adapter(
        "large", device="cpu", generator=gen, depth=4,
        interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)), **kw)
    randomize(model, gen)
    return model


def card_vs_cpu():
    """Phase 5: reduced depth, full width, fp32; kernels vs plain versions."""
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    cpu = reduced_model(gen)
    card = copy.deepcopy(cpu).cuda()
    img = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                        generator=gen)
    before = dict(cuda_ext.launches)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = cpu(normalize(img))
        t_cpu = time.perf_counter() - t0
        got = card(normalize(img.cuda())).cpu()
    used = {k: v - before.get(k, 0) for k, v in cuda_ext.launches.items()}
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    ok = (err <= E2E_RTOL * scale and tuple(got.shape) == (2, 128, 128, 150)
          and bool(torch.isfinite(got).all()))
    log(f"reduced model (depth 4, full width) fp32 card vs CPU: "
        f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={err / scale:.3e} "
        f"(tol {E2E_RTOL}) ok={ok}; CPU forward {t_cpu:.1f} s; "
        f"kernel launches {used}")
    if not ok or used.get("msda_fwd", 0) != 16 or used.get("attention_fwd",
                                                           0) != 4:
        raise SystemExit("FAIL: reduced model card vs CPU")


def train_flagship(steps=TRAIN_STEPS):
    """Phase 6: the flagship train step, as the JAX package's bench sets it
    up: batch 2 at 512x512, fp32 parameters, bf16 compute, DropPath 0.4,
    labels in [0, 150), 60 instances, 12544 points, AdamW with layer decay
    (total 1000 steps, warmup 10, clip 0.01), the auction assignment."""
    from vitadapter_torch import zoo
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    model = zoo.mask2former_vit_adapter(
        "large", dtype=torch.bfloat16,
        generator=torch.Generator("cuda").manual_seed(0))
    opt, _ = make_optimizer(model, depth=24, total_steps=1000,
                            warmup_steps=10, grad_clip=0.01)
    state = TrainState.create(model, opt)
    step = make_m2f_train_step(model, num_classes=150, max_instances=60,
                               num_points=12544)
    gen = torch.Generator("cuda").manual_seed(3)
    batch = {"image": torch.randn(2, 512, 512, 3, generator=gen,
                                  device="cuda").to(torch.bfloat16),
             "label": torch.randint(0, 150, (2, 512, 512), generator=gen,
                                    device="cuda")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    times, losses, norms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, logs = step(state, batch, gen)
        loss, norm = float(logs["loss"]), float(logs["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(norm)
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), before[n])]
    n_params = len(before)
    changed = n_params - len(still)
    want = {k: v * steps for k, v in TRAIN_LAUNCHES.items()}
    log(f"flagship train steps (s, host clock to a synchronize): "
        f"{[round(t, 3) for t in times]}; losses {losses}; grad norms "
        f"{norms}; last logs {({k: float(v) for k, v in logs.items()})}")
    log(f"flagship bf16 batch-2 train step: {sum(times[1:]) / (steps - 1):.3f}"
        f" s/step over steps 2..{steps}, first step {times[0]:.3f} s, peak "
        f"memory {peak:.2f} GiB; {changed} of {n_params} parameter tensors "
        f"changed (unchanged: {still})")
    log(f"launches in {steps} train steps: {counts} (want {want})")
    finite = all(map(lambda x: x == x and abs(x) != float("inf"),
                     losses + norms))
    if not finite or changed < 0.95 * n_params or state.step != steps:
        raise SystemExit("FAIL: flagship train step (non-finite loss or "
                         "gradient norm, or parameters did not move)")
    if counts != want:
        raise SystemExit("FAIL: the flagship train step did not launch each "
                         "kernel as often as expected")
    del model, opt, state, before
    torch.cuda.empty_cache()
    return counts


def train_card_vs_cpu():
    """Phase 7: one train step of the reduced model, fp32, TF32 off, drop
    path 0, 1024 points, on the card (kernels) and on the CPU (plain
    versions), with the same weights, batch and sampler draws; compares the
    loss and the gradient norm. Each label map holds 8 classes in blocks,
    as an ADE20K image holds about ten: the auction then matches 8 gts per
    image, so costs that differ between the sides by float rounding have
    few near-equal bids to flip."""
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.ops.point_sample import uniform_sampler
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    cpu = reduced_model(gen, drop_path_rate=0.0)
    card = copy.deepcopy(cpu).cuda()
    ids = torch.randint(0, 150, (2, 8), generator=gen)
    cells = torch.randint(0, 8, (2, 16), generator=gen)
    label = ids.gather(1, cells).reshape(2, 4, 4)
    batch = {"image": torch.randn(2, 128, 128, 3, generator=gen),
             "label": label.repeat_interleave(32, 1).repeat_interleave(32, 2)}
    results = {}
    for side, model in (("cpu", cpu), ("cuda", card)):
        opt, _ = make_optimizer(model, depth=4, total_steps=1000,
                                warmup_steps=0, grad_clip=0.01)
        step = make_m2f_train_step(model, num_classes=150, num_points=1024)
        b = {k: v.to(side) for k, v in batch.items()}
        sampler = uniform_sampler(torch.Generator().manual_seed(5))
        before = dict(cuda_ext.launches)
        t0 = time.perf_counter()
        _, logs = step(TrainState.create(model, opt), b,
                       torch.Generator(side).manual_seed(6), sampler)
        logs = {k: float(v) for k, v in logs.items()}
        results[side] = (logs, time.perf_counter() - t0, {
            k: v - before.get(k, 0) for k, v in cuda_ext.launches.items()
            if v != before.get(k, 0)})
    (ref, t_cpu, _), (got, t_card, used) = results["cpu"], results["cuda"]
    rel = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-12)
           for k in ("loss", "grad_norm")}
    ok = all(r <= TRAIN_RTOL for r in rel.values())
    log(f"reduced model (depth 4, full width) fp32 train step card vs CPU: "
        f"card {got} CPU {ref} rel {rel} (tol {TRAIN_RTOL}) ok={ok}; "
        f"CPU step {t_cpu:.1f} s, card step {t_card:.2f} s; kernel launches "
        f"{used}")
    want = dict(TRAIN_LAUNCHES, attention_fwd=4, attention_bwd=4)
    if not ok or used != want:
        raise SystemExit("FAIL: reduced model train step card vs CPU "
                         f"(launches {used}, want {want})")


class Items:
    """A dataset of given (uint8 HxWx3 image, int HxW label) pairs."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


def block_labels(gen, h, w, classes, cell):
    """A label map of cell x cell blocks of random classes in [0, classes)
    (cropped at the edges)."""
    ids = torch.randint(0, classes, (-(-h // cell), -(-w // cell)),
                        generator=gen)
    lab = ids.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    return lab[:h, :w].numpy().astype("int32")


def eval_flagship_whole():
    """Phase 8: the flagship in fp32 (as the JAX configs evaluate it: no
    dtype set) through `run_eval` on one uint8 1024x2048 image, whole mode,
    img_scale (2048, 1024), ratios (1.0, 1.5) with flip. At ratio 1.5 the
    injectors' and the pixel decoder's values hold 11.8 MiB per head and
    take the per-level kernels; the extractors' 2.25 MiB stay fused."""
    from vitadapter_torch import zoo
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.loop import run_eval

    model = zoo.mask2former_vit_adapter(
        "large", generator=torch.Generator("cuda").manual_seed(0))
    host = torch.Generator().manual_seed(8)
    h, w = EVAL_HW
    img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                        generator=host).numpy()
    label = block_labels(host, h, w, 150, 128)
    label[:64] = 255                     # an ignored band
    calls = []

    def pre(_m, args):
        s = torch.cuda.Event(enable_timing=True)
        s.record()
        calls.append([tuple(args[0].shape), s, None, None])

    def post(_m, _args, out):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        calls[-1][2] = e
        calls[-1][3] = torch.isfinite(out).all()

    hooks = [model.register_forward_pre_hook(pre),
             model.register_forward_hook(post)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    t0 = time.perf_counter()
    metrics = run_eval(EVAL_CFG, model, Items([(img, label)]),
                       aug_test=True, log_fn=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for hk in hooks:
        hk.remove()
    fwd = [(shape, s.elapsed_time(e), bool(fin))
           for shape, s, e, fin in calls]
    cm = metrics["confusion"]
    labelled = int((label != 255).sum())
    log(f"flagship fp32 whole-image eval of one {h}x{w} image, ratios "
        f"{EVAL_CFG['aug_test']['img_ratios']} with flip: forwards (input "
        f"shape, ms, logits finite) {[(s, round(t, 2), f) for s, t, f in fwd]}"
        f"; run_eval {wall:.2f} s in all, peak memory {peak:.2f} GiB; "
        f"confusion sums to {int(cm.sum())} of {labelled} labelled pixels; "
        f"mIoU {metrics['mIoU']:.4f} (random weights)")
    log(f"launches in the evaluation: {counts} (want {EVAL_LAUNCHES})")
    finite = all(f for _, _, f in fwd) and len(fwd) == 4
    if not finite or int(cm.sum()) != labelled \
            or metrics["mIoU"] != metrics["mIoU"]:
        raise SystemExit("FAIL: flagship whole-image evaluation (non-finite "
                         "logits or a confusion matrix that does not count "
                         "the labelled pixels)")
    if counts != EVAL_LAUNCHES:
        raise SystemExit("FAIL: the evaluation did not launch each kernel "
                         "as often as expected")
    del model
    torch.cuda.empty_cache()
    return counts


def train_overline():
    """Phase 9: one fp32 train step of the reduced model (depth 4, full
    width), drop path 0, batch 1 at 1792x1792: the injectors' and the pixel
    decoder's values hold 8.04 MiB per head, over the line, so their
    forward and backward take the per-level kernels."""
    from vitadapter_torch import zoo
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.optim import make_optimizer
    from vitadapter_torch.train.trainer import TrainState, make_m2f_train_step

    model = zoo.mask2former_vit_adapter(
        "large", num_queries=OVERLINE_QUERIES, depth=4,
        interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)),
        drop_path_rate=0.0, generator=torch.Generator("cuda").manual_seed(0))
    randomize(model, torch.Generator().manual_seed(9))
    opt, _ = make_optimizer(model, depth=4, total_steps=1000,
                            warmup_steps=0, grad_clip=0.01)
    state = TrainState.create(model, opt)
    step = make_m2f_train_step(model, num_classes=150)
    gen = torch.Generator("cuda").manual_seed(10)
    n = OVERLINE_HW
    label = block_labels(torch.Generator().manual_seed(11), n, n, 150, 448)
    batch = {"image": torch.randn(1, n, n, 3, generator=gen, device="cuda"),
             "label": torch.from_numpy(label).long()[None].cuda()}
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ext.launches.clear()
    t0 = time.perf_counter()
    state, logs = step(state, batch, gen)
    logs = {k: float(v) for k, v in logs.items()}
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    counts = dict(cuda_ext.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), before[k])]
    log(f"reduced fp32 train step at {n}x{n}, batch 1, {OVERLINE_QUERIES} "
        f"queries: {took:.2f} s (the first step: builds included), peak "
        f"memory {peak:.2f} GiB; logs {logs}; {len(before) - len(still)} "
        f"of {len(before)} parameter tensors changed (unchanged: {still})")
    log(f"launches in the step: {counts} (want {OVERLINE_LAUNCHES})")
    finite = all(v == v and abs(v) != float("inf") for v in logs.values())
    if not finite or len(still) > 0.05 * len(before):
        raise SystemExit("FAIL: over-line train step (non-finite loss or "
                         "gradient norm, or parameters did not move)")
    if counts != OVERLINE_LAUNCHES:
        raise SystemExit("FAIL: the over-line train step did not launch each "
                         "kernel as often as expected")
    del model, opt, state, before
    torch.cuda.empty_cache()
    return counts


def eval_card_vs_cpu():
    """Phase 10: `run_eval` with the reduced model in fp32, whole mode, on
    two odd-sized non-square images, ratios (0.75, 1.0) with flip, on the
    card (kernels) and on the CPU (plain versions): the confusion matrices
    may differ in at most EVAL_CM_SHARE of the labelled pixels."""
    from vitadapter_torch.ops import cuda_ext
    from vitadapter_torch.train.loop import run_eval

    gen = torch.Generator().manual_seed(12)
    cpu = reduced_model(gen)
    card = copy.deepcopy(cpu).cuda()
    items = []
    for h, w in ((97, 151), (131, 83)):
        img = torch.randint(0, 256, (h, w, 3), dtype=torch.uint8,
                            generator=gen).numpy()
        items.append((img, block_labels(gen, h, w, 150, 24)))
    cfg = {"num_classes": 150,
           "test_cfg": {"mode": "whole", "img_scale": (192, 128)},
           "aug_test": {"img_ratios": [0.75, 1.0], "flip": True}}
    cms, secs = {}, {}
    before = dict(cuda_ext.launches)
    for side, model in (("cpu", cpu), ("cuda", card)):
        t0 = time.perf_counter()
        cms[side] = run_eval(cfg, model, Items(items), aug_test=True,
                             log_fn=lambda *_: None)["confusion"]
        secs[side] = time.perf_counter() - t0
    used = {k: v - before.get(k, 0) for k, v in cuda_ext.launches.items()
            if v != before.get(k, 0)}
    labelled = sum(int(lab.size) for _, lab in items)
    moved = int(abs(cms["cuda"] - cms["cpu"]).sum()) // 2
    ok = (moved <= EVAL_CM_SHARE * labelled
          and int(cms["cuda"].sum()) == labelled)
    want = {"msda_fwd": 8 * 16, "attention_fwd": 8 * 4}
    log(f"reduced model fp32 run_eval card vs CPU, images (97, 151) and "
        f"(131, 83), ratios (0.75, 1.0) with flip: {moved} of {labelled} "
        f"labelled pixels predicted differently (tol {EVAL_CM_SHARE} of "
        f"them) ok={ok}; CPU {secs['cpu']:.1f} s, card {secs['cuda']:.2f} s;"
        f" kernel launches {used} (want {want})")
    if not ok or used != want:
        raise SystemExit("FAIL: run_eval card vs CPU")


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from vitadapter_torch.ops import cuda_ext

    # phase 1: the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")

    # phase 2: build
    t0 = time.perf_counter()
    logs = cuda_ext.build()
    log(f"built {sorted(cuda_ext.SIGNATURES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # phase 3: kernels against their plain versions
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = check_kernels(flush)
    del flush

    # phase 4: the flagship serving path
    serve_counts = serve_flagship()

    # phase 5: end to end, kernels against plain versions
    card_vs_cpu()

    # phase 6: the flagship train step
    train_counts = train_flagship()

    # phase 7: a train step, kernels against plain versions
    train_card_vs_cpu()

    # phase 8: whole-image evaluation, the per-level forward on its path
    eval_counts = eval_flagship_whole()

    # phase 9: an over-line train step, all ten kernels
    overline_counts = train_overline()

    # phase 10: run_eval, card against CPU
    eval_card_vs_cpu()

    paths = {"serve": serve_counts, "train": train_counts,
             "eval_whole": eval_counts, "train_overline": overline_counts}
    kernels = []
    for name in sorted(rows):
        r = rows[name]
        # each kernel's main path: the first of these paths that runs it
        path = next(p for p in ("serve", "train", "eval_whole",
                                "train_overline") if name in paths[p])
        if name == "msda_level_fwd":
            per = ("times per flagship fp32 forward of a 1024x2048 image at "
                   "ratio 1.5 (6 pixel-decoder and 4 injector MSDA calls, 3 "
                   "level launches each, at phase 8's shapes)")
        elif name.startswith("msda_level"):
            per = ("times per reduced fp32 train step at 1792x1792 (6 "
                   "pixel-decoder and 4 injector MSDA calls, 3 level "
                   "launches each, at phase 9's shapes)")
        elif name in serve_counts:
            per = ("times per flagship bf16 batch-2 forward (one runs in "
                   "each train step)")
        else:
            per = "times per flagship bf16 batch-2 train step"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vitadapter_torch/ops/csrc/{name}.cu",
            "replaces": REPLACES[name], "status": "ported",
            "launches": paths[path][name], "main_path": path,
            **{f"launches_{p}": c.get(name, 0) for p, c in paths.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"small_level": r["small_level"]} if "small_level" in r
               else {}),
            "per": per + f"; launches over the {path} phase"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
