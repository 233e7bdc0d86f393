#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`vitadapter_torch`) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught):
  1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. builds every CUDA kernel of the port from `vitadapter_torch/ops/csrc`;
  3. holds each kernel against its plain PyTorch version on the card, fp32
     and bf16, at the flagship's shapes, and times kernel, plain version and
     (for attention) `F.scaled_dot_product_attention` as a yardstick;
  4. serves a few batch-2 requests of raw uint8 512x512 images with the
     flagship ViT-Adapter-L + Mask2Former (ADE20K, 150 classes) in bf16 from
     random seeded weights, and checks the launch counts of the kernels;
  5. runs a reduced-depth, full-width model in fp32 on the card (kernels)
     and on the CPU (plain versions) and compares the logits.
The last two lines are a JSON object of the kernels' numbers and
{"ok": true, "device": {...}}.
"""

import copy
import json
import subprocess
import sys
import time

import torch

# published H100 SXM peaks (NVIDIA data sheet) for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores, dense
              torch.float32: 67e12}     # CUDA cores

# tolerances of kernel vs plain version on the same inputs (both sum in
# fp32 in another order): fp32 differs by float rounding; bf16 outputs are
# both rounded from fp32 sums, so they differ by at most ~1 bf16 ulp (2^-8
# relative), allowed twice over.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# reduced-depth model, card (kernels, cuDNN convs) vs CPU, fp32, TF32 off:
# float reassociation across ~60 layers, relative to the logits' scale
E2E_RTOL = 1e-3

MSDA_GEOMETRIES = {
    # name: (spatial shapes of the value, Lq, heads, calls per forward)
    "injector": (((64, 64), (32, 32), (16, 16)), 1024, 16, 4),
    "extractor": (((32, 32),), 5376, 16, 6),
    "pixel_decoder": (((16, 16), (32, 32), (64, 64)), 5376, 32, 6),
}
ATTN_SHAPE = (2, 16, 1024, 64)   # 24 calls per forward
ATTN_CALLS = 24
SERVE_REQUESTS = 4   # batch-2 requests of the main path (phase 4)


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
    err = (got.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    return ok, float(err.max())


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
    return value, loc.contiguous(), attn.contiguous()


def msda_work(value, shapes, loc, attn):
    """(bytes, flops) one call must at least move and do: each input read
    once, the output written once; 2 flops per channel per in-map corner."""
    B, S, M, D = value.shape
    corners = 0
    for lvl, (H, W) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        for dx in (0, 1):
            for dy in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                corners += int(((xi >= 0) & (xi < W) & (yi >= 0)
                                & (yi < H)).sum())
    out_bytes = B * loc.shape[1] * M * D * value.element_size()
    nbytes = (value.numel() * value.element_size() + loc.numel() * 4
              + attn.numel() * 4 + out_bytes)
    return nbytes, 2 * D * corners


def bound_ms(nbytes, flops, dtype):
    """Least time for the work: bytes over HBM rate, or operations over the
    peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(flush):
    """Phase 3. Returns the kernels' per-forward numbers (bf16, flagship)."""
    from vitadapter_torch.ops.attention import attention_plain, fused_attention
    from vitadapter_torch.ops.msda import ms_deform_attn, ms_deform_attn_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(0)
    ok = True
    rows = {"msda_fwd": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                             bound_ms=0.0, library_ms=None, bound_by=set()),
            "attention_fwd": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                  bound_ms=0.0, library_ms=0.0,
                                  bound_by=set())}

    for dtype in (torch.float32, torch.bfloat16):
        for name, (shapes, Lq, M, calls) in MSDA_GEOMETRIES.items():
            value, loc, attn = msda_inputs(shapes, Lq, M, dtype, gen)
            got = ms_deform_attn(value, shapes, loc, attn)
            ref = ms_deform_attn_plain(value, shapes, loc, attn)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            ok &= good
            ref_max = float(ref.float().abs().max())
            k_ms = time_ms(lambda: ms_deform_attn(value, shapes, loc, attn),
                           flush)
            p_ms = time_ms(lambda: ms_deform_attn_plain(value, shapes, loc,
                                                        attn), flush, iters=3)
            nbytes, flops = msda_work(value, shapes, loc, attn)
            # the sampling arithmetic is fp32 whatever the value dtype
            b_ms, b_by = bound_ms(nbytes, flops, torch.float32)
            log(f"msda_fwd {name:13s} {str(dtype):14s} B=2 Lq={Lq} M={M} "
                f"S={value.shape[1]} max_abs_err={err:.3e} "
                f"rel={err / ref_max:.3e} ok={good} kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}: "
                f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
            if dtype == torch.bfloat16:
                r = rows["msda_fwd"]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ms"] += calls * k_ms
                r["plain_ms"] += calls * p_ms
                r["bound_ms"] += calls * b_ms
                r["bound_by"].add(b_by)

        cases = [ATTN_SHAPE, (2, 16, 1000, 64), (1, 3, 130, 32),
                 (1, 2, 77, 128)]
        for shape in cases:
            q, k, v = (torch.randn(*shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            got = fused_attention(q, k, v)
            ref = attention_plain(q, k, v)
            torch.cuda.synchronize()
            good, err = close(got, ref, dtype)
            ok &= good
            k_ms = time_ms(lambda: fused_attention(q, k, v), flush)
            p_ms = time_ms(lambda: attention_plain(q, k, v), flush)
            B, H, N, D = shape
            nbytes = 4 * q.numel() * q.element_size()
            flops = 4 * B * H * N * N * D
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            lib_ms = time_ms(lambda: torch.nn.functional
                             .scaled_dot_product_attention(q, k, v), flush)
            log(f"attention_fwd {str(shape):18s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} ok={good} kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}: {nbytes / 1e6:.2f} MB, "
                f"{flops / 1e9:.2f} GFLOP)")
            if dtype == torch.bfloat16 and shape == ATTN_SHAPE:
                r = rows["attention_fwd"]
                r["max_abs_err"] = err
                r["ms"] = ATTN_CALLS * k_ms
                r["plain_ms"] = ATTN_CALLS * p_ms
                r["bound_ms"] = ATTN_CALLS * b_ms
                r["library_ms"] = ATTN_CALLS * lib_ms
                r["bound_by"].add(b_by)
    if not ok:
        raise SystemExit("FAIL: a kernel disagrees with its plain version")
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


def card_vs_cpu():
    """Phase 5: reduced depth, full width, fp32; kernels vs plain versions."""
    from vitadapter_torch import zoo
    from vitadapter_torch.data.preprocess import normalize
    from vitadapter_torch.ops import cuda_ext

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    cpu = zoo.mask2former_vit_adapter(
        "large", device="cpu", generator=gen, depth=4,
        interaction_indexes=((0, 0), (1, 1), (2, 2), (3, 3)))
    randomize(cpu, gen)
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
    counts = serve_flagship()

    # phase 5: end to end, kernels against plain versions
    card_vs_cpu()

    replaces = {"msda_fwd": "vitadapter/ops/msda_pallas.py:316",
                "attention_fwd": "vitadapter/ops/attention_pallas.py:57"}
    kernels = []
    for name in sorted(rows):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vitadapter_torch/ops/csrc/{name}.cu",
            "replaces": replaces[name], "status": "ported",
            "launches": counts.get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "per": "times per flagship bf16 batch-2 forward; launches over "
                   f"the {SERVE_REQUESTS} requests of the main path"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
