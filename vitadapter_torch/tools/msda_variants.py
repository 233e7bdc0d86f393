#!/usr/bin/env python3
"""Card time of variants of the fused MSDA kernels (`csrc/msda_fwd.cu`,
`csrc/msda_bwd.cu`) beside the kernels as they are, on `chip_smoke.py`'s
clock: the measurements behind the design notes in those sources.

Run from the repository root on a machine with one NVIDIA H100:

    python3 vitadapter_torch/tools/msda_variants.py

Each variant is the checked-in source with a few lines replaced
(`VARIANTS`: the old text must be found, or the tool stops), built with the
port's nvcc flags into `vitadapter_torch/_build/variants/` and called through
its C entry point. Two kinds:
- ablations, whose results are wrong on purpose and are not checked: the
  forward without its value loads, the backward without its d value
  atomics (what is left is the rest of the kernel's work);
- designs measured and not kept: one 16-byte chunk a lane in the forward,
  16-byte bf16 chunks in the backward, the backward's adds to one chunk
  combined across the warp by `__match_any_sync` before the atomic, and
  each team's points rotated by a level (teams of a warp start on
  different levels).
At the flagship's geometries (`chip_smoke.MSDA_GEOMETRIES`, batch 2) in
bf16 and fp32, on uniform, model-shaped and one-cell locations (as
`msda_ab.py`), it times the kernel each variant changes and sums per
forward (msda_fwd) or train step (msda_bwd). Prints the card's name and
power limit, then one JSON line.
"""

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ITERS = 10

_BWD_ATOMIC = """#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int ch = ln.gl + G * k;
          if (ch < C) atomic_add_chunk<VEC>(row + ch * VEC, gv[k],
                                            pt.a * (wx * wy));
        }
"""
_BWD_SKIP = "        if (!((pt.mask >> c) & 1u)) continue;\n"
# the warp's lanes that add into one chunk, summed into the lowest one
# (peers found by __match_any_sync) before one atomic; every lane of the
# warp takes part, so the corner test moves below it
_BWD_MATCH = """        const bool in_map = (pt.mask >> c) & 1u;
        if constexpr (VEC == 4 && K == 1) {
          const float s = pt.a * (wx * wy);
          float add[4] = {s * gv[0][0], s * gv[0][1], s * gv[0][2],
                          s * gv[0][3]};
          float* dst = row + ln.gl * 4;
          const int lane = threadIdx.x & 31;
          unsigned peers = __match_any_sync(
              0xffffffffu, in_map ? (unsigned long long)dst
                                  : 1ull + 2ull * lane);
          const int first = __ffs(peers) - 1;
          int rel = __popc(peers & ((1u << lane) - 1u));
          peers &= 0xfffffffeu << lane;
          while (__any_sync(0xffffffffu, peers)) {
            const int next = __ffs(peers);
            const int src = next ? next - 1 : lane;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float t = __shfl_sync(0xffffffffu, add[e], src);
              if (next) add[e] += t;
            }
            peers &= ~__ballot_sync(0xffffffffu, rel & 1);
            rel >>= 1;
          }
          if (in_map && lane == first && ln.gl < C)
            atomicAdd(reinterpret_cast<float4*>(dst),
                      make_float4(add[0], add[1], add[2], add[3]));
        } else {
          for (int k = 0; k < K; ++k)
            if (in_map && ln.gl + G * k < C)
              atomic_add_chunk<VEC>(row + (ln.gl + G * k) * VEC, gv[k],
                                    pt.a * (wx * wy));
        }
        if (!in_map) continue;
"""
# name: (kernel, [(file, old text, new text), ...])
VARIANTS = {
    "kept": ("both", []),
    "fwd_no_value_loads": ("msda_fwd", [(
        "msda_fwd.cu",
        "      load_corners<T, VEC, G, K>(vb, rs, pt, (int)(pt.mask >> 4), "
        "ln.gl, C,\n                                 v);\n",
        """#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            v[c][k][e] = __int_as_float(pt.row0 + c + e);
""")]),
    "fwd_one_chunk_a_lane": ("msda_fwd", [
        ("msda_fwd.cu", "B, Lq, M,\n                           2);",
         "B, Lq, M,\n                           1);"),
        ("msda_fwd.cu", """      case 1: MSDA_FWD_RUN(V, 1, 2); break;
      case 2: MSDA_FWD_RUN(V, 2, 2); break;
      case 4: MSDA_FWD_RUN(V, 4, 2); break;
      default: MSDA_FWD_RUN(V, 8, 2); break;""",
         """      case 1: MSDA_FWD_RUN(V, 1, 1); break;
      case 2: MSDA_FWD_RUN(V, 2, 1); break;
      case 4: MSDA_FWD_RUN(V, 4, 1); break;
      case 8: MSDA_FWD_RUN(V, 8, 1); break;
      default: MSDA_FWD_RUN(V, 16, 1); break;""")]),
    "bwd_no_atomics": ("msda_bwd", [("msda_bwd.cu", _BWD_ATOMIC, "")]),
    "bwd_16_byte_bf16_chunks": ("msda_bwd", [
        ("msda_bwd.cu", "const Shape s = shape<T, 4>(",
         "const Shape s = shape<T>("),
        ("msda_bwd.cu", "  constexpr int V = 4;\n",
         "  constexpr int V = 16 / sizeof(T);\n")]),
    "bwd_match_any": ("msda_bwd", [
        ("msda_bwd.cu", _BWD_SKIP, ""),
        ("msda_bwd.cu", _BWD_ATOMIC, _BWD_MATCH)]),
    "bwd_rotated_points": ("msda_bwd", [(
        "msda_bwd.cu",
        """    const int i = first + ln.gl;
    const bool has = ln.active && i < LP;
""",
        """    int i = first + ln.gl;
    const bool has = ln.active && i < LP;
    i += ((threadIdx.x & 31) / G) * P % LP;
    if (i >= LP) i -= LP;
""")]),
}


def build(cuda_ext, csrc):
    """{variant: ctypes library}, each built from a patched copy of csrc/
    (one nvcc per variant and kernel, all started together)."""
    out_dir = os.path.join(str(cuda_ext.BUILD_DIR), "variants")
    procs = {}
    for name, (kernel, edits) in VARIANTS.items():
        src = os.path.join(out_dir, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(csrc, src)
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"FAIL: variant {name}: the text to replace "
                                 f"is not in {fname}")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for k in (("msda_fwd", "msda_bwd") if kernel == "both"
                  else (kernel,)):
            lib = os.path.join(src, f"lib{k}.so")
            cmd = [cuda_ext.nvcc_path(), *cuda_ext.NVCC_FLAGS, "-o", lib,
                   os.path.join(src, f"{k}.cu")]
            procs[(name, k)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for (name, k), (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"FAIL: variant {name} {k} did not build:\n"
                             + log[-4000:])
        fn = getattr(ctypes.CDLL(lib), k)
        fn.argtypes = cuda_ext.SIGNATURES[k]
        fn.restype = ctypes.c_int
        libs[(name, k)] = fn
    return libs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device")
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_clock", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from vitadapter_torch.ops import cuda_ext, msda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(cuda_ext, str(cuda_ext.CSRC))
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sums = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (shapes, Lq, M, calls) in smoke.MSDA_GEOMETRIES.items():
            value, loc, attn, g = smoke.msda_inputs(shapes, Lq, M, dtype, gen)
            loc_m = smoke.msda_model_locations(
                shapes, smoke.MSDA_QUERY_GRID[name], M, 4, gen, B=2)
            B, S, _, D = value.shape
            levels, starts, _keep = msda._level_arrays(shapes)
            bf16 = int(dtype == torch.bfloat16)
            out = torch.empty((B, Lq, M * D), dtype=dtype, device="cuda")
            dvalue = torch.empty_like(value)
            acc = dvalue if dtype == torch.float32 else torch.empty(
                value.shape, device="cuda")
            for kind, lc in (("uniform", loc), ("model_shaped", loc_m),
                             ("one_cell", torch.full_like(loc, 0.5))):
                dloc, dattn = torch.empty_like(lc), torch.empty_like(attn)
                args = {"msda_fwd": (value.data_ptr(), lc.data_ptr(),
                                     attn.data_ptr(), out.data_ptr()),
                        "msda_bwd": (value.data_ptr(), lc.data_ptr(),
                                     attn.data_ptr(), g.data_ptr(),
                                     acc.data_ptr(), dvalue.data_ptr(),
                                     dloc.data_ptr(), dattn.data_ptr())}
                for (variant, k), fn in libs.items():
                    def call():
                        err = fn(*args[k], B, S, M, D, Lq, len(shapes), 4,
                                 levels, starts, bf16, stream)
                        if err:
                            raise SystemExit(f"FAIL: {variant} {k}: CUDA "
                                             f"error {err}")
                    unit = "forward" if k == "msda_fwd" else "step"
                    key = f"{variant} {k} per {unit} ({dtype}, {kind})"
                    sums[key] = sums.get(key, 0.0) + calls * smoke.time_ms(
                        call, flush, ITERS)
            del value, loc, loc_m, attn, g, out, dvalue, acc
            torch.cuda.empty_cache()
    print(json.dumps({"sums_ms": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
