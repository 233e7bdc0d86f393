#!/usr/bin/env python3
"""Card time of variants of the port's kernels beside the kernels as they
are, on `chip_smoke.py`'s clock: the measurements behind the design notes
in the sources of the fused MSDA kernels (`csrc/msda_fwd.cu`,
`csrc/msda_bwd.cu`), the per-level d value (`csrc/msda_level_dv.cu`), the
auction (`csrc/auction.cu`) and the point sampling backward
(`csrc/point_sample_bwd.cu`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 vitadapter_torch/tools/kernel_variants.py [KERNEL ...]

KERNEL (msda_fwd, msda_bwd, msda_level_dv, auction, point_sample_bwd; all
when none is given) picks the kernels whose variants are built and timed.
Each variant is the checked-in source with a few lines replaced
(`VARIANTS`), built with the port's nvcc flags into
`vitadapter_torch/_build/variants/` and called through its C entry
point. A variant whose old text is no longer in the source (the kernel
changed since) is reported as stale and skipped; the rest still run. Two
kinds, each behind a number in its kernel's source note:
- ablations, whose results are wrong on purpose and are not checked: the
  forward without its value loads, the backward without its d value
  atomics, the per-level d value with plain stores in place of its
  atomics and with a head-major buffer (what is left is the rest of the
  kernel's work, or its writes with another address pattern); the point
  sampling backward with integer atomics on the float bits (a native
  shared-memory atomic, where fp32 needs a compare-and-swap loop), with
  plain adds and with no adds;
- designs measured and not kept: in the per-level d value one atomic per
  corner and point (no merging), heads as the fastest grid dimension (a
  block's teams take the heads of one query) and a warp's teams on
  neighbouring heads; in the auction, the bid search as a shuffle tree of
  (best, query, second) triples with one query's loads at a time, bids
  resolved without atomics (each bidder scanning the round's bids), the
  next list's appends aggregated by warp, and 128, 256 and 1024 threads;
  in the point sampling backward, every add through DSMEM (the CTA's own
  band too), no prefetch of the next point, the local add as a
  hand-written atomicCAS loop or as two atomic exchanges, a warp's lanes
  spread over the points, other thread counts and register caps, and, on
  the kept build, other launch plans (`PS_PLANS`:
  one CTA a mask, bands that each scan all the mask's points with no
  DSMEM, clusters of 2, 4 and 8).
  (The fused kernels' designs not kept were measured by
  `tools/msda_variants.py` of commit 09b25cb.)
The fused kernels are timed at the flagship's geometries
(`chip_smoke.MSDA_GEOMETRIES`, batch 2) in bf16 and fp32 and summed per
forward (msda_fwd) or train step (msda_bwd); the per-level d value in fp32
at the over-line step's shapes (`chip_smoke.LEVEL_GEOMETRIES` on
"train_overline", B 1), level by level, summed per step; both on uniform,
model-shaped and one-cell locations (as `msda_ab.py`), each d value
variant with its largest difference from `level_dv_plain`. The auction is
timed at `chip_smoke.auction_cases`, ms per launch, each variant with
whether it gives the plain version's owners and rounds. Prints the card's
name and power limit, then one JSON line. The point sampling backward is
timed in bf16 at the flagship's call (`chip_smoke.POINT_GEOMETRIES`'
"loss_pred") on sorted and unsorted points and at the over-line step's
(`chip_smoke.POINT_BWD_LAYOUTS`' "overline"), summed per step, each
variant and plan with its largest difference from
`point_sample_plain_backward`. (The design it replaced, global atomics
into an fp32 scratch and a cast, is timed by `tools/point_sample_ab.py`
on its commit.)
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
# msda_level_dv.cu's loop over a team's points, from the first point to the
# kernel's end, as kept: corners that repeat from one point to the next
# merged (a row's weights summed while consecutive points hit it, one
# atomic when a point leaves it); and as first written, one atomic per
# in-map corner and point
_DV_LOOP = """\
    for (int i = 0; i < n; ++i) {
      const Point pt = broadcast(mine, ln.base + i);
      int nr[4];    // this point's rows, -1 off the map
      float ns[4];  // and their weights attn * w_c
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dx = c & 1;
        const int dy = c >> 1;
        const float wx = dx ? pt.fx : 1.f - pt.fx;
        const float wy = dy ? pt.fy : 1.f - pt.fy;
        const bool in = (pt.mask >> c) & 1u;
        nr[c] = in ? pt.row0 + dx + dy * W : -1;
        ns[c] = in ? pt.a * (wx * wy) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool carried = false;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (prow[j] >= 0 && prow[j] == nr[c]) {
            ns[c] += pw[j];
            carried = true;
          }
        if (prow[j] >= 0 && !carried)
          add_row<VEC, G, K>(dl, rs, prow[j], gv, pw[j], ln.gl, C);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        prow[c] = nr[c];
        pw[c] = ns[c];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (prow[j] >= 0)
      add_row<VEC, G, K>(dl, rs, prow[j], gv, pw[j], ln.gl, C);
}
"""
_DV_UNMERGED = """\
    for (int i = 0; i < n; ++i) {
      const Point pt = broadcast(mine, ln.base + i);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!((pt.mask >> c) & 1u)) continue;
        const int dx = c & 1;
        const int dy = c >> 1;
        const float wx = dx ? pt.fx : 1.f - pt.fx;
        const float wy = dy ? pt.fy : 1.f - pt.fy;
        add_row<VEC, G, K>(dl, rs, pt.row0 + dx + dy * W, gv,
                           pt.a * (wx * wy), ln.gl, C);
      }
    }
  }
}
"""
_DV_LANES = "  const Lanes ln = lanes<G>(Lq, M);\n"
# the teams of a warp on neighbouring heads of one query (as many heads as
# the warp has teams, when they divide M), queries next, head groups last
_DV_HEADS_IN_WARP = """\
  // a warp's teams on the heads of one query: team t of the grid takes
  // head t % Hg of group t / Hg / Qp and query t / Hg % Qp
  Lanes ln;
  {
    const int lane = threadIdx.x & 31;
    const int Hg = M % (32 / G) == 0 ? 32 / G : 1;
    const long long Qp = (long long)gridDim.x * (kThreads / G);
    const long long t =
        ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (kThreads / G) +
        (threadIdx.x >> 5) * (32 / G) + lane / G;
    const long long r = t / Hg;
    ln.b = blockIdx.z;
    ln.m = (int)(r / Qp * Hg + t % Hg);
    ln.q = (int)(r % Qp);
    ln.bqm = ((long long)ln.b * Lq + ln.q) * M + ln.m;
    ln.gl = lane & (G - 1);
    ln.base = lane & ~(G - 1);
    ln.active = ln.q < Lq;
  }
"""
# the auction's bid search as kept: each lane's best and second value over
# its queries with kUnroll queries' loads ahead, then three redux.sync
# reductions; and one query's loads at a time merged into a (best, query,
# second) triple, then a 5-step shuffle tree of those triples
_AUCTION_SCAN = """\
      // this lane's best value v1 (lowest query on ties; its price p1) and
      // best v2 over its other queries, kUnroll queries' loads at a time
      float v1 = -INFINITY, v2 = -INFINITY, p1 = 0.f;
      int i1 = 0x7fffffff;
      for (int q0 = lane; q0 < Q; q0 += 32 * kUnroll) {
        float v[kUnroll], pq[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
          pq[u] = q < Q ? price[q] : 0.f;
          v[u] = q < Q ? row[q] - pq[u] : -INFINITY;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (v[u] > v1) {
            v2 = v1;
            v1 = v[u];
            i1 = q0 + 32 * u;
            p1 = pq[u];
          } else {
            v2 = fmaxf(v2, v[u]);
          }
        }
      }
      // the warp's best value, the lowest query that holds it and the best
      // value over the other queries: three redux.sync reductions; the
      // lane holding the best query bids
      const unsigned k1 = ordered(v1);
      const unsigned m1 = __reduce_max_sync(kAll, k1);
      const unsigned q = __reduce_min_sync(kAll, k1 == m1 ? i1 : 0xffffffffu);
      const bool mine = k1 == m1 && (unsigned)i1 == q;
      const float v2w = unordered(__reduce_max_sync(kAll, ordered(mine ? v2
                                                                       : v1)));
"""
_AUCTION_SHUFFLE_TOP2 = """\
      struct Top2 {
        float v1;
        int i1;
        float v2;
      };
      auto merge = [](Top2 a, Top2 b) {
        const bool a_first = a.v1 > b.v1 || (a.v1 == b.v1 && a.i1 < b.i1);
        return a_first ? Top2{a.v1, a.i1, fmaxf(a.v2, b.v1)}
                       : Top2{b.v1, b.i1, fmaxf(b.v2, a.v1)};
      };
      Top2 t{-INFINITY, 0x7fffffff, -INFINITY};
      for (int qq = lane; qq < Q; qq += 32)
        t = merge(t, Top2{row[qq] - price[qq], qq, -INFINITY});
      for (int o = 16; o; o >>= 1)
        t = merge(t, Top2{__shfl_xor_sync(kAll, t.v1, o),
                          __shfl_xor_sync(kAll, t.i1, o),
                          __shfl_xor_sync(kAll, t.v2, o)});
      const bool mine = lane == 0;
      const float v1 = t.v1, v2w = t.v2, p1 = price[t.i1];
      const unsigned q = t.i1;
"""
_AUCTION_BID = """\
        atomicMax(&key[q], (unsigned long long)__float_as_uint(bid) << 32 |
                               (unsigned)(G - g));
"""
_AUCTION_RESOLVE = """\
    for (int k = tid; k < n; k += kThreads) {
      const int g = free_gt[k];
      const int q = bid_q[k];
      const unsigned long long kv = key[q];
      int freed = g;
      if ((unsigned)kv == (unsigned)(G - g)) {
        freed = owner[q];
        owner[q] = g;
        price[q] = __uint_as_float((unsigned)(kv >> 32));
        key[q] = 0ull;
      }
      if (freed >= 0) next[atomicAdd(n_next, 1)] = freed;
    }
"""
# the bids kept by list slot (in the keys' space, 2 Q >= G floats here),
# each bidder finding by a scan of the round's bids whether it won
_AUCTION_BID_SLOT = """\
        reinterpret_cast<float*>(key)[k] = bid;
"""
_AUCTION_SCAN_RESOLVE = """\
    const float* bid_v = reinterpret_cast<const float*>(key);
    for (int k = tid; k < n; k += kThreads) {
      const int g = free_gt[k];
      const int q = bid_q[k];
      const float bid = bid_v[k];
      bool won = true;
      for (int j = 0; j < n; ++j) {
        const float o = bid_v[j];
        won &= !(bid_q[j] == q && (o > bid || (o == bid && free_gt[j] < g)));
      }
      int freed = g;
      if (won) {
        freed = owner[q];
        owner[q] = g;
        price[q] = bid;
      }
      if (freed >= 0) next[atomicAdd(n_next, 1)] = freed;
    }
"""
# the next list's appends aggregated by warp: one atomic per warp
_AUCTION_WARP_APPEND = """\
    for (int k0 = tid - lane; k0 < n; k0 += kThreads) {
      const int k = k0 + lane;
      int freed = -1;
      if (k < n) {
        const int g = free_gt[k];
        const int q = bid_q[k];
        const unsigned long long kv = key[q];
        freed = g;
        if ((unsigned)kv == (unsigned)(G - g)) {
          freed = owner[q];
          owner[q] = g;
          price[q] = __uint_as_float((unsigned)(kv >> 32));
          key[q] = 0ull;
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, freed >= 0);
      int at = 0;
      if (lane == 0 && m) at = atomicAdd(n_next, __popc(m));
      at = __shfl_sync(0xffffffffu, at, 0);
      if (freed >= 0) next[at + __popc(m & ((1u << lane) - 1u))] = freed;
    }
"""
# point_sample_bwd.cu's add of one corner, as kept: a shared-memory atomic
# (a compare-and-swap loop) for the CTA's own band, a DSMEM reduction for a
# neighbour's; the ablations replace the first with a native integer
# atomic on the float's bits, a plain add, or (both) nothing
_PS_LOCAL = "atomicAdd(acc + band_row * W + xi, v);"
_PS_ADD = f"""\
      if (owner == rank)
        {_PS_LOCAL}
      else
        add_remote(acc, band_row * W + xi, (unsigned)owner, v);
"""
_PS_ALL_DSMEM = (_PS_ADD, "      add_remote(acc, band_row * W + xi, "
                 "(unsigned)owner, v);\n")
_PS_INT = (_PS_LOCAL, "atomicAdd(reinterpret_cast<int*>(acc) + band_row * W "
                      "+ xi,\n                  __float_as_int(v));")
_PS_PLAIN = (_PS_LOCAL, "acc[band_row * W + xi] += v;")
_PS_NONE = (_PS_ADD,
            "      if (v == -1.2345e-30f) acc[band_row * W + xi] = v;\n")
# the points loop as kept: the next point's loads issued before this
# point's adds
_PS_PREFETCH_LOOP = """    float2 pt_next = pt;
    float gv_next = 0.f;
    if (j < p_hi) {
      pt_next = __ldg(pts + j);
      gv_next = __ldg(gn + j);
    }
    add_point(acc, pt, gv, H, W, rows, g0, g1, rank);
    pt = pt_next;
    gv = gv_next;
"""
_PS_NO_PREFETCH = (_PS_PREFETCH_LOOP, """\
    add_point(acc, pt, gv, H, W, rows, g0, g1, rank);
    if (j < p_hi) {
      pt = __ldg(pts + j);
      gv = __ldg(gn + j);
    }
""")

# the local add as a hand-written atomicCAS loop (the compiler's atomicAdd
# loop uses a compare-and-swap that reports only success), and as two
# atomic exchanges (take the cell's value out, put the sum back, carry on
# with whatever another thread left there meanwhile)
_PS_HELPERS = "__device__ __forceinline__ void store16(float* out"
_PS_CAS_LOOP = [(_PS_HELPERS, """\
__device__ __forceinline__ void cas_add(float* a, float v) {
  int* ai = reinterpret_cast<int*>(a);
  int old = *reinterpret_cast<volatile int*>(ai);
  int assumed;
  do {
    assumed = old;
    old = atomicCAS(ai, assumed, __float_as_int(__int_as_float(assumed) + v));
  } while (old != assumed);
}

""" + _PS_HELPERS), (_PS_LOCAL, "cas_add(acc + band_row * W + xi, v);")]
_PS_EXCH = [(_PS_HELPERS, """\
__device__ __forceinline__ void exch_add(float* a, float v) {
  while ((v = atomicExch(a, atomicExch(a, 0.f) + v)) != 0.f) {
  }
}

""" + _PS_HELPERS), (_PS_LOCAL, "exch_add(acc + band_row * W + xi, v);")]
# a warp's lanes on points kThreads / 32 apart (fewer lanes of a warp on
# one cell when the points are sorted; loads less coalesced)
_PS_SPREAD = ("  int i = p_lo + threadIdx.x;",
              "  int i = p_lo + (threadIdx.x & 31) * (kThreads / 32) +\n"
              "          (threadIdx.x >> 5);")


def _ps_threads(n, min_blocks):
    """point_sample_bwd with n threads a CTA and a register cap of
    min_blocks CTAs an SM."""
    return [("constexpr int kThreads = 384;",
             f"constexpr int kThreads = {n};"),
            ("constexpr int kMinBlocks = 4;",
             f"constexpr int kMinBlocks = {min_blocks};")]


# point_sample_bwd's plans beside `bwd_plan`'s, at the shapes of the
# flagship's call (128x128) and the over-line step's (448x448): name:
# (cluster, rows per CTA)
PS_PLANS = {
    128: {"one_cta_a_mask": (1, 128), "bands_scan_all_2": (1, 64),
          "bands_scan_all_4": (1, 32), "cluster_2": (2, 64),
          "cluster_4": (4, 32), "cluster_8": (8, 16)},
    448: {"bands_scan_all_8": (1, 56), "cluster_4": (4, 112),
          "cluster_8": (8, 56)},
}
KERNELS = ("msda_fwd", "msda_bwd", "msda_level_dv", "auction",
           "point_sample_bwd")
# name: (kernel or "all", [(file, old text, new text), ...])
VARIANTS = {
    "kept": ("all", []),
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
    "bwd_no_atomics": ("msda_bwd", [("msda_bwd.cu", _BWD_ATOMIC, "")]),
    "dv_no_atomics": ("msda_level_dv", [(
        "msda_level_dv.cu",
        "    if (ch < C) atomic_add_chunk<VEC>(row + ch * VEC, gv[k], w);\n",
        """    if (ch < C) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = w * gv[k][e];
      store_chunk<VEC>(row + ch * VEC, o);
    }
""")]),
    "dv_unmerged": ("msda_level_dv", [
        ("msda_level_dv.cu", _DV_LOOP, _DV_UNMERGED)]),
    "dv_head_major_buffer": ("msda_level_dv", [(
        "msda_level_dv.cu",
        "  const long long rs = (long long)M * D;\n  float* dl = dvalue + "
        "((long long)ln.b * S + start) * rs + ln.m * D;\n",
        "  const long long rs = D;\n  float* dl = dvalue + "
        "(((long long)ln.b * M + ln.m) * S + start) * D;\n")]),
    "dv_head_fastest": ("msda_level_dv", [(
        "msda_level_dv.cu", _DV_LANES,
        """\
  // heads fastest: team t of the grid takes head t % M of query t / M
  Lanes ln;
  {
    const int lane = threadIdx.x & 31;
    const long long t =
        ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (kThreads / G) +
        (threadIdx.x >> 5) * (32 / G) + lane / G;
    ln.b = blockIdx.z;
    ln.m = (int)(t % M);
    ln.q = (int)(t / M);
    ln.bqm = ((long long)ln.b * Lq + ln.q) * M + ln.m;
    ln.gl = lane & (G - 1);
    ln.base = lane & ~(G - 1);
    ln.active = ln.q < Lq;
  }
""")]),
    "dv_heads_in_warp": ("msda_level_dv", [
        ("msda_level_dv.cu", _DV_LANES, _DV_HEADS_IN_WARP)]),
    "auction_shuffle_top2": ("auction", [
        ("auction.cu", _AUCTION_SCAN, _AUCTION_SHUFFLE_TOP2)]),
    "auction_bid_scan": ("auction", [
        ("auction.cu", _AUCTION_BID, _AUCTION_BID_SLOT),
        ("auction.cu", _AUCTION_RESOLVE, _AUCTION_SCAN_RESOLVE)]),
    "auction_warp_append": ("auction", [
        ("auction.cu", _AUCTION_RESOLVE, _AUCTION_WARP_APPEND)]),
    "auction_256_threads": ("auction", [(
        "auction.cu", "constexpr int kThreads = 512;",
        "constexpr int kThreads = 256;")]),
    "auction_128_threads": ("auction", [(
        "auction.cu", "constexpr int kThreads = 512;",
        "constexpr int kThreads = 128;")]),
    "auction_1024_threads": ("auction", [(
        "auction.cu", "constexpr int kThreads = 512;",
        "constexpr int kThreads = 1024;")]),
    **{name: ("point_sample_bwd",
              [("point_sample_bwd.cu", old, new) for old, new in edits])
       for name, edits in (
           ("ps_all_dsmem", [_PS_ALL_DSMEM]),
           ("ps_no_prefetch", [_PS_NO_PREFETCH]),
           ("ps_cas_loop", _PS_CAS_LOOP),
           ("ps_exchange_add", _PS_EXCH),
           ("ps_spread_lanes", [_PS_SPREAD]),
           ("ps_128_threads", _ps_threads(128, 12)),
           ("ps_256_threads", _ps_threads(256, 6)),
           ("ps_512_threads", _ps_threads(512, 3)),
           ("ps_512_threads_32_registers", _ps_threads(512, 4)),
           ("ps_1024_threads_32_registers", _ps_threads(1024, 2)),
           ("ps_int_atomics", [_PS_INT]),
           ("ps_no_atomics", [_PS_PLAIN]),
           ("ps_no_adds", [_PS_NONE]))},
}


def build(cuda_ext, csrc, kernels):
    """{(variant, kernel): C entry point} of the variants of `kernels`,
    each built from a patched copy of csrc/ (one nvcc per variant and
    kernel, all started together); "kept" builds every kernel of
    `kernels` as it is. A variant whose old text is not found is left
    out, with a line that says so."""
    out_dir = os.path.join(str(cuda_ext.BUILD_DIR), "variants")
    procs = {}
    for name, (kernel, edits) in VARIANTS.items():
        built = [k for k in kernels if kernel in ("all", k)]
        if not built:
            continue
        src = os.path.join(out_dir, name)
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(csrc, src)
        stale = [f for f, old, _ in edits
                 if old not in open(os.path.join(src, f)).read()]
        if stale:
            print(f"variant {name} is stale (its old text is not in "
                  f"{', '.join(stale)}): left out", flush=True)
            continue
        for fname, old, new in edits:
            path = os.path.join(src, fname)
            text = open(path).read()
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for k in built:
            lib = os.path.join(src, f"lib{k}.so")
            cmd = [cuda_ext.nvcc_path(), *cuda_ext.NVCC_FLAGS, "-o", lib,
                   os.path.join(src, f"{k}.cu")]
            procs[(name, k)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for (name, k), (proc, lib) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if k == "point_sample_bwd" and ("registers" in line
                                            or "spill" in line):
                print(f"{name} {k}: {line.strip()}", flush=True)
        if proc.returncode:
            raise SystemExit(f"FAIL: variant {name} {k} did not build:\n"
                             + log[-4000:])
        fn = getattr(ctypes.CDLL(lib), k)
        fn.argtypes = cuda_ext.SIGNATURES[k]
        fn.restype = ctypes.c_int
        libs[(name, k)] = fn
    return libs


def checked(variant, k, err):
    if err:
        raise SystemExit(f"FAIL: {variant} {k}: CUDA error {err}")


def time_fused(smoke, msda, libs, flush, gen, sums):
    """The fused kernels' variants, summed per forward or step."""
    stream = torch.cuda.current_stream().cuda_stream
    fused = {key: fn for key, fn in libs.items()
             if key[1] in ("msda_fwd", "msda_bwd")}
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
                for (variant, k), fn in fused.items():
                    def call():
                        checked(variant, k, fn(
                            *args[k], B, S, M, D, Lq, len(shapes), 4, levels,
                            starts, bf16, stream))
                    unit = "forward" if k == "msda_fwd" else "step"
                    key = f"{variant} {k} per {unit} ({dtype}, {kind})"
                    sums[key] = sums.get(key, 0.0) + calls * smoke.time_ms(
                        call, flush, ITERS)
            del value, loc, loc_m, attn, g, out, dvalue, acc
            torch.cuda.empty_cache()


def time_level_dv(smoke, msda, libs, flush, gen, sums):
    """The per-level d value's variants, level by level at the over-line
    step's shapes, summed per step; and each variant's largest difference
    from `level_dv_plain` over the largest entry of the plain result (an
    ablation's is wrong on purpose)."""
    stream = torch.cuda.current_stream().cuda_stream
    dv_libs = {key: fn for key, fn in libs.items()
               if key[1] == "msda_level_dv"}
    for name, (shapes, Lq, M, _, on_path) in smoke.LEVEL_GEOMETRIES.items():
        if not on_path or on_path[0] != "train_overline":
            continue
        calls = on_path[1]
        value, loc, attn, g = smoke.msda_inputs(shapes, Lq, M, torch.float32,
                                                gen, B=1)
        loc_m = smoke.msda_model_locations(
            shapes, smoke.LEVEL_QUERY_GRID[name], M, 4, gen)
        B, S, _, D = value.shape
        dvalue = torch.zeros(value.shape, device="cuda")
        starts = msda.level_start_index(shapes)
        for kind, lc in (("uniform", loc), ("model_shaped", loc_m),
                         ("one_cell", torch.full_like(loc, 0.5))):
            for lvl, (H, W) in enumerate(shapes):
                ref = msda.level_dv_plain(lc[:, :, :, lvl], attn[:, :, :, lvl],
                                          g.reshape(B, Lq, M, D), H, W)
                rows = slice(starts[lvl], starts[lvl] + H * W)
                for (variant, k), fn in dv_libs.items():
                    def call():
                        checked(variant, k, fn(
                            lc.data_ptr(), attn.data_ptr(), g.data_ptr(),
                            dvalue.data_ptr(), B, S, M, D, Lq, len(shapes),
                            4, lvl, starts[lvl], H, W, 0, stream))
                    dvalue.zero_()
                    call()
                    err = float((dvalue[:, rows] - ref).abs().max()
                                / ref.abs().max())
                    key = f"{variant} {k} error / max"
                    sums[key] = max(sums.get(key, 0.0), err)
                    key = f"{variant} {k} per over-line step ({kind})"
                    sums[key] = sums.get(key, 0.0) + calls * smoke.time_ms(
                        call, flush, ITERS)
                del ref
        del value, loc, loc_m, attn, g, dvalue
        torch.cuda.empty_cache()


def time_auction(smoke, mt, libs, flush, gen, sums):
    """The auction's variants, ms per launch at `auction_cases`, and
    whether each gives the plain version's owners and rounds."""
    stream = torch.cuda.current_stream().cuda_stream
    for case, (cost, n_valid) in smoke.auction_cases(gen).items():
        B, Q, G = cost.shape
        nv = n_valid.to(torch.int32)
        owner = torch.empty((B, Q), dtype=torch.int32, device="cuda")
        iters = torch.empty(B, dtype=torch.int32, device="cuda")
        ref, ref_iters = mt.auction_assign_plain(cost, n_valid)
        for (variant, k), fn in libs.items():
            if k != "auction":
                continue

            def call():
                checked(variant, k, fn(
                    cost.data_ptr(), nv.data_ptr(), owner.data_ptr(),
                    iters.data_ptr(), B, Q, G, mt.EPS_DIV, mt.MAX_ITERS,
                    stream))
            call()
            sums[f"{variant} auction ({case}) same as plain"] = bool(
                (owner.long() == ref).all()) and bool(
                (iters.long() == ref_iters).all())
            sums[f"{variant} auction ({case})"] = smoke.time_ms(call, flush,
                                                                ITERS)


def time_point_sample_bwd(smoke, ps, libs, flush, gen, sums):
    """point_sample_bwd's variants (with `bwd_plan`'s plan) and the kept
    kernel on `PS_PLANS`, bf16 masks, at the flagship's call on sorted and
    unsorted points and at the over-line step's on sorted points, summed
    per step (10 calls each); and each one's largest difference from
    `point_sample_plain_backward` over the largest entry of the plain
    result (an ablation's is wrong on purpose)."""
    stream = torch.cuda.current_stream().cuda_stream
    bwd = {key: fn for key, fn in libs.items() if key[1] == "point_sample_bwd"}
    N, H, W, P, _, calls, _ = smoke.POINT_GEOMETRIES["loss_pred"]
    N2, H2, W2, P2, _, _ = smoke.POINT_BWD_LAYOUTS["overline"]
    for shape, sort in (((N, H, W, P), True), ((N, H, W, P), False),
                        ((N2, H2, W2, P2), True)):
        N, H, W, P = shape
        masks = torch.randn(N, H, W, generator=gen, device="cuda") \
            .bfloat16()
        pts = torch.rand(N, P, 2, generator=gen, device="cuda")
        if sort:
            pts = ps.sort_points_by_y(pts)
        g = torch.randn(N, P, generator=gen, device="cuda")
        ref = ps.point_sample_plain_backward(masks, pts, g).float()
        out = torch.empty_like(masks)
        plan = ps.bwd_plan(H, W)
        plans = {"bwd_plan": (plan.cluster, plan.rows), **PS_PLANS[H]}
        runs = [(f"{v} plan {name}", fn, c, r) for (v, _), fn in bwd.items()
                for name, (c, r) in plans.items()]
        where = (f"{H}x{W}, {'sorted' if sort else 'unsorted'} "
                 f"({N} masks, {P} points)")
        for variant, fn, cluster, rows in runs:
            def call():
                checked(variant, "point_sample_bwd", fn(
                    pts.data_ptr(), g.data_ptr(), out.data_ptr(), N, H, W, P,
                    1, cluster, rows, stream))
            out.fill_(float("nan"))
            call()
            sums[f"{variant} point_sample_bwd error / max ({where})"] = float(
                (out.float() - ref).abs().max() / ref.abs().max())
            sums[f"{variant} point_sample_bwd per step ({where})"] = \
                calls * smoke.time_ms(call, flush, ITERS)
        del masks, pts, g, ref, out
        torch.cuda.empty_cache()


def main(argv=None):
    kernels = (sys.argv[1:] if argv is None else argv) or list(KERNELS)
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device")
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_clock", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from vitadapter_torch.ops import cuda_ext, matching, msda
    from vitadapter_torch.ops import point_sample

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    libs = build(cuda_ext, str(cuda_ext.CSRC), kernels)
    gen = torch.Generator("cuda").manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    sums = {}
    if {"msda_fwd", "msda_bwd"} & set(kernels):
        time_fused(smoke, msda, libs, flush, gen, sums)
    if "msda_level_dv" in kernels:
        time_level_dv(smoke, msda, libs, flush, gen, sums)
    if "auction" in kernels:
        time_auction(smoke, matching, libs, flush, gen, sums)
    if "point_sample_bwd" in kernels:
        time_point_sample_bwd(smoke, point_sample, libs, flush, gen, sums)
    print(json.dumps({"results": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
