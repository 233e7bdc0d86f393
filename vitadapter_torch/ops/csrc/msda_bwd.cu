// Multi-scale deformable attention (MSDA) backward, all levels in one
// launch: d value, d locations and d attention weights; hand-written for
// Hopper (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_bwd_ml_kernel (via _backward_ml
// and _bwd). The TPU kernel rebuilds the relu one-hot interpolation matrices
// of the forward and contracts them on the MXU: grad_value as C^T @ g
// accumulated over sequential query tiles, and the per-point reductions for
// the attention weights and the locations.
//
// What bounds it on an H100 (80GB HBM3, 700 W): the atomics that sum
// d value, then the per-(query, head) work. The bound (the value rows the
// points touch, fp32 locations, weights and the output gradient read once,
// d value, d loc and d attn written once) is 0.049 ms at the flagship's
// bf16 pixel decoder; the first design (one warp per (batch, query, head),
// lanes on the channels, every lane computing every point's geometry, 32
// scalar atomics per corner and three 5-step warp reductions per point,
// the level table read from local memory) took 1.386 ms there. Per
// flagship bf16 train step now (vitadapter_torch/tools/msda_variants.py at
// commit 09b25cb, whose ablations tools/kernel_variants.py carries on):
// 4.79 ms on uniform locations and 5.65 on model-shaped ones; a variant
// without the atomics takes 3.04 and 2.94, so they add 1.7 and 2.7 ms, the
// more where neighbouring queries and a query's own points share corners
// (with every point on one cell, 30.3 ms: each corner's adds queue on one
// line).
//
// Design (msda_level.cuh, as msda_fwd.cu): a team of G lanes per (batch,
// query, head), each lane owning a chunk of four elements of the value row
// and of g's row (one 16-byte fp32 or 8-byte bf16 load), which it reads
// once for all points: at D 32, 8 lanes in either dtype. Lane t computes
// point t's geometry once (`locate_level`) and the team takes it by
// shuffles; each lane issues its chunk's four corner loads, two points at
// a time, before it uses any. Per in-map corner c of weight w_c, each lane:
// - adds attn * w_c * g to its chunk of the corner's fp32 d value row with
//   one vector atomic (`atomic_add_chunk`, red.global.add.v4.f32), where
//   the first design issued 32 scalar ones a corner; a team's lanes cover
//   adjacent 16-byte pieces of the row (with 16-byte bf16 chunks a lane
//   adds 32 bytes by two atomics, so each instruction's lanes are 32 bytes
//   apart and fill half of each sector: 8.23 ms per step on uniform
//   locations);
// - keeps its share of three sums over the corners: w_c (g . v_c) for
//   d attn and the derivative taps (+-1) wy (g . v_c) and wx (+-1) (g . v_c)
//   for d x and d y (the floor convention keeps both taps active at
//   integer coordinates, msda_pallas.py:1249-1256).
// The three sums reduce over the team's G lanes by xor shuffles (3 steps
// at D 32) in a fixed order and lane t keeps point t's; lane t then writes
// that point's d attn and d loc = (attn * W * d x, attn * H * d y)
// (msda_pallas.py:1401-1406), so a team's stores fall side by side. A
// point with no corner on the map (also NaN) gets zeros. The wrapper's
// fp32 scratch is zeroed first and, for a bf16 value, cast to bf16 after,
// eight elements a thread.
// Measured and not kept (msda_variants.py at 09b25cb, per bf16 step, uniform /
// model-shaped locations): a warp's adds to one chunk combined by
// __match_any_sync before one atomic, 17.57 / 16.71 ms (8.92 with every
// point on one cell); each team's points rotated by a level, so that the
// teams of a warp start on different levels, 4.73 / 5.65.
//
// Determinism: d loc and d attn have one writer and a fixed summation
// order: deterministic. d value is NOT: the fp32 atomics sum the corners of
// different queries in an order that changes from run to run (the TPU
// kernel's contraction is deterministic). Checks compare it with a
// tolerance that covers the reassociation.
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2) fp32;
// attn (B, Lq, M, L, P) fp32; g (B, Lq, M, D) in the value dtype; dvalue_f32
// (B, S, M, D) fp32 scratch (zeroed here); dvalue (B, S, M, D) in the value
// dtype (may alias dvalue_f32 for fp32); dloc, dattn fp32 like loc, attn.

#include "msda_level.cuh"

namespace {

using namespace msda_level;

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, const T* __restrict__ g,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ dattn, int Lq, int S, int M, int D, int L,
                int P, LevelTable table) {
  __shared__ int4 levels[kMaxLevels];
  stage_levels(table, levels);
  const Lanes ln = lanes<G>(Lq, M);
  const int C = D / VEC;  // chunks of a row
  const int LP = L * P;
  const long long rs = (long long)M * D;
  const long long vb_off = (long long)ln.b * S * rs + ln.m * D;
  const T* vb = value + vb_off;
  float* dvb = dvalue + vb_off;
  const long long pbase = ln.bqm * LP;
  const float* lp = loc + 2 * pbase;
  const float* ap = attn + pbase;

  // this lane's chunks of g's row, read once for all points
  float gv[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = ln.gl + G * k;
    if (ln.active && ch < C) {
      load_chunk<VEC>(g + ln.bqm * D + ch * VEC, gv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) gv[k][e] = 0.f;
    }
  }

  // rounds of G points, one point's geometry per lane; the same trip
  // counts in every lane, so the shuffles see the whole warp
  for (int first = 0; first < LP; first += G) {
    const int i = first + ln.gl;
    const bool has = ln.active && i < LP;
    int H, W;
    const Point mine = locate_level(lp, ap, i, P, has, levels, H, W);
    // the sums of this lane's own point, i
    float o_attn = 0.f, o_x = 0.f, o_y = 0.f;
    const int n = LP - first < G ? LP - first : G;
    // two points' corner loads in flight
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const Point pt = broadcast(mine, ln.base + j);
      const int Wp = (int)(pt.mask >> 4);
      float v[4][K][VEC];
      load_corners<T, VEC, G, K>(vb, rs, pt, Wp, ln.gl, C, v);
      float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!((pt.mask >> c) & 1u)) continue;
        const int dx = c & 1;
        const int dy = c >> 1;
        const float wx = dx ? pt.fx : 1.f - pt.fx;
        const float wy = dy ? pt.fy : 1.f - pt.fy;
        float* row = dvb + (long long)(pt.row0 + dx + dy * Wp) * rs;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int ch = ln.gl + G * k;
          if (ch < C) atomic_add_chunk<VEC>(row + ch * VEC, gv[k],
                                            pt.a * (wx * wy));
        }
        float dot = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot = fmaf(gv[k][e], v[c][k][e], dot);
        s_attn = fmaf(wx * wy, dot, s_attn);
        s_x = fmaf(dx ? wy : -wy, dot, s_x);
        s_y = fmaf(dy ? wx : -wx, dot, s_y);
      }
      // the team's lanes: a fixed tree, so a fixed order
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        s_attn += __shfl_xor_sync(0xffffffffu, s_attn, off);
        s_x += __shfl_xor_sync(0xffffffffu, s_x, off);
        s_y += __shfl_xor_sync(0xffffffffu, s_y, off);
      }
      if (ln.gl == j) {
        o_attn = s_attn;
        o_x = s_x;
        o_y = s_y;
      }
    }
    // lane t writes point first + t: a team's stores fall side by side
    if (has) {
      const bool ok = (mine.mask & 15u) != 0u;
      dattn[pbase + i] = ok ? o_attn : 0.f;
      dloc[2 * (pbase + i)] = ok ? o_x * mine.a * (float)W : 0.f;
      dloc[2 * (pbase + i) + 1] = ok ? o_y * mine.a * (float)H : 0.f;
    }
  }
}

// The fp32 d value rounded to bf16, eight elements a thread (two 16-byte
// loads, one 16-byte store) when both buffers are 16-byte aligned, else
// one.
template <int E>
__global__ void cast_to_bf16(const float* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, long long n) {
  const long long i = E * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (E == 8 && i + 8 <= n) {
    float f[8];
    load_chunk<4>(src + i, f);
    load_chunk<4>(src + i + 4, f + 4);
    store_chunk<8>(dst + i, f);
  } else {
    for (long long j = i; j < i + E && j < n; ++j)
      dst[j] = __float2bfloat16(src[j]);
  }
}

template <typename T, int VEC, int G, int K>
void run(const Shape& s, const void* value, const void* loc,
         const void* attn, const void* g, float* dvalue, float* dloc,
         float* dattn, int S, int M, int D, int Lq, int L, int P,
         const LevelTable& table, cudaStream_t stream) {
  msda_bwd_kernel<T, VEC, G, K><<<s.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(g), dvalue, dloc,
      dattn, Lq, S, M, D, L, P, table);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* g, float* dvalue_f32, float* dloc,
                   float* dattn, int B, int S, int M, int D, int Lq, int L,
                   int P, const LevelTable& table, cudaStream_t stream) {
  // four elements a chunk in both dtypes (8-byte bf16 loads), so a lane's
  // atomic covers its whole chunk and a team's lanes cover adjacent bytes
  const Shape s = shape<T, 4>(D, aligned16(value) && aligned16(g) &&
                                     aligned16(dvalue_f32),
                              B, Lq, M);
  if (!s.fits) return cudaErrorInvalidConfiguration;
  constexpr int V = 4;
#define MSDA_BWD_RUN(VEC, G, K)                                          \
  run<T, VEC, G, K>(s, value, loc, attn, g, dvalue_f32, dloc, dattn, S, M, \
                    D, Lq, L, P, table, stream)
  if (!s.vec) {
    if (s.K == 1) MSDA_BWD_RUN(1, 32, 1);
    else MSDA_BWD_RUN(1, 32, 2);
  } else {
    switch (s.G) {
      case 1: MSDA_BWD_RUN(V, 1, 1); break;
      case 2: MSDA_BWD_RUN(V, 2, 1); break;
      case 4: MSDA_BWD_RUN(V, 4, 1); break;
      case 8: MSDA_BWD_RUN(V, 8, 1); break;
      default: MSDA_BWD_RUN(V, 16, 1); break;
    }
  }
#undef MSDA_BWD_RUN
  return cudaGetLastError();
}

}  // namespace

// shapes: 2 * L ints (H_l, W_l); starts: L ints. dvalue_f32 is an fp32
// scratch of the value's size (the output itself when the value is fp32).
// Returns a cudaError_t.
extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* g, void* dvalue_f32, void* dvalue,
                        void* dloc, void* dattn, int B, int S, int M, int D,
                        int Lq, int L, int P, const int* shapes,
                        const int* starts, int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1 || B < 0 ||
      S < 0 || M < 0 || Lq < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_value = (long long)B * S * M * D;
  cudaError_t err =
      cudaMemsetAsync(dvalue_f32, 0, sizeof(float) * n_value, s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * Lq * M > 0) {
    LevelTable table = {};
    for (int l = 0; l < L; ++l) {
      table.h[l] = shapes[2 * l];
      table.w[l] = shapes[2 * l + 1];
      table.start[l] = starts[l];
    }
    float* dv = static_cast<float*>(dvalue_f32);
    float* dl = static_cast<float*>(dloc);
    float* da = static_cast<float*>(dattn);
    err = is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, g, dv, dl, da, B,
                                          S, M, D, Lq, L, P, table, s)
                  : launch<float>(value, loc, attn, g, dv, dl, da, B, S, M,
                                  D, Lq, L, P, table, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (is_bf16 && n_value > 0) {
    const float* src = static_cast<const float*>(dvalue_f32);
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(dvalue);
    const bool vec = aligned16(src) && aligned16(dst);
    const long long per_block = 256LL * (vec ? 8 : 1);
    const long long blocks = (n_value + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (vec)
      cast_to_bf16<8><<<(unsigned)blocks, 256, 0, s>>>(src, dst, n_value);
    else
      cast_to_bf16<1><<<(unsigned)blocks, 256, 0, s>>>(src, dst, n_value);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* msda_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
