// Multi-scale deformable attention (MSDA) backward, d locations and
// d attention weights of ONE level; hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_dgrid_kernel (via
// _grad_grid_pallas), which the JAX backward takes level by level when one
// head's value holds more than 8 MiB (msda_pallas.py:1411-1424). The TPU
// kernel runs three separable one-hot contractions per sample on the MXU:
// d attn = g . (Wy x wxn) V, d x = g . (Wy x wxd) V and d y = g . (Wyd x wxn) V,
// with attn * W and attn * H folded into wxd and Wyd (msda_pallas.py:1127-
// 1130), because gathers are slow on a TPU.
//
// What bounds it on an H100 (80GB HBM3, 700 W): as msda_level_fwd.cu, the
// per-(query, head) work, not the gathers: at the ratio-1.5 pixel decoder
// a launch took 0.75 ms with every point on one cell, 0.77-0.92 ms on
// model-shaped locations and 0.79-0.95 ms on uniform ones
// (vitadapter_torch/tools/msda_level_ab.py). Besides the forward's loads
// it reads the D-wide row of the output gradient g once per (batch, query,
// head), writes fp32 d loc / d attn, and sums three dot products per point
// across the team's lanes. The earlier design ran one warp per (batch,
// query, head, point), 8.4 M warps per launch at the over-line pixel
// decoder, each with warp-uniform scalar loads, a reread of g's row, one
// point's corners in flight and three 5-step shuffle reductions, at 21.7x
// its byte bound.
//
// Design (msda_level.cuh): a team of G lanes per (batch, query, head), 8
// at fp32 D 32 (4 at bf16), each lane owning a 16-byte chunk of the row
// and of g's row, which it reads once for all points. Lane t computes
// point t's geometry once and the team takes it by shuffles; each lane
// issues its chunk's four corner loads, two points at a time, before it
// uses any, and keeps its share of three sums over the corners: w * (g . v)
// for d attn and the derivative taps (+-1) * wy * (g . v) and
// wx * (+-1) * (g . v) for d x and d y (the floor convention keeps both taps
// active at integer coordinates, as msda_bwd.cu). The three sums reduce
// over the team's G lanes (3 shuffle steps at fp32 D 32, 2 at bf16) and
// lane t keeps point t's; lane t then writes that point's d attn and d loc
// = (attn * W * d x, attn * H * d y), so a team's stores fall side by side.
// Each output element has one writer and a fixed summation order:
// deterministic. A point with no corner on the map (also NaN) gets zeros.
// The weights stay fp32 where the TPU kernel rounds Wy and Wyd (which hold
// +-attn * H) to a bf16 value's dtype (msda_pallas.py:1056-1059).
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2)
// fp32; attn (B, Lq, M, L, P) fp32; g (B, Lq, M, D) in the value dtype;
// dloc, dattn fp32 like loc, attn, of which this level's slices are
// written. The level covers value rows [start, start + H * W).

#include "msda_level.cuh"

namespace {

using namespace msda_level;

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kThreads)
msda_level_dgrid_kernel(const T* __restrict__ value,
                        const float* __restrict__ loc,
                        const float* __restrict__ attn,
                        const T* __restrict__ g, float* __restrict__ dloc,
                        float* __restrict__ dattn, int Lq, int S, int M,
                        int D, int L, int P, int level, int start, int H,
                        int W) {
  const Lanes ln = lanes<G>(Lq, M);
  const int C = D / VEC;  // chunks of a row
  const long long rs = (long long)M * D;
  const T* vl = value + ((long long)ln.b * S + start) * rs + ln.m * D;
  const long long pbase = (ln.bqm * L + level) * P;

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
  for (int first = 0; first < P; first += G) {
    const int p = first + ln.gl;
    const bool has = ln.active && p < P;
    float lx = 0.f, ly = 0.f, a = 0.f;
    if (has) {
      lx = loc[2 * (pbase + p)];
      ly = loc[2 * (pbase + p) + 1];
      a = attn[pbase + p];
    }
    const Point mine = locate(lx, ly, a, has, H, W);
    // the sums of this lane's own point, p
    float o_attn = 0.f, o_x = 0.f, o_y = 0.f;
    const int n = P - first < G ? P - first : G;
    // two points' corner loads in flight
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const Point pt = broadcast(mine, ln.base + i);
      float v[4][K][VEC];
      load_corners<T, VEC, G, K>(vl, rs, pt, W, ln.gl, C, v);
      float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!((pt.mask >> c) & 1u)) continue;
        const int dx = c & 1;
        const int dy = c >> 1;
        const float wx = dx ? pt.fx : 1.f - pt.fx;
        const float wy = dy ? pt.fy : 1.f - pt.fy;
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
      if (ln.gl == i) {
        o_attn = s_attn;
        o_x = s_x;
        o_y = s_y;
      }
    }
    // lane t writes point first + t: a team's stores fall side by side
    if (has) {
      const bool ok = mine.mask != 0u;
      dattn[pbase + p] = ok ? o_attn : 0.f;
      dloc[2 * (pbase + p)] = ok ? o_x * a * (float)W : 0.f;
      dloc[2 * (pbase + p) + 1] = ok ? o_y * a * (float)H : 0.f;
    }
  }
}

template <typename T, int VEC, int G, int K>
void run(const Shape& s, const void* value, const void* loc,
         const void* attn, const void* g, float* dloc, float* dattn, int S,
         int M, int D, int Lq, int L, int P, int level, int start, int H,
         int W, cudaStream_t stream) {
  msda_level_dgrid_kernel<T, VEC, G, K><<<s.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<const T*>(g), dloc, dattn,
      Lq, S, M, D, L, P, level, start, H, W);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* g, float* dloc, float* dattn, int B, int S,
                   int M, int D, int Lq, int L, int P, int level, int start,
                   int H, int W, cudaStream_t stream) {
  const Shape s = shape<T>(D, aligned16(value) && aligned16(g), B, Lq, M);
  if (!s.fits) return cudaErrorInvalidConfiguration;
  constexpr int V = 16 / sizeof(T);
#define MSDA_LEVEL_RUN(VEC, G, K)                                          \
  run<T, VEC, G, K>(s, value, loc, attn, g, dloc, dattn, S, M, D, Lq, L, P, \
                    level, start, H, W, stream)
  if (!s.vec) {
    if (s.K == 1) MSDA_LEVEL_RUN(1, 32, 1);
    else MSDA_LEVEL_RUN(1, 32, 2);
  } else {
    switch (s.G) {
      case 1: MSDA_LEVEL_RUN(V, 1, 1); break;
      case 2: MSDA_LEVEL_RUN(V, 2, 1); break;
      case 4: MSDA_LEVEL_RUN(V, 4, 1); break;
      case 8: MSDA_LEVEL_RUN(V, 8, 1); break;
      default: MSDA_LEVEL_RUN(V, 16, 1); break;
    }
  }
#undef MSDA_LEVEL_RUN
  return cudaGetLastError();
}

}  // namespace

// Writes level `level`'s slices of dloc and dattn. Returns a cudaError_t.
extern "C" int msda_level_dgrid(const void* value, const void* loc,
                                const void* attn, const void* g, void* dloc,
                                void* dattn, int B, int S, int M, int D,
                                int Lq, int L, int P, int level, int start,
                                int H, int W, int is_bf16, void* stream) {
  if (D < 1 || D > 64 || P < 1 || L < 1 || level < 0 || level >= L ||
      H < 1 || W < 1 || start < 0 || (long long)start + (long long)H * W > S)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(dloc);
  float* da = static_cast<float*>(dattn);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, g, dl, da, B, S, M, D,
                                      Lq, L, P, level, start, H, W, s)
              : launch<float>(value, loc, attn, g, dl, da, B, S, M, D, Lq, L,
                              P, level, start, H, W, s);
  return (int)err;
}

extern "C" const char* msda_level_dgrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
