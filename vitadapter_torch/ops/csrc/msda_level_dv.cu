// Multi-scale deformable attention (MSDA) backward, d value of ONE level,
// added into an fp32 buffer; hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_dv_kernel (via
// _grad_value_pallas), which the JAX backward takes level by level when one
// head's value holds more than 8 MiB (msda_pallas.py:1411-1421). The TPU
// kernel contracts the transposed one-hot row matrix with the x-weighted,
// D-repeated output gradient on the MXU (dV += Wy^T @ (WxD * repeat(g))),
// carrying the sum across query tiles of a sequential grid: scatter-free
// and deterministic, because a TPU scatter is slow.
//
// What bounds it on an H100 (80GB HBM3, 700 W): the payload of its adds
// in L2, not HBM and not the atomic instructions. Its byte bound (fp32
// locations, weights and g read once, the level's d value rows written
// once) is 2.76 ms per over-line train step (30 launches), but each in-map
// corner adds a whole D-wide fp32 row, 4 B * D: about 56 GB per step on
// uniform locations and 79 GB on model-shaped ones (chip_smoke.py's log),
// which L2 takes at 2.8 and 3.2 TB/s. The first design (one warp per
// (batch, query, head), every lane computing every point's geometry, 32
// scalar atomics per corner) took 38.1 ms per step on uniform locations
// and 30.9 on model-shaped ones (vitadapter_torch/tools/msda_level_ab.py).
// Per step now, uniform / model-shaped / every point on one cell
// (vitadapter_torch/tools/kernel_variants.py): 20.7 / 24.5 / 91.4 ms; with
// plain stores in place of the atomics (an ablation) 21.8 / 25.7 / 24.3:
// the same bytes written take as long as the atomics, except where every
// add lands on four rows a head. Fewer bytes added, not fewer
// instructions, is what would make it faster.
//
// Design (msda_level.cuh, as msda_bwd.cu's d value): a team of G lanes per
// (batch, query, head), each lane owning 4-element chunks of g's row (one
// 16-byte fp32 or 8-byte bf16 load), which it reads once for all points:
// at D 32, 8 lanes in either dtype. The grid is (query tiles, heads,
// batch), so the blocks in flight add into one head's rows, which stay in
// L2. Lane t computes point t's geometry once (`locate`) and the team
// takes it by `broadcast`. A point's in-map corner c of weight w_c adds
// attn * w_c * g to the corner's row; the team keeps the last point's four
// rows and summed weights, so a row that the next point hits too carries
// its weight on, and a row is added, by one vector atomic a lane
// (`atomic_add_chunk`, red.global.add.v4.f32, a team's lanes on adjacent
// 16-byte pieces of the row), only when a point leaves it and at the end.
// That merges the corners a query's consecutive points share (model-shaped
// points lie about a pixel apart): with one atomic per corner and point
// the times were 20.7 / 27.8 / 368.2 ms. Rows with D % 4 != 0 and
// pointers off 16-byte alignment take the scalar instantiation (G = 32,
// one element a lane). Edges follow the forward: corners off the map get
// nothing; a point with no corner on the map (also NaN and values too
// large for an int) is skipped. The wrapper zeroes the buffer, launches
// the levels in order and casts the sum to the value dtype once, as
// msda_pallas.py:1420-1421 does.
// Measured and not kept (kernel_variants.py, uniform / model-shaped / one
// cell): heads as the fastest grid dimension, 35.8 / 25.0 / 19.8 (the
// blocks in flight add into every head's rows, 32 times the lines); a
// warp's teams on neighbouring heads of one query, 22.2 / 26.3 / 63.6; a
// head-major buffer (an ablation of the rows' 4 KB stride), 20.0 / 24.6.
//
// Determinism: NOT deterministic. The fp32 atomics sum the corners of
// different queries in an order that changes from run to run (the TPU
// kernel is deterministic). Checks compare with a tolerance that covers the
// reassociation.
//
// Layouts (all contiguous): loc (B, Lq, M, L, P, 2) fp32; attn
// (B, Lq, M, L, P) fp32; g (B, Lq, M, D) in the value dtype; dvalue
// (B, S, M, D) fp32. The level covers rows [start, start + H * W).

#include "msda_level.cuh"

namespace {

using namespace msda_level;

// Adds w * g to value row `cell` of the level: this lane's chunks of g
// (gv), one vector atomic each.
template <int VEC, int G, int K>
__device__ __forceinline__ void add_row(float* dl, long long rs, int cell,
                                        const float (&gv)[K][VEC], float w,
                                        int gl, int C) {
  float* row = dl + (long long)cell * rs;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = gl + G * k;
    if (ch < C) atomic_add_chunk<VEC>(row + ch * VEC, gv[k], w);
  }
}

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kThreads)
msda_level_dv_kernel(const float* __restrict__ loc,
                     const float* __restrict__ attn, const T* __restrict__ g,
                     float* __restrict__ dvalue, int Lq, int S, int M, int D,
                     int L, int P, int level, int start, int H, int W) {
  const Lanes ln = lanes<G>(Lq, M);
  const int C = D / VEC;  // chunks of a row
  const long long rs = (long long)M * D;
  float* dl = dvalue + ((long long)ln.b * S + start) * rs + ln.m * D;
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

  // the rows the last point hit and their summed weights: a row that the
  // next point hits too carries its weight on to it, a row the next point
  // leaves is added then (and every row at the end)
  int prow[4] = {-1, -1, -1, -1};
  float pw[4] = {0.f, 0.f, 0.f, 0.f};
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
    const int n = P - first < G ? P - first : G;
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

template <typename T, int VEC, int G, int K>
void run(const Shape& s, const void* loc, const void* attn, const void* g,
         float* dvalue, int S, int M, int D, int Lq, int L, int P, int level,
         int start, int H, int W, cudaStream_t stream) {
  msda_level_dv_kernel<T, VEC, G, K><<<s.grid, kThreads, 0, stream>>>(
      static_cast<const float*>(loc), static_cast<const float*>(attn),
      static_cast<const T*>(g), dvalue, Lq, S, M, D, L, P, level, start, H,
      W);
}

template <typename T>
cudaError_t launch(const void* loc, const void* attn, const void* g,
                   float* dvalue, int B, int S, int M, int D, int Lq, int L,
                   int P, int level, int start, int H, int W,
                   cudaStream_t stream) {
  // four elements a chunk in both dtypes (8-byte bf16 loads), so a lane's
  // atomic covers its whole chunk and a team's lanes cover adjacent bytes
  const Shape s =
      shape<T, 4>(D, aligned16(g) && aligned16(dvalue), B, Lq, M);
  if (!s.fits) return cudaErrorInvalidConfiguration;
  constexpr int V = 4;
#define MSDA_LEVEL_DV_RUN(VEC, G, K)                                        \
  run<T, VEC, G, K>(s, loc, attn, g, dvalue, S, M, D, Lq, L, P, level, start, \
                    H, W, stream)
  if (!s.vec) {
    if (s.K == 1) MSDA_LEVEL_DV_RUN(1, 32, 1);
    else MSDA_LEVEL_DV_RUN(1, 32, 2);
  } else {
    switch (s.G) {
      case 1: MSDA_LEVEL_DV_RUN(V, 1, 1); break;
      case 2: MSDA_LEVEL_DV_RUN(V, 2, 1); break;
      case 4: MSDA_LEVEL_DV_RUN(V, 4, 1); break;
      case 8: MSDA_LEVEL_DV_RUN(V, 8, 1); break;
      default: MSDA_LEVEL_DV_RUN(V, 16, 1); break;
    }
  }
#undef MSDA_LEVEL_DV_RUN
  return cudaGetLastError();
}

}  // namespace

// Adds level `level`'s d value into rows [start, start + H * W) of the fp32
// buffer `dvalue`; `is_bf16` gives g's dtype. Returns a cudaError_t.
extern "C" int msda_level_dv(const void* loc, const void* attn, const void* g,
                             void* dvalue, int B, int S, int M, int D, int Lq,
                             int L, int P, int level, int start, int H, int W,
                             int is_bf16, void* stream) {
  if (D < 1 || D > 64 || P < 1 || L < 1 || level < 0 || level >= L ||
      H < 1 || W < 1 || start < 0 || (long long)start + (long long)H * W > S)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dv = static_cast<float*>(dvalue);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(loc, attn, g, dv, B, S, M, D, Lq, L, P,
                                      level, start, H, W, s)
              : launch<float>(loc, attn, g, dv, B, S, M, D, Lq, L, P, level,
                              start, H, W, s);
  return (int)err;
}

extern "C" const char* msda_level_dv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
