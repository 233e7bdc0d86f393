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
// What bounds it on an H100: bytes and atomics. It reads fp32 locations and
// weights and the output gradient once, and adds into the level's rows of
// an fp32 d value (0.6-9.4 MB per level here), one fp32 FMA and one atomic
// per channel per in-map corner.
//
// Design: the forward's gather run backwards, as msda_bwd.cu does for all
// levels. One warp per (batch, query, head), lanes on the channels: the
// warp reads its D-wide row of g once, then for each point of the level and
// each in-map corner adds attn * w * g to the corner's value row with fp32
// atomicAdd (a warp's lanes hit one contiguous D-wide row). Edges follow the
// forward: corners off the map get nothing; a point with no corner on the
// map (also NaN and values too large for an int) is skipped. The wrapper
// zeroes the buffer, launches the levels in order and casts the sum to the
// value dtype once, as msda_pallas.py:1420-1421 does.
//
// Determinism: NOT deterministic. The fp32 atomicAdd sums the corners of
// different queries in an order that changes from run to run (the TPU
// kernel is deterministic). Checks compare with a tolerance that covers the
// reassociation.
//
// Layouts (all contiguous): loc (B, Lq, M, L, P, 2) fp32; attn
// (B, Lq, M, L, P) fp32; g (B, Lq, M, D) in the value dtype; dvalue
// (B, S, M, D) fp32. The level covers rows [start, start + H * W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// CPL: channels per lane, ceil(D / 32).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
msda_level_dv_kernel(const float* __restrict__ loc,
                     const float* __restrict__ attn, const T* __restrict__ g,
                     float* __restrict__ dvalue, int Lq, int S, int M, int D,
                     int L, int P, int level, int start, int H, int W,
                     long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  // warp = (b * Lq + q) * M + m
  const int m = (int)(warp % M);
  const long long b = warp / M / Lq;
  const long long row_stride = (long long)M * D;  // one value row s
  float* dl = dvalue + (b * S + start) * row_stride + (long long)m * D;
  const float* lp = loc + (warp * L + level) * (P * 2);
  const float* ap = attn + (warp * L + level) * P;

  float gv[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int d = lane + 32 * j;
    gv[j] = d < D ? to_float(g[warp * D + d]) : 0.f;
  }

  for (int p = 0; p < P; ++p) {
    const float a = ap[p];
    // loc * size, then - 0.5, each rounded, as the plain version and
    // JAX round them (__fmul_rn is never contracted into an FMA)
    const float x = __fmul_rn(lp[2 * p], (float)W) - 0.5f;
    const float y = __fmul_rn(lp[2 * p + 1], (float)H) - 0.5f;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
          y0f <= (float)(H - 1)))
      continue;
    const float lx = x - x0f;
    const float ly = y - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int xi = x0 + (c & 1);
      const int yi = y0 + (c >> 1);
      if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
      const float wgt =
          ((c & 1) ? lx : 1.f - lx) * ((c >> 1) ? ly : 1.f - ly) * a;
      float* row = dl + ((long long)yi * W + xi) * row_stride;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) atomicAdd(row + d, wgt * gv[j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* loc, const void* attn, const void* g,
                   float* dvalue, int B, int S, int M, int D, int Lq, int L,
                   int P, int level, int start, int H, int W,
                   cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M;
  const long long blocks = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  const T* gg = static_cast<const T*>(g);
  if (D <= 32)
    msda_level_dv_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        lc, at, gg, dvalue, Lq, S, M, D, L, P, level, start, H, W, n_warps);
  else
    msda_level_dv_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(
        lc, at, gg, dvalue, Lq, S, M, D, L, P, level, start, H, W, n_warps);
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
