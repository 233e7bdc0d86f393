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
// What bounds it on an H100: bytes. It reads the level's value rows (into
// L2, shared by neighbouring samples), the fp32 locations and weights and
// the output gradient once, and writes fp32 d loc / d attn; one fp32 FMA per
// channel per in-map corner for the dot product, far under the CUDA cores'
// ridge of about 20 FLOP per byte.
//
// Design: a direct gather, one warp per (batch, query, head, point), lanes
// on the channels. The warp reads its D-wide row of g and, for each in-map
// corner, the corner's value row; each lane keeps its share of three sums
// over the corners: w * (g . v) for d attn and the derivative taps
// (+-1) * wy * (g . v) and wx * (+-1) * (g . v) for d x and d y (the floor
// convention keeps both taps active at integer coordinates, as
// msda_bwd.cu). Three warp reductions finish them; lane 0 writes the point's
// d attn and d loc = (attn * W * d x, attn * H * d y). Each output element
// has one writer and a fixed summation order: deterministic. A point with no
// corner on the map (also NaN and values too large for an int) gets zeros.
// The weights stay fp32 where the TPU kernel rounds Wy and Wyd (which hold
// +-attn * H) to a bf16 value's dtype (msda_pallas.py:1056-1059).
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2)
// fp32; attn (B, Lq, M, L, P) fp32; g (B, Lq, M, D) in the value dtype;
// dloc, dattn fp32 like loc, attn, of which this level's slices are
// written. The level covers value rows [start, start + H * W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// CPL: channels per lane, ceil(D / 32).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
msda_level_dgrid_kernel(const T* __restrict__ value,
                        const float* __restrict__ loc,
                        const float* __restrict__ attn,
                        const T* __restrict__ g, float* __restrict__ dloc,
                        float* __restrict__ dattn, int Lq, int S, int M,
                        int D, int L, int P, int level, int start, int H,
                        int W, long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  // warp = ((b * Lq + q) * M + m) * P + p
  const int p = (int)(warp % P);
  const long long bqm = warp / P;
  const int m = (int)(bqm % M);
  const long long b = bqm / M / Lq;
  const long long row_stride = (long long)M * D;  // one value row s
  const T* vl = value + (b * S + start) * row_stride + (long long)m * D;
  const long long i = (bqm * L + level) * P + p;  // this point in attn
  const float a = attn[i];
  // loc * size, then - 0.5, each rounded, as the plain version and
  // JAX round them (__fmul_rn is never contracted into an FMA)
  const float x = __fmul_rn(loc[2 * i], (float)W) - 0.5f;
  const float y = __fmul_rn(loc[2 * i + 1], (float)H) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
        y0f <= (float)(H - 1))) {
    if (lane == 0) {
      dattn[i] = 0.f;
      dloc[2 * i] = 0.f;
      dloc[2 * i + 1] = 0.f;
    }
    return;
  }
  const float lx = x - x0f;
  const float ly = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;

  float gv[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int d = lane + 32 * j;
    gv[j] = d < D ? to_float(g[bqm * D + d]) : 0.f;
  }

  float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dx = c & 1;
    const int dy = c >> 1;
    const int xi = x0 + dx;
    const int yi = y0 + dy;
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const float wx = dx ? lx : 1.f - lx;
    const float wy = dy ? ly : 1.f - ly;
    const T* row = vl + ((long long)yi * W + xi) * row_stride;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) dot = fmaf(gv[j], to_float(row[d]), dot);
    }
    s_attn = fmaf(wx * wy, dot, s_attn);
    s_x = fmaf(dx ? wy : -wy, dot, s_x);
    s_y = fmaf(dy ? wx : -wx, dot, s_y);
  }
  s_attn = warp_sum(s_attn);
  s_x = warp_sum(s_x);
  s_y = warp_sum(s_y);
  if (lane == 0) {
    dattn[i] = s_attn;
    dloc[2 * i] = s_x * a * (float)W;
    dloc[2 * i + 1] = s_y * a * (float)H;
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* g, float* dloc, float* dattn, int B, int S,
                   int M, int D, int Lq, int L, int P, int level, int start,
                   int H, int W, cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M * P;
  const long long blocks = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  const T* gg = static_cast<const T*>(g);
  if (D <= 32)
    msda_level_dgrid_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, gg, dloc, dattn, Lq, S, M, D, L, P, level, start, H, W,
        n_warps);
  else
    msda_level_dgrid_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, gg, dloc, dattn, Lq, S, M, D, L, P, level, start, H, W,
        n_warps);
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
