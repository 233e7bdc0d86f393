// Multi-scale deformable attention (MSDA) forward of ONE level, added into
// an fp32 accumulator; hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_sample_kernel (levels with
// H * W > 1024) and ::_sample_kernel_onehot_pf (levels with H * W <= 1024),
// both via _sample_level_pallas, which the JAX dispatch takes level by level
// when one head's value holds more than 8 MiB (msda_pallas.py:858-877). The
// TPU kernels build one-hot interpolation matrices (per sample Wy . V . Wx,
// or all P points folded into one one-hot row) and contract them on the MXU,
// because gathers are slow on a TPU; both compute the same per-level
// function, so one kernel serves both.
//
// What bounds it on an H100: bytes. One level of a value over the 8 MiB line
// is 0.6-9.4 MB per head group (fp32), read once from device memory into L2;
// the fp32 accumulator (B, Lq, M, D) is read and written once per level;
// the arithmetic is one fp32 FMA per channel per in-map corner, far under
// the CUDA cores' ridge of about 20 FLOP per byte.
//
// Design: the direct gather of msda_fwd.cu, restricted to one level. One warp
// per (batch, query, head); the lanes are the channels, so each bilinear
// corner is one coalesced read of a D-wide value row. The coordinates are
// warp-uniform, so the corner test never diverges. Each warp owns its
// accumulator row and adds to it without atomics; the wrapper launches the
// levels in order on one stream, so the sum is deterministic. Edges follow
// msda_fwd.cu: pixel loc * size - 0.5, floor, corners off the map contribute
// zero (grid_sample's zeros padding); a point with no corner on the map (also
// NaN and values too large for an int) is skipped before conversion. The
// bilinear x attention weight and the sum stay fp32 where the TPU kernels
// round Wy and tmp * Wx (_sample_kernel) or the folded one-hot row
// (_sample_kernel_onehot_pf) to a bf16 value's dtype.
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2) fp32
// in [0, 1] (x, y); attn (B, Lq, M, L, P) fp32; acc (B, Lq, M, D) fp32.
// The level covers value rows [start, start + H * W).

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
msda_level_fwd_kernel(const T* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, float* __restrict__ acc,
                      int Lq, int S, int M, int D, int L, int P, int level,
                      int start, int H, int W, long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  // warp = (b * Lq + q) * M + m
  const int m = (int)(warp % M);
  const long long b = warp / M / Lq;
  const long long row_stride = (long long)M * D;  // one value row s
  const T* vl = value + (b * S + start) * row_stride + (long long)m * D;
  const float* lp = loc + (warp * L + level) * (P * 2);
  const float* ap = attn + (warp * L + level) * P;

  float sum[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) sum[j] = 0.f;

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
      const T* row = vl + ((long long)yi * W + xi) * row_stride;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) sum[j] = fmaf(wgt, to_float(row[d]), sum[j]);
      }
    }
  }
  float* o = acc + warp * D;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) o[d] += sum[j];
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   float* acc, int B, int S, int M, int D, int Lq, int L,
                   int P, int level, int start, int H, int W,
                   cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M;
  const long long blocks = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  if (D <= 32)
    msda_level_fwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, acc, Lq, S, M, D, L, P, level, start, H, W, n_warps);
  else
    msda_level_fwd_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, acc, Lq, S, M, D, L, P, level, start, H, W, n_warps);
  return cudaGetLastError();
}

}  // namespace

// Adds level `level` (rows [start, start + H * W) of the value) into the
// fp32 accumulator. Returns a cudaError_t.
extern "C" int msda_level_fwd(const void* value, const void* loc,
                              const void* attn, void* acc, int B, int S,
                              int M, int D, int Lq, int L, int P, int level,
                              int start, int H, int W, int is_bf16,
                              void* stream) {
  if (D < 1 || D > 64 || P < 1 || L < 1 || level < 0 || level >= L ||
      H < 1 || W < 1 || start < 0 || (long long)start + (long long)H * W > S)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, a, B, S, M, D, Lq, L,
                                      P, level, start, H, W, s)
              : launch<float>(value, loc, attn, a, B, S, M, D, Lq, L, P,
                              level, start, H, W, s);
  return (int)err;
}

extern "C" const char* msda_level_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
