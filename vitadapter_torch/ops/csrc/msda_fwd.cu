// Multi-scale deformable attention (MSDA) forward, hand-written for Hopper
// (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_fwd_ml_kernel. The TPU kernel
// builds relu one-hot interpolation matrices and contracts them with the
// value on the MXU, because gathers are slow on a TPU.
//
// What bounds it on an H100: bytes. A flagship call reads a value of 1-11 MB
// (bf16), fp32 locations and weights, and writes the output: 9-47 MB per
// image, against 0.05-0.53 GFLOP of fp32 FMAs, well under the CUDA cores'
// ridge of about 20 FLOP per byte.
//
// Design: a direct gather, as the reference CUDA im2col does. One warp per
// (batch, query, head). The lanes are the channels, so each bilinear corner
// is one coalesced read of a D-wide value row (64 bytes in bf16 at D = 32).
// The sampling coordinates are warp-uniform, so the corner test never
// diverges. A call's value tensor fits the 50 MB L2, so corner reads that
// neighbouring queries share come from L2, not from device memory. Corners
// off the map contribute zero (grid_sample's zeros padding); they are not
// clamped. The bilinear x attention weight stays fp32 and the sum is fp32;
// the TPU kernel rounds that weight to the value dtype before its dot.
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2) fp32
// in [0, 1] (x, y); attn (B, Lq, M, L, P) fp32; out (B, Lq, M, D) in the
// value dtype. Level l covers value rows [start[l], start[l] + H_l * W_l).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// CPL: channels per lane, ceil(D / 32).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, T* __restrict__ out, int Lq,
                int S, int M, int D, int L, int P, long long n_warps,
                Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  // warp = (b * Lq + q) * M + m
  const int m = (int)(warp % M);
  const long long b = warp / M / Lq;
  const long long row_stride = (long long)M * D;  // one value row s
  const T* vb = value + b * S * row_stride + (long long)m * D;
  const float* lp = loc + warp * (L * P * 2);
  const float* ap = attn + warp * (L * P);

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const T* vl = vb + (long long)lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float a = ap[i];
      const float x = lp[2 * i] * W - 0.5f;
      const float y = lp[2 * i + 1] * H - 0.5f;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      // no corner on the map (also skips NaN and values too large for int)
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
          if (d < D) acc[j] = fmaf(wgt, to_float(row[d]), acc[j]);
        }
      }
    }
  }
  T* o = out + warp * D;
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) o[d] = from_float<T>(acc[j]);
  }
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, int B, int S, int M, int D, int Lq, int L, int P,
                   const Levels& lv, cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M;
  const long long blocks = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  T* o = static_cast<T*>(out);
  if (D <= 32)
    msda_fwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, o, Lq, S, M, D, L, P, n_warps, lv);
  else
    msda_fwd_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, o, Lq, S, M, D, L, P, n_warps, lv);
  return cudaGetLastError();
}

}  // namespace

// shapes: 2 * L ints (H_l, W_l); starts: L ints. Returns a cudaError_t.
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, const int* shapes, const int* starts,
                        int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * M == 0) return (int)cudaSuccess;
  Levels lv = {};
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = starts[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, out, B, S, M, D, Lq,
                                      L, P, lv, s)
              : launch<float>(value, loc, attn, out, B, S, M, D, Lq, L, P, lv,
                              s);
  return (int)err;
}

extern "C" const char* msda_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
