// Bilinear point sampling forward, hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/point_sample_pallas.py::_fwd_kernel (via _fwd).
// The TPU kernel builds relu one-hot row and column matrices per point tile
// and contracts them with the mask on the MXU, skipping row chunks outside
// the tile's band (_tile_bounds), because gathers are slow on a TPU.
//
// What bounds it on an H100: bytes. Each point reads four mask values and
// its two coordinates and writes one fp32 value: a handful of FLOPs against
// 12-20 bytes per point. The flagship's largest call samples 120 gt maps of
// 512 x 512 at 125,440 points each (63 MB of bf16 maps, 120 MB of points,
// 60 MB out).
//
// Design: a direct gather, one thread per (mask, point). The four corners
// are two pairs of neighbouring values in two rows; callers that sort their
// points by row (sort_points_by_y) make neighbouring threads read
// neighbouring rows, so most corner reads hit L1/L2. Semantics are
// grid_sample(mode='bilinear', padding_mode='zeros', align_corners=False):
// point (x, y) in [0, 1] maps to pixel (x * W - 0.5, y * H - 0.5); corners
// off the map contribute zero; points whose corners all lie off the map (also
// NaN and values too large for an int) give 0. The bilinear weights and the
// sum are fp32 whatever the mask dtype; the TPU kernel rounds the column
// weights to the mask dtype before its contraction.
//
// Determinism: deterministic (no atomics).
//
// Layouts (all contiguous): masks (N, H, W) bf16 or fp32; points (N, P, 2)
// fp32 (x, y); out (N, P) fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
point_sample_fwd_kernel(const T* __restrict__ masks,
                        const float* __restrict__ points,
                        float* __restrict__ out, int H, int W, int P,
                        long long n_points) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_points) return;
  const long long n = i / P;
  const float2 pt = reinterpret_cast<const float2*>(points)[i];
  // loc * size, then - 0.5, each rounded, as the plain version and
  // JAX round them (__fmul_rn is never contracted into an FMA)
  const float x = __fmul_rn(pt.x, (float)W) - 0.5f;
  const float y = __fmul_rn(pt.y, (float)H) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  float acc = 0.f;
  if (x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
      y0f <= (float)(H - 1)) {
    const float lx = x - x0f;
    const float ly = y - y0f;
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const T* m = masks + n * H * W;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int xi = x0 + (c & 1);
      const int yi = y0 + (c >> 1);
      if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
      const float w = ((c & 1) ? lx : 1.f - lx) * ((c >> 1) ? ly : 1.f - ly);
      acc = fmaf(w, to_float(m[(long long)yi * W + xi]), acc);
    }
  }
  out[i] = acc;
}

}  // namespace

// Returns a cudaError_t.
extern "C" int point_sample_fwd(const void* masks, const void* points,
                                void* out, int N, int H, int W, int P,
                                int is_bf16, void* stream) {
  if (N < 0 || H < 1 || W < 1 || P < 0) return (int)cudaErrorInvalidValue;
  const long long n_points = (long long)N * P;
  if (n_points == 0) return (int)cudaSuccess;
  const long long blocks = (n_points + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pts = static_cast<const float*>(points);
  float* o = static_cast<float*>(out);
  if (is_bf16)
    point_sample_fwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0,
                                             s>>>(
        static_cast<const __nv_bfloat16*>(masks), pts, o, H, W, P, n_points);
  else
    point_sample_fwd_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(masks), pts, o, H, W, P, n_points);
  return (int)cudaGetLastError();
}

extern "C" const char* point_sample_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
