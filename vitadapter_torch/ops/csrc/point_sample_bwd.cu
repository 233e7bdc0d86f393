// Bilinear point sampling backward (grad of the masks), hand-written for
// Hopper (sm_90a).
//
// Replaces: vitadapter/ops/point_sample_pallas.py::_bwd_kernel (via _bwd),
// which computes d mask = sum_p Ry[:, p] g[p] Rx[:, p]^T as one MXU
// contraction over each point tile, accumulated in VMEM across the
// sequential tile axis. grad_points is zero by definition there
// (point_sample_pallas.py:20-24) and is not computed here either.
//
// What bounds it on an H100: bytes and atomics. Each point reads its
// coordinates and g and adds to four mask cells; the output is the whole
// (N, H, W) gradient, written once (plus the fp32 scratch for bf16 masks).
// The flagship's call scatters 400 x 12,544 points into (400, 128, 128).
//
// Design: one thread per (mask, point) adds g * w to each in-map corner of
// an fp32 buffer with atomicAdd; a second kernel casts the buffer to bf16
// when the mask is bf16 (fp32 masks accumulate in the output directly).
// Corners off the map and points with no corner on the map add nothing, as
// in the forward. The bilinear weights and the sums are fp32.
//
// Determinism: NOT deterministic. The fp32 atomicAdd sums the points of one
// cell in an order that changes from run to run (the TPU kernel's
// contraction is deterministic). Checks use a tolerance that covers the
// reassociation.
//
// Layouts (all contiguous): points (N, P, 2) fp32; g (N, P) fp32;
// dmask_f32 (N, H, W) fp32 scratch (zeroed here); dmask (N, H, W) in the
// mask dtype (may alias dmask_f32 for fp32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
point_sample_bwd_kernel(const float* __restrict__ points,
                        const float* __restrict__ g,
                        float* __restrict__ dmask, int H, int W, int P,
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
  if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
        y0f <= (float)(H - 1)))
    return;
  const float gi = g[i];
  const float lx = x - x0f;
  const float ly = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  float* dm = dmask + n * H * W;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int xi = x0 + (c & 1);
    const int yi = y0 + (c >> 1);
    if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
    const float w = ((c & 1) ? lx : 1.f - lx) * ((c >> 1) ? ly : 1.f - ly);
    atomicAdd(dm + (long long)yi * W + xi, gi * w);
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16(src[i]);
}

}  // namespace

// dmask_f32 is an fp32 scratch of the masks' size (the output itself when
// the masks are fp32). Returns a cudaError_t.
extern "C" int point_sample_bwd(const void* points, const void* g,
                                void* dmask_f32, void* dmask, int N, int H,
                                int W, int P, int is_bf16, void* stream) {
  if (N < 0 || H < 1 || W < 1 || P < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_cells = (long long)N * H * W;
  cudaError_t err = cudaMemsetAsync(dmask_f32, 0, sizeof(float) * n_cells, s);
  if (err != cudaSuccess) return (int)err;
  const long long n_points = (long long)N * P;
  if (n_points > 0) {
    const long long blocks = (n_points + kThreads - 1) / kThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    point_sample_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const float*>(points), static_cast<const float*>(g),
        static_cast<float*>(dmask_f32), H, W, P, n_points);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (is_bf16 && n_cells > 0) {
    const long long blocks = (n_cells + 255) / 256;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    cast_to_bf16<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(dmask_f32),
        static_cast<__nv_bfloat16*>(dmask), n_cells);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* point_sample_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
