// Greedy non-maximum suppression over score-sorted boxes, hand-written for
// Hopper (sm_90a).
//
// Replaces: the `lax.scan` of vitadapter/det/boxes.py::nms. That is not a
// TPU kernel (no Pallas): XLA runs the scan as a loop of N steps, each one
// row of the N x N IoU matrix. In PyTorch such a loop would launch a few
// kernels per box; proposal generation runs one NMS over 4768 boxes per
// image at the 1024 canvas, the detection decode one over 2048.
//
// Function: boxes (N, 4) xyxy fp32, already in score order, and a flag per
// box (finite score). Box i is kept when its flag is set and no earlier kept
// box j has IoU(j, i) > thr. The IoU is the plain version's and JAX's
// arithmetic, each step rounded on its own (no contraction into an FMA), so
// the kept set is bitwise theirs: inter = max(min(x2) - max(x1), 0) *
// max(min(y2) - max(y1), 0), union = (area_a + area_b) - inter, IoU = inter
// / max(union, 1e-6).
//
// What bounds it on an H100: the walk's latency. The IoU test is N^2 / 2
// pairs of a few operations (23 M pairs at 4768 boxes, microseconds of
// work); the greedy decision is sequential in score order.
//
// Design (two kernels, one launch of the entry point):
// 1. nms_mask: 64 x 64 tiles of the upper triangle. Block (row tile r, col
//    tile c >= r), 64 threads: the tile's column boxes go to shared memory,
//    thread t tests row box 64 r + t against them and writes one 64-bit
//    word of "overlaps a later box" bits, mask[i][c]. Words left of a row's
//    own tile are never read and never written.
// 2. nms_walk: one block walks the tiles in order with the removed bits of
//    every box in shared memory. Per tile: its 64 diagonal words are loaded
//    in parallel, one thread decides the tile's 64 boxes from them in
//    registers, then every thread ORs the kept rows' words of one later
//    tile into the removed bits. A tile costs a few barriers and at most 64
//    loads a thread, not 64 dependent steps through memory.
//
// Determinism: deterministic (no atomics). Limits: N <= 65536 (1024 words
// of removed bits in shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxWords = 1024;
constexpr int kWalkThreads = 256;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ bool overlaps(float4 a, float4 b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-6f)) > thr;
}

__global__ void __launch_bounds__(kTile)
nms_mask(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask,
         int N, int words, float thr) {
  const int r = blockIdx.y, c = blockIdx.x;
  if (c < r) return;
  __shared__ float4 cols[kTile];
  const int t = threadIdx.x;
  const int j0 = c * kTile;
  if (j0 + t < N) cols[t] = boxes[j0 + t];
  __syncthreads();
  const int i = r * kTile + t;
  if (i >= N) return;
  const float4 a = boxes[i];
  const int n = min(kTile, N - j0);
  unsigned long long bits = 0;
  for (int k = 0; k < n; ++k)
    if (j0 + k > i && overlaps(a, cols[k], thr)) bits |= 1ull << k;
  mask[(size_t)i * words + c] = bits;
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk(const unsigned long long* __restrict__ mask,
         const unsigned char* __restrict__ finite,
         unsigned char* __restrict__ keep, int N, int words) {
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned long long live;     // finite flags of the tile
  __shared__ unsigned long long kept;     // the tile's kept boxes
  const int t = threadIdx.x;
  for (int w = t; w < words; w += kWalkThreads) removed[w] = 0;
  for (int g = 0; g < words; ++g) {
    const int i0 = g * kTile;
    const int n = min(kTile, N - i0);
    if (t == 0) live = 0;
    __syncthreads();
    if (t < n) {
      diag[t] = mask[(size_t)(i0 + t) * words + g];
      if (finite[i0 + t]) atomicOr(&live, 1ull << t);
    }
    __syncthreads();
    if (t == 0) {
      unsigned long long rem = removed[g], kb = 0;
      for (int k = 0; k < n; ++k) {
        if (!((rem >> k) & 1ull) && ((live >> k) & 1ull)) {
          kb |= 1ull << k;
          rem |= diag[k];
        }
      }
      kept = kb;
    }
    __syncthreads();
    const unsigned long long kb = kept;
    if (t < n) keep[i0 + t] = (unsigned char)((kb >> t) & 1ull);
    for (int w = g + 1 + t; w < words; w += kWalkThreads) {
      unsigned long long acc = removed[w];
      for (unsigned long long b = kb; b; b &= b - 1)
        acc |= mask[(size_t)(i0 + __ffsll((long long)b) - 1) * words + w];
      removed[w] = acc;
    }
  }
}

}  // namespace

// boxes (N, 4) fp32 in score order, finite (N,) uint8, mask a scratch of
// N * ceil(N / 64) uint64 (no initial value needed), keep (N,) uint8 out.
// Returns a cudaError_t.
extern "C" int nms(const void* boxes, const void* finite, void* mask,
                   void* keep, int N, float thr, void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int words = (N + kTile - 1) / kTile;
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<unsigned long long*>(mask);
  nms_mask<<<dim3(words, words), kTile, 0, s>>>(
      static_cast<const float4*>(boxes), m, N, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_walk<<<1, kWalkThreads, 0, s>>>(
      m, static_cast<const unsigned char*>(finite),
      static_cast<unsigned char*>(keep), N, words);
  return (int)cudaGetLastError();
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
