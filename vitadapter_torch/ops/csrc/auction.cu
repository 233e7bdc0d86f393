// Batched auction assignment (Bertsekas), hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/auction_pallas.py::_auction_kernel (via
// auction_assign_pallas). The TPU kernel keeps one image's (G, Q) benefit
// matrix in VMEM and runs the whole bidding loop inside one program per image,
// expressing argmax and scatter as masked min-iota reductions over the full
// matrix because Mosaic has no cheaper form.
//
// What bounds it on an H100: latency. One assignment of the flagship's train
// step is 20 matrices of (200 queries, 60 gts): 960 KB of fp32 costs read
// once and a few comparisons per cost entry per round, but hundreds to
// thousands of rounds, each depending on the last. Each round is a handful
// of __syncthreads inside one block, so neither the memory rate nor the
// arithmetic rate comes near its limit.
//
// Design: one block per matrix; the benefit matrix (-cost, transposed to
// (G, Q) rows, invalid gts at -1e30) lives in shared memory with the prices
// and owners. Per round: (1) mark the gts that own a query, stop when every
// valid gt does (or after max_iters rounds); (2) one warp per unassigned gt
// finds its best and second-best value (benefit - price) over the queries,
// ties to the lowest query index, and bids price + (best - second) + eps;
// (3) one thread per query takes the highest bid on it, ties to the lowest
// gt index, and sets its owner and price. This is the Pallas kernel's
// arithmetic in its order (all fp32 additions, no products), so the result
// equals `matching.auction_assign_plain` exactly on the same costs. The
// smaller side (the gts) bids, eps = max(span, 1e-6) / eps_div with span the
// largest |cost| of a valid gt, one round of eps (no scaling).
//
// Determinism: deterministic (no atomics; fixed tie rules).
//
// Layouts (all contiguous): cost (B, Q, G) fp32; n_valid (B,) int32, the
// first n_valid[b] gt columns of matrix b are real; owner (B, Q) int32 out,
// the gt of each query or -1; iters (B,) int32 out, the rounds run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

struct Top2 {
  float v1;  // best value
  int i1;    // its query (lowest on ties)
  float v2;  // best value over the other queries
};

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_first = a.v1 > b.v1 || (a.v1 == b.v1 && a.i1 < b.i1);
  Top2 r;
  if (a_first) {
    r.v1 = a.v1;
    r.i1 = a.i1;
    r.v2 = fmaxf(a.v2, b.v1);
  } else {
    r.v1 = b.v1;
    r.i1 = b.i1;
    r.v2 = fmaxf(b.v2, a.v1);
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ n_valid,
               int* __restrict__ owner_out, int* __restrict__ iters_out, int Q,
               int G, float eps_div, int max_iters) {
  extern __shared__ float smem[];
  float* ben = smem;                            // (G, Q)
  float* price = ben + (size_t)G * Q;           // (Q,)
  float* bid = price + Q;                       // (G,)
  int* owner = reinterpret_cast<int*>(bid + G); // (Q,)
  int* best_q = owner + Q;                      // (G,) -1 if not bidding
  int* assigned = best_q + G;                   // (G,)
  __shared__ float warp_max[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nv = n_valid[b];
  const float* c = cost + (size_t)b * Q * G;

  // benefit, and span = max |benefit| over valid gts
  float span_part = 0.f;
  for (int i = tid; i < Q * G; i += kThreads) {
    const int q = i / G;
    const int g = i - q * G;
    const float v = g < nv ? -c[i] : kNeg;
    ben[g * Q + q] = v;
    if (v > kNeg / 2) span_part = fmaxf(span_part, fabsf(v));
  }
  for (int o = 16; o; o >>= 1)
    span_part = fmaxf(span_part, __shfl_xor_sync(0xffffffffu, span_part, o));
  if (lane == 0) warp_max[warp] = span_part;
  for (int q = tid; q < Q; q += kThreads) {
    price[q] = 0.f;
    owner[q] = -1;
  }
  __syncthreads();
  float span = 0.f;
  for (int w = 0; w < kWarps; ++w) span = fmaxf(span, warp_max[w]);
  span = fmaxf(span, 1e-6f);
  const float eps = span / eps_div;

  int it = 0;
  while (true) {
    // (1) which gts own a query; is any valid gt still free?
    for (int g = tid; g < G; g += kThreads) assigned[g] = 0;
    __syncthreads();
    for (int q = tid; q < Q; q += kThreads)
      if (owner[q] >= 0) assigned[owner[q]] = 1;
    __syncthreads();
    int free_gt = 0;
    for (int g = tid; g < G; g += kThreads)
      free_gt |= (g < nv && !assigned[g]);
    if (!__syncthreads_or(free_gt) || it >= max_iters) break;

    // (2) one warp per free gt: best and second value, and its bid
    for (int g = warp; g < G; g += kWarps) {
      if (g >= nv || assigned[g]) {
        if (lane == 0) best_q[g] = -1;
        continue;
      }
      const float* row = ben + (size_t)g * Q;
      Top2 t{-INFINITY, 0x7fffffff, -INFINITY};
      for (int q = lane; q < Q; q += 32) {
        const float v = row[q] - price[q];
        Top2 one{v, q, -INFINITY};
        t = merge(t, one);
      }
      for (int o = 16; o; o >>= 1) {
        Top2 other;
        other.v1 = __shfl_xor_sync(0xffffffffu, t.v1, o);
        other.i1 = __shfl_xor_sync(0xffffffffu, t.i1, o);
        other.v2 = __shfl_xor_sync(0xffffffffu, t.v2, o);
        t = merge(t, other);
      }
      if (lane == 0) {
        const float second = t.v2 > kNeg / 2 ? t.v2 : t.v1 - span;
        bid[g] = price[t.i1] + (t.v1 - second) + eps;
        best_q[g] = t.i1;
      }
    }
    __syncthreads();

    // (3) one thread per query: the highest bid wins, lowest gt on ties
    for (int q = tid; q < Q; q += kThreads) {
      float top = -INFINITY;
      int win = -1;
      for (int g = 0; g < G; ++g)
        if (best_q[g] == q && bid[g] > top) {
          top = bid[g];
          win = g;
        }
      if (win >= 0) {
        owner[q] = win;
        price[q] = top;
      }
    }
    __syncthreads();
    ++it;
  }

  for (int q = tid; q < Q; q += kThreads)
    owner_out[(size_t)b * Q + q] = owner[q];
  if (tid == 0) iters_out[b] = it;
}

// Dynamic shared memory one block needs for a (Q, G) matrix.
size_t smem_bytes(int Q, int G) {
  return (size_t)G * Q * sizeof(float) + (size_t)(Q + G) * sizeof(float) +
         (size_t)(Q + 2 * G) * sizeof(int);
}

}  // namespace

// Returns a cudaError_t.
extern "C" int auction(const void* cost, const void* n_valid, void* owner,
                       void* iters, int B, int Q, int G, float eps_div,
                       int max_iters, void* stream) {
  if (B < 0 || Q < 1 || G < 1 || max_iters < 0 || !(eps_div > 0.f))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const size_t smem = smem_bytes(Q, G);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  if (smem + kWarps * sizeof(float) > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(auction_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  auction_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const int*>(n_valid),
      static_cast<int*>(owner), static_cast<int*>(iters), Q, G, eps_div,
      max_iters);
  return (int)cudaGetLastError();
}

extern "C" const char* auction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
