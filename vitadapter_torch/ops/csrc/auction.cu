// Batched auction assignment (Bertsekas), hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/auction_pallas.py::_auction_kernel (via
// auction_assign_pallas). The TPU kernel keeps one image's (G, Q) benefit
// matrix in VMEM and runs the whole bidding loop inside one program per image,
// expressing argmax and scatter as masked min-iota reductions over the full
// matrix because Mosaic has no cheaper form.
//
// What bounds it on an H100 (80GB HBM3, 700 W): the latency of a round.
// One assignment of the flagship's train step is 20 matrices of (200
// queries, 60 gts): 960 KB of fp32 costs read once and a few comparisons
// per cost entry per round, but hundreds of rounds, each depending on the
// last, inside one block per matrix (on contested costs the slowest matrix
// runs 701 rounds), so neither the memory rate nor the arithmetic rate
// comes near its limit. The first design took 2.51-2.53 ms on those
// costs, 3.6 us a round
// (vitadapter_torch/tools/auction_ab.py): five block barriers a round,
// `assigned` rebuilt from the owners every round, free gts handed to warps
// by gt index (a late round's few bidders could sit on one warp) and every
// query thread scanning all G bids. Now 0.84 ms, 1.2 us a round
// (vitadapter_torch/tools/kernel_variants.py): a round is one warp's
// search for its gt's best query, the bid's 64-bit atomic (a
// compare-and-swap loop in shared memory) and two barriers.
//
// Design: one block per matrix; the benefit matrix (-cost, transposed to
// (G, Q) rows, invalid gts at -1e30) lives in shared memory with the
// prices, the owners, one 64-bit key per query and a list of the free gts.
// A round (Jacobi: every free gt bids on the prices at its start) has two
// block barriers:
// (1) the k-th free gt of the list goes to warp k mod warps. Each lane
//     finds its best and second value (benefit - price) over its queries,
//     with eight queries' loads issued before any is used; three redux.sync
//     reductions give the warp's best value, the lowest query holding it
//     and the best value over the other queries; the lane holding the best
//     query bids price + (best - second) + eps by a shared 64-bit atomicMax
//     on its query's key, (float bits of the bid) << 32 | (G - g): a bid is
//     > 0 (the price is >= 0, best - second >= 0, eps > 0), so the float
//     bits order as the bids, and the low word gives ties to the lowest gt
//     and is never 0;
// (2) each bidder reads its query's key: the winner sets the query's owner
//     and price, clears the key and puts the evicted owner, if any, on the
//     next round's list; a bidder that lost stays on it.
// The round count is the next list's length (no free valid gt: done; or
// max_iters rounds). Lists and list lengths rotate between rounds, so no
// extra barrier clears them. The list's order depends on the atomics'
// order and decides only which warp takes which gt, never the result. This
// is the Pallas kernel's arithmetic in its order (all fp32 additions, no
// products; the reductions' integers order the floats with -0 as +0, which
// changes no bid), so the result equals `matching.auction_assign_plain`
// exactly on the same costs, rounds included. The smaller side (the gts)
// bids, eps = max(span, 1e-6) / eps_div with span the largest |cost| of a
// valid gt, one round of eps (no scaling).
// Measured and not kept (kernel_variants.py, contested flagship costs):
// 256, 128 and 1024 threads, 0.99, 1.41 and 0.87 ms (512 kept); the
// search with one query's loads at a time merged into a (best, query,
// second) triple, then a 5-step shuffle tree, 0.95; no atomics, each
// bidder scanning the round's bids for a higher one on its query, 1.62;
// the next list's appends aggregated to one atomic a warp, 0.88.
//
// Determinism: deterministic (the atomics take a maximum; fixed tie rules).
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

constexpr int kUnroll = 8;     // a lane's queries loaded before any is used
constexpr unsigned kAll = 0xffffffffu;

// An unsigned integer in the order of the floats (no NaN), -0 as +0.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : u | 0x80000000u;
}

__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const int* __restrict__ n_valid,
               int* __restrict__ owner_out, int* __restrict__ iters_out, int Q,
               int G, float eps_div, int max_iters) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;                       // (Q,) 0: no bid
  float* ben = reinterpret_cast<float*>(key + Q);       // (G, Q)
  float* price = ben + (size_t)G * Q;                   // (Q,)
  int* owner = reinterpret_cast<int*>(price + Q);       // (Q,)
  int* list = owner + Q;                                // (2, G) free gts
  int* bid_q = list + 2 * G;                            // (G,) by list slot
  __shared__ float warp_max[kWarps];
  __shared__ int count[3];  // list lengths: this round's, the next, spare

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // gts past G are not there; a negative count has none
  const int nv = max(0, min(n_valid[b], G));
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
    key[q] = 0ull;
  }
  for (int g = tid; g < nv; g += kThreads) list[g] = g;
  if (tid == 0) {
    count[0] = nv;
    count[1] = 0;
  }
  __syncthreads();
  float span = 0.f;
  for (int w = 0; w < kWarps; ++w) span = fmaxf(span, warp_max[w]);
  span = fmaxf(span, 1e-6f);
  const float eps = span / eps_div;

  int it = 0;
  while (true) {
    const int n = count[it % 3];
    if (n == 0 || it >= max_iters) break;
    const int* free_gt = list + (it & 1) * G;
    int* next = list + ((it & 1) ^ 1) * G;
    int* n_next = count + (it + 1) % 3;

    // (1) the k-th free gt to warp k mod warps: best and second value, and
    // its bid on its best query's key
    for (int k = warp; k < n; k += kWarps) {
      const int g = free_gt[k];
      const float* row = ben + (size_t)g * Q;
      // this lane's best value v1 (lowest query on ties; its price p1) and
      // best v2 over its other queries, kUnroll queries' loads at a time
      float v1 = -INFINITY, v2 = -INFINITY, p1 = 0.f;
      int i1 = 0x7fffffff;
      for (int q0 = lane; q0 < Q; q0 += 32 * kUnroll) {
        float v[kUnroll], pq[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
          pq[u] = q < Q ? price[q] : 0.f;
          v[u] = q < Q ? row[q] - pq[u] : -INFINITY;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (v[u] > v1) {
            v2 = v1;
            v1 = v[u];
            i1 = q0 + 32 * u;
            p1 = pq[u];
          } else {
            v2 = fmaxf(v2, v[u]);
          }
        }
      }
      // the warp's best value, the lowest query that holds it and the best
      // value over the other queries: three redux.sync reductions; the
      // lane holding the best query bids
      const unsigned k1 = ordered(v1);
      const unsigned m1 = __reduce_max_sync(kAll, k1);
      const unsigned q = __reduce_min_sync(kAll, k1 == m1 ? i1 : 0xffffffffu);
      const bool mine = k1 == m1 && (unsigned)i1 == q;
      const float v2w = unordered(__reduce_max_sync(kAll, ordered(mine ? v2
                                                                       : v1)));
      if (mine) {
        const float second = v2w > kNeg / 2 ? v2w : v1 - span;
        const float bid = p1 + (v1 - second) + eps;
        atomicMax(&key[q], (unsigned long long)__float_as_uint(bid) << 32 |
                               (unsigned)(G - g));
        bid_q[k] = q;
      }
    }
    // the length the round after next appends to; read last round
    if (tid == 0) count[(it + 2) % 3] = 0;
    __syncthreads();

    // (2) each bidder reads its query's key: the winner takes the query
    // and frees its old owner, a bidder that lost stays free
    for (int k = tid; k < n; k += kThreads) {
      const int g = free_gt[k];
      const int q = bid_q[k];
      const unsigned long long kv = key[q];
      int freed = g;
      if ((unsigned)kv == (unsigned)(G - g)) {
        freed = owner[q];
        owner[q] = g;
        price[q] = __uint_as_float((unsigned)(kv >> 32));
        key[q] = 0ull;
      }
      if (freed >= 0) next[atomicAdd(n_next, 1)] = freed;
    }
    __syncthreads();
    ++it;
  }

  for (int q = tid; q < Q; q += kThreads)
    owner_out[(size_t)b * Q + q] = owner[q];
  if (tid == 0) iters_out[b] = it;
}

// Dynamic shared memory one block needs for a (Q, G) matrix: keys, benefit,
// prices, owners, two free lists and the bid slots. The kernel's static
// shared memory (`kWarps` floats and three ints) comes on top;
// `vitadapter_torch/ops/matching.py::auction_smem_bytes` is the sum, and
// chip_smoke.py's phase 3 holds the two to the same largest matrix.
size_t smem_bytes(int Q, int G) {
  return (size_t)Q * sizeof(unsigned long long) +
         (size_t)G * Q * sizeof(float) + (size_t)Q * sizeof(float) +
         (size_t)(Q + 3 * G) * sizeof(int);
}

constexpr size_t kStaticSmem = kWarps * sizeof(float) + 3 * sizeof(int);

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
  if (smem + kStaticSmem > (size_t)optin) return (int)cudaErrorInvalidValue;
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
