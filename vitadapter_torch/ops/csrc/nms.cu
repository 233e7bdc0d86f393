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
// pairs of a few operations (11 M pairs at 4768 boxes, microseconds of
// work); the greedy decision is sequential in score order. The first form
// of the walk ORed each kept row's words into the later words one L2 round
// trip after another (about 23 us a 64-box tile).
//
// Design (two kernels, one launch of the entry point):
// 1. nms_mask: the 64 x 64 tiles of the upper triangle, one block each
//    (the triangle's blocks only, numbered row by row), 64 threads: the
//    tile's column boxes go to shared memory, thread t tests row box
//    64 r + t against them and writes one 64-bit word of "overlaps a later
//    box" bits, mask[i][c]. Words left of a row's own tile are never read
//    and never written.
// 2. nms_walk: one block walks the tiles in order with the removed bits of
//    every box in shared memory, those of a non-finite box set from the
//    start (it is never kept and suppresses nothing). The rows of a tile,
//    from its diagonal word on, come into shared memory as one TMA box of
//    (chunk words, 64 rows) a chunk (the rows are `pitch` words apart, an
//    even number, and a box starts on an even word), up to `stages` chunks
//    ahead of the one in use, each completing on an mbarrier; so no global
//    load is on the walk's dependent chain. Per tile: thread 0 loads the 64
//    diagonal words into registers and decides the tile's 64 boxes in a
//    chain of 64 predicated ORs; then each warp ORs 8 of the kept rows of
//    each later word of the chunk into a partial (a lane a word: no bank
//    conflicts), and a thread a word ORs the 8 partials into the removed
//    bits (one writer a word: no atomics). Tried on the H100 and dropped as
//    slower: one bulk copy a row (a warp issues its lanes' bulk copies one
//    after another), 16-byte cp.async copies, ORing with shared-memory
//    atomics (64-bit ones are compare-and-swap loops), a thread a word over
//    all rows or over the kept rows' bits (one load after another). The
//    diagonal words are loaded unconditionally: a load under a branch made
//    the compiler recompute the shared window's base for each.
//
// Determinism: deterministic (the ORs commute). Limits: N <= 65536 (1024
// words of removed bits in shared memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kMaxWords = 1024;
constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kMaxStages = 4;
constexpr int kMaxChunk = 128;     // words of a chunk (the partials' room)

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ bool overlaps(float4 a, float4 b, float thr) {
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(w, h);
  // disjoint boxes (most pairs): the IoU is 0 / max(union, 1e-6) = +0
  // exactly, never above a threshold of 0 or more, so the division is
  // skipped
  if (inter == 0.f && thr >= 0.f) return false;
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-6f)) > thr;
}

// the tile (r, c >= r) of block b of the upper triangle, numbered row by
// row: row r starts at block r * words - r * (r - 1) / 2
__device__ __forceinline__ void triangle_tile(int b, int words, int* r,
                                              int* c) {
  const double t = 2.0 * words + 1.0;
  int row = (int)floor((t - sqrt(t * t - 8.0 * b)) / 2.0);
  row = max(0, min(row, words - 1));
  auto start = [words](int q) {
    return (long long)q * words - (long long)q * (q - 1) / 2;
  };
  while (row > 0 && start(row) > b) --row;
  while (row + 1 < words && start(row + 1) <= b) ++row;
  *r = row;
  *c = row + (int)(b - start(row));
}

__global__ void __launch_bounds__(kTile)
nms_mask(const float4* __restrict__ boxes,
         unsigned long long* __restrict__ mask, int N, int words, int pitch,
         float thr) {
  int r, c;
  triangle_tile(blockIdx.x, words, &r, &c);
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
  mask[(size_t)i * pitch + c] = bits;
}

// one step of the tile's greedy chain: if `bit` of `lo` is clear (the box
// is kept), OR its diagonal word (dlo, dhi) into the removed bits;
// predicated, no branch
__device__ __forceinline__ void keep_step(unsigned& lo, unsigned& hi,
                                          unsigned bit, unsigned dlo,
                                          unsigned dhi) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %2;\n\tsetp.eq.u32 p, t, 0;\n\t"
      "@p or.b32 %0, %0, %3;\n\t@p or.b32 %1, %1, %4;\n\t}"
      : "+r"(lo), "+r"(hi)
      : "r"(bit), "r"(dlo), "r"(dhi));
}

// the same for boxes 32-63 of a tile, whose diagonal words have no bit
// below 32
__device__ __forceinline__ void keep_step_hi(unsigned& hi, unsigned bit,
                                             unsigned dhi) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %0, %1;\n\tsetp.eq.u32 p, t, 0;\n\t"
      "@p or.b32 %0, %0, %2;\n\t}"
      : "+r"(hi)
      : "r"(bit), "r"(dhi));
}

// the chunks of a walk, in order: tile g's rows, words [g + c * chunk,
// min(words, g + (c + 1) * chunk))
struct Chunk {
  int g, w0, nw;
};

__device__ __forceinline__ bool next_chunk(Chunk* k, int words, int chunk) {
  const int w0 = k->w0 + chunk;
  if (w0 < words) {
    k->w0 = w0;
  } else if (k->g + 1 < words) {
    k->g += 1;
    k->w0 = k->g;
  } else {
    return false;
  }
  k->nw = min(chunk, words - k->w0);
  return true;
}

// the words a staged row holds: a chunk's words from the even word at or
// before its first, to an even end
__host__ __device__ __forceinline__ int stage_stride(int chunk) {
  return (chunk + 3) & ~1;
}

__global__ void __launch_bounds__(kWalkThreads)
nms_walk(const __grid_constant__ CUtensorMap rows_map,
         const unsigned char* __restrict__ finite,
         unsigned char* __restrict__ keep, int N, int words, int chunk,
         int stages) {
  extern __shared__ __align__(1024) unsigned long long ring[];
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long part[kWalkWarps][kMaxChunk];
  __shared__ unsigned long long kept_bits;
  __shared__ uint64_t full[kMaxStages];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // a non-finite box starts removed: it is never kept, suppresses nothing
  for (int w = warp; w < words; w += kWalkWarps) {
    const int i = w * kTile + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < N && finite[i]);
    const unsigned hi =
        __ballot_sync(0xffffffffu, i + 32 < N && finite[i + 32]);
    if (lane == 0) removed[w] = ~((unsigned long long)hi << 32 | lo);
  }
  if (t == 0) {
    for (int s = 0; s < stages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int stride = stage_stride(chunk);
  const int stage_words = kTile * stride;
  // a chunk's 64 rows into stage s: one TMA box of (stride words, 64 rows)
  // from the chunk's even word on (rows past the last box and words past
  // the pitch are zero-filled)
  auto load = [&](const Chunk& k, int s) {
    if (t != 0) return;
    sm90::mbar_expect_tx(&full[s], (uint32_t)stage_words * 8);
    sm90::tma_load_3d(ring + s * stage_words, &rows_map, &full[s],
                      k.w0 & ~1, k.g * kTile, 0);
  };
  // the ring: `stages` chunks in flight
  Chunk ahead{0, 0, min(chunk, words)};
  bool more = true;
  for (int s = 0; s < stages && more; ++s) {
    load(ahead, s);
    more = next_chunk(&ahead, words, chunk);
  }
  Chunk use{0, 0, min(chunk, words)};
  for (int it = 0;; ++it) {
    const int s = it % stages;
    sm90::mbar_wait(&full[s], (uint32_t)((it / stages) & 1));
    // local word 0 of every row of the chunk (word use.w0)
    const unsigned long long* rows =
        ring + s * stage_words + (use.w0 & 1);
    const int i0 = use.g * kTile;
    const int n = min(kTile, N - i0);
    const bool first = use.w0 == use.g;
    if (first && t == 0) {
      // decide the tile: its diagonal words in registers, one chain (rows
      // past the last box are zero)
      unsigned dlo[32], dhi[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const unsigned long long d = rows[k * stride];
        if (k < 32) dlo[k] = (unsigned)d;
        dhi[k] = (unsigned)(d >> 32);
      }
      const unsigned long long rem = removed[use.g];
      unsigned lo = (unsigned)rem, hi = (unsigned)(rem >> 32);
#pragma unroll
      for (int k = 0; k < 32; ++k) keep_step(lo, hi, 1u << k, dlo[k], dhi[k]);
#pragma unroll
      for (int k = 32; k < kTile; ++k) keep_step_hi(hi, 1u << (k - 32), dhi[k]);
      const unsigned long long valid = n == kTile ? ~0ull : (1ull << n) - 1;
      kept_bits = ~((unsigned long long)hi << 32 | lo) & valid;
    }
    if (first) __syncthreads();
    const unsigned long long kb = kept_bits;
    if (first && t < n) keep[i0 + t] = (unsigned char)((kb >> t) & 1ull);
    // OR the kept rows into the later words of this chunk in two passes:
    // warp w ORs rows 8 w .. 8 w + 7 of each word (a lane a word) into its
    // partial; then a thread a word ORs the 8 partials into the removed
    // bits (one writer a word: no atomics)
    const unsigned own = (unsigned)(kb >> (8 * warp)) & 0xffu;
    const int w_from = first ? 1 : 0;
    for (int w = w_from + lane; w < use.nw; w += 32) {
      unsigned long long acc = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const unsigned long long v = rows[(8 * warp + r) * stride + w];
        acc |= (own >> r) & 1u ? v : 0ull;
      }
      part[warp][w] = acc;
    }
    __syncthreads();
    for (int w = w_from + t; w < use.nw; w += kWalkThreads) {
      unsigned long long acc = removed[use.w0 + w];
#pragma unroll
      for (int q = 0; q < kWalkWarps; ++q) acc |= part[q][w];
      removed[use.w0 + w] = acc;
    }
    __syncthreads();  // stage s is free, the removed bits complete
    if (more) {
      load(ahead, s);
      more = next_chunk(&ahead, words, chunk);
    }
    if (!next_chunk(&use, words, chunk)) break;
  }
}

}  // namespace

// boxes (N, 4) fp32 in score order, finite (N,) uint8, mask a scratch of
// N * pitch uint64 with pitch = ceil(N / 64) rounded up to even (no initial
// value needed), keep (N,) uint8 out; the walk's chunks of `chunk` words
// and its ring of `stages` chunks (`ops/nms.py::walk_plan`). Returns a
// cudaError_t.
extern "C" int nms(const void* boxes, const void* finite, void* mask,
                   void* keep, int N, float thr, int chunk, int stages,
                   void* stream) {
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int words = (N + kTile - 1) / kTile;
  const int pitch = (words + 1) & ~1;
  const int smem = stages * kTile * stage_stride(chunk) * 8;
  if (words > kMaxWords || chunk < 1 || chunk > kMaxChunk || stages < 1 ||
      stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  // the ring beside the static part: CUDA refuses more than a CTA may take
  cudaError_t err = cudaFuncSetAttribute(
      nms_walk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<unsigned long long*>(mask);
  // the bit matrix (N rows of `pitch` words) for the walk's TMA boxes
  sm90::EncodeTiledFn enc = sm90::encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap rows_map;
  const cuuint64_t dims[3] = {(cuuint64_t)pitch, (cuuint64_t)N, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 8,
                                 (cuuint64_t)pitch * 8 * N};
  const cuuint32_t box[3] = {(cuuint32_t)stage_stride(chunk),
                             (cuuint32_t)kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (enc(&rows_map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, m, dims, strides,
          box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((long long)words * (words + 1) / 2);
  nms_mask<<<blocks, kTile, 0, s>>>(static_cast<const float4*>(boxes), m, N,
                                    words, pitch, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_walk<<<1, kWalkThreads, smem, s>>>(
      rows_map, static_cast<const unsigned char*>(finite),
      static_cast<unsigned char*>(keep), N, words, chunk, stages);
  return (int)cudaGetLastError();
}

extern "C" const char* nms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
