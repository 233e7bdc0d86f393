// Bilinear point sampling forward, hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/point_sample_pallas.py::_fwd_kernel (via _fwd).
// The TPU kernel builds relu one-hot row and column matrices per point tile
// and contracts them with the mask on the MXU, skipping row chunks outside
// the tile's band (_tile_bounds), because gathers are slow on a TPU.
//
// Function: grid_sample(mode='bilinear', padding_mode='zeros',
// align_corners=False) of masks (N, H, W) at points (N / S, P, 2): the S
// consecutive masks n = s * S .. s * S + S - 1 share the point set s (S = 1
// is the JAX function's form). Point (x, y) in [0, 1] maps to pixel
// (x * W - 0.5, y * H - 0.5), the product rounded on its own (__fmul_rn);
// corners off the map contribute zero; points whose corners all lie off the
// map (also NaN and values too large for an int) give 0. The bilinear
// weights and the sum are fp32 whatever the mask dtype; the TPU kernel
// rounds the column weights to the mask dtype before its contraction.
//
// What bounds it on an H100: bytes. Each point reads four mask values and
// its two coordinates and writes one fp32 value. A direct gather from
// device memory (this kernel's first form) issues four scalar loads a point
// that hit up to 32 sectors a warp: on a small map with unsorted points
// (the loss's uncertainty call) L1 wavefronts, not HBM bytes, bound it; and
// a caller that shares one point set among many masks had to expand it
// first (the flagship's assignment wrote and read 0.5 GB of copied
// coordinates a step).
//
// Design: three kernels behind one entry point, the plan
// (`ops/point_sample.py::fwd_plan`) picking one from the shapes and from
// whether the caller sorted its points by y.
// - The gather kernel (the first form, kept for the calls it serves best:
//   points sorted by y, or maps too large to stage whole): one thread per
//   (mask, point), the corners read from device memory, whose sectors the
//   sorted points share between neighbouring threads.
// - The streaming kernel (masks in shared memory, 256 threads, 4 points a
//   thread at a time; unsorted points on maps that fit a CTA, such as the
//   loss's uncertainty call): the call's N * P points are split evenly
//   over the CTAs that run at once; a CTA stages each of its masks whole
//   by one `cp.async.bulk` completing on an mbarrier (two buffers: the next
//   mask's copy in flight) and streams the mask's points through in
//   chunks, the next chunk's point loads in flight while this one is
//   gathered from shared memory.
// - The tile kernel (point sets shared by S masks): a CTA takes a tile of
//   at most 1024 points of one set and a group of its masks; each thread
//   keeps its points' corner offset, in-map corner flags and fractions in
//   registers (the geometry once for the group), the CTA reduces the band
//   of rows the tile's corners touch (on the card: the GPU form of the TPU
//   kernel's `_tile_bounds`), and when the band fits the buffer (the whole
//   map, or a buffer sized for the band that points sorted by y, as the
//   loss sorts them, give a tile) each mask's band is copied in,
//   double-buffered across the group's masks; a tile whose band does not
//   fit (or a plan with no buffer) gathers from device memory.
// The bulk copy needs 16-byte addresses and sizes: the lanes of warp 0 copy
// a band's unaligned head and tail elements themselves (rows of 127 or 130
// bf16 values, a storage offset) and arrive on the same barrier. Every
// output value is written once, whichever kernel.
//
// Determinism: deterministic (no atomics); the result does not depend on
// the kernel, the path or the plan: each value is the same four fmaf in the
// same order.
//
// Layouts (all contiguous): masks (N, H, W) bf16 or fp32; points (N / S, P,
// 2) fp32 (x, y), 8-byte aligned; out (N, P) fp32. H * W < 2^26.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;           // points a thread holds at a time
constexpr int kChunk = kThreads * kPer;
constexpr int kMaxStages = 2;
// the plan's kernel
constexpr int kGather = 0;
constexpr int kStream = 1;
constexpr int kTiles = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// expect `bytes` of bulk-copy traffic on `bar` without arriving
__device__ __forceinline__ void expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::
                   "r"(sm90::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   sm90::smem_u32(bar))
               : "memory");
}

// one point of mask `m` (global or the staged band): `geo` is the top-left
// corner's element offset times 16 plus the in-map corner flags (0: no
// corner in the map)
template <typename T>
__device__ __forceinline__ float bilinear(const T* m, int geo, float lx,
                                          float ly, int W) {
  const int f = geo & 15;
  const int r = geo >> 4;
  float acc = 0.f;
  if (f & 1) acc = fmaf((1.f - lx) * (1.f - ly), to_float(m[r]), acc);
  if (f & 2) acc = fmaf(lx * (1.f - ly), to_float(m[r + 1]), acc);
  if (f & 4) acc = fmaf((1.f - lx) * ly, to_float(m[r + W]), acc);
  if (f & 8) acc = fmaf(lx * ly, to_float(m[r + W + 1]), acc);
  return acc;
}

// Warp 0 stages the band (`bytes` from `src`) of one mask into `buf`: the
// 16-byte aligned middle by one bulk copy, the unaligned head and tail by
// the lanes; every lane arrives on `bar` (its count is 32). The band's
// element e lands at buf + (src & 15) + e * sizeof(T).
template <typename T>
__device__ __forceinline__ void stage_band(uint8_t* buf, const T* src,
                                           long long bytes, uint64_t* bar,
                                           int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  T* dst = reinterpret_cast<T*>(buf + (a & 15));
  const uintptr_t a0 = (a + 15) & ~uintptr_t(15);
  const uintptr_t a1 = (a + bytes) & ~uintptr_t(15);
  int head, tail_at, tail;
  if (a1 > a0) {
    if (lane == 0) {
      expect_tx(bar, (uint32_t)(a1 - a0));
      bulk_load(dst + (a0 - a) / sizeof(T),
                reinterpret_cast<const void*>(a0), (uint32_t)(a1 - a0), bar);
    }
    head = (int)((a0 - a) / sizeof(T));
    tail_at = (int)((a1 - a) / sizeof(T));
    tail = (int)((a + bytes - a1) / sizeof(T));
  } else {  // under 32 bytes: all by the lanes
    head = (int)(bytes / sizeof(T));
    tail_at = head;
    tail = 0;
  }
  if (lane < head)
    dst[lane] = src[lane];
  else if (lane < head + tail)
    dst[tail_at + lane - head] = src[tail_at + lane - head];
  arrive(bar);
}

// the corner offset and flags (`bilinear`'s `geo`) and fractions of a point;
// returns the row of its top corners (-1 above the map), or -2 when no
// corner is in the map
__device__ __forceinline__ int geometry(float2 pt, int H, int W, int& geo,
                                        float& lx, float& ly) {
  // loc * size, then - 0.5, each rounded, as the plain version and JAX
  // round them (__fmul_rn is never contracted into an FMA)
  const float x = __fmul_rn(pt.x, (float)W) - 0.5f;
  const float y = __fmul_rn(pt.y, (float)H) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  geo = 0;
  lx = 0.f;
  ly = 0.f;
  if (x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
      y0f <= (float)(H - 1)) {
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    lx = x - x0f;
    ly = y - y0f;
    const int f = (x0 >= 0 && y0 >= 0 ? 1 : 0) |
                  (x0 + 1 < W && y0 >= 0 ? 2 : 0) |
                  (x0 >= 0 && y0 + 1 < H ? 4 : 0) |
                  (x0 + 1 < W && y0 + 1 < H ? 8 : 0);
    geo = (y0 * W + x0) * 16 + f;  // f != 0: a corner is in the map
    return y0;
  }
  return -2;
}

// One mask at a time: the CTA takes `tile` points of the call's N * P
// (mask by mask, so that the CTAs share the work evenly), each mask staged
// whole in shared memory, `stages` masks' copies ahead (they start at
// once), and its points stream through in chunks of kPer a thread, the
// next chunk's loads in flight while this one is gathered.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
point_sample_stream_kernel(const T* __restrict__ masks,
                           const float2* __restrict__ points,
                           float* __restrict__ out, int N, int H, int W,
                           int P, int S, int tile, int buf_bytes,
                           int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kMaxStages];
  const long long HW = (long long)H * W;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) sm90::mbar_init(&full[s], 32);
    sm90::mbar_fence_init();
  }
  const long long b0 = (long long)blockIdx.x * tile;
  const long long b1 = min(b0 + tile, (long long)N * P);
  const long long m0 = b0 / P;
  const int masks_of = (int)((b1 - 1) / P - m0 + 1);
  __syncthreads();  // the barriers are initialised
  if (tid < 32)
    for (int j = 0; j < min(stages, masks_of); ++j)
      stage_band(smem + j * buf_bytes, masks + (m0 + j) * HW,
                 HW * (long long)sizeof(T), &full[j], tid);
  for (int j = 0; j < masks_of; ++j) {
    const long long m = m0 + j;
    const int p0 = j == 0 ? (int)(b0 - m0 * P) : 0;
    const int np = (int)min(b1 - m * P, (long long)P) - p0;
    const int s = j % stages;
    const T* src = masks + m * HW;
    const T* b = reinterpret_cast<const T*>(
        smem + s * buf_bytes + (reinterpret_cast<uintptr_t>(src) & 15));
    const float2* pts = points + (m / S) * P + p0;
    float* o = out + m * P + p0;
    float2 nxt[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = tid + k * kThreads;
      if (p < np) nxt[k] = pts[p];
    }
    for (int c0 = 0; c0 < np; c0 += kChunk) {
      float2 cur[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        cur[k] = nxt[k];
        const int p = c0 + kChunk + tid + k * kThreads;
        if (p < np) nxt[k] = pts[p];
      }
      if (c0 == 0) sm90::mbar_wait(&full[s], (uint32_t)((j / stages) & 1));
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int p = c0 + tid + k * kThreads;
        if (p < np) {
          int geo;
          float lx, ly;
          geometry(cur[k], H, W, geo, lx, ly);
          o[p] = bilinear(b, geo, lx, ly, W);
        }
      }
    }
    if (j + stages < masks_of) {
      __syncthreads();  // every thread is done with buffer s
      if (tid < 32)
        stage_band(smem + s * buf_bytes, masks + (m + stages) * HW,
                   HW * (long long)sizeof(T), &full[s], tid);
    }
  }
}

// The tile of CTA `blockIdx.x` in the grouped grid: (set, group, tile),
// tiles fastest, so that a group's tiles run together and share its masks
// in L2.
struct GroupTile {
  long long set, m0;
  int p0, np, nm;
};

__device__ __forceinline__ GroupTile group_tile(int P, int S, int tile,
                                                int tiles, int group,
                                                int groups) {
  long long blk = blockIdx.x;
  const int ti = (int)(blk % tiles);
  blk /= tiles;
  const int gi = (int)(blk % groups);
  GroupTile g;
  g.set = blk / groups;
  g.p0 = ti * tile;
  g.np = min(tile, P - g.p0);
  g.nm = min(group, S - gi * group);
  g.m0 = g.set * S + gi * group;
  return g;
}

// The tile kernel: the CTA's tile of at most kChunk points keeps its
// geometry in registers for the group's masks, finds the band of rows its
// corners touch, and stages each mask's band (double-buffered across the
// masks) when it fits the buffer, else gathers from device memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
point_sample_tile_kernel(const T* __restrict__ masks,
                         const float2* __restrict__ points,
                         float* __restrict__ out, int H, int W, int P, int S,
                         int tile, int tiles, int group, int groups,
                         int buf_bytes, int stages) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kMaxStages];
  __shared__ int red[2][kWarps];

  const long long HW = (long long)H * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) sm90::mbar_init(&full[s], 32);
    sm90::mbar_fence_init();
  }
  const GroupTile g = group_tile(P, S, tile, tiles, group, groups);
  const float2* pts = points + g.set * P + g.p0;

  // geometry of the tile's points, kept in registers for the group's
  // masks, and the band of rows they touch
  float lx[kPer], ly[kPer];
  int geo[kPer];
  int lo = 0x7fffffff, hi = -1;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = tid + k * kThreads;
    geo[k] = 0;
    lx[k] = 0.f;
    ly[k] = 0.f;
    if (p < g.np) {
      const int y0 = geometry(pts[p], H, W, geo[k], lx[k], ly[k]);
      if (y0 > -2) {
        lo = min(lo, max(y0, 0));
        hi = max(hi, min(y0 + 1, H - 1));
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    red[0][tid >> 5] = lo;
    red[1][tid >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
  }

  const long long band_bytes =
      hi < 0 ? 0 : (long long)(hi - lo + 1) * W * sizeof(T);
  if (hi < 0 || band_bytes + 15 > buf_bytes) {
    // the band does not fit: corners from device memory
    for (int j = 0; j < g.nm; ++j) {
      const T* m = masks + (g.m0 + j) * HW;
      float* o = out + (g.m0 + j) * P + g.p0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int p = tid + k * kThreads;
        if (p < g.np) o[p] = bilinear(m, geo[k], lx[k], ly[k], W);
      }
    }
    return;
  }

  // each mask's band in shared memory, double-buffered
  const int shift = lo * W * 16;
#pragma unroll
  for (int k = 0; k < kPer; ++k) geo[k] -= shift;  // flags unchanged
  const long long band_at = (long long)lo * W;
  if (tid < 32)
    for (int j = 0; j < min(stages, g.nm); ++j)
      stage_band(smem + j * buf_bytes, masks + (g.m0 + j) * HW + band_at,
                 band_bytes, &full[j], lane);
  for (int j = 0; j < g.nm; ++j) {
    const int s = j % stages;
    sm90::mbar_wait(&full[s], (uint32_t)((j / stages) & 1));
    const T* src = masks + (g.m0 + j) * HW + band_at;
    const T* b = reinterpret_cast<const T*>(
        smem + s * buf_bytes + (reinterpret_cast<uintptr_t>(src) & 15));
    float* o = out + (g.m0 + j) * P + g.p0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = tid + k * kThreads;
      if (p < g.np) o[p] = bilinear(b, geo[k], lx[k], ly[k], W);
    }
    if (j + stages < g.nm) {
      __syncthreads();  // every thread is done with buffer s
      if (tid < 32)
        stage_band(smem + s * buf_bytes,
                   masks + (g.m0 + j + stages) * HW + band_at, band_bytes,
                   &full[s], lane);
    }
  }
}

// The gather kernel: one thread per (mask, point), the corners read from
// device memory; no shared memory, so many warps an SM hide the reads'
// latency. Its index arithmetic is I: 32-bit where the call's points allow
// (a 64-bit division costs these cheap threads several percent).
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
point_sample_gather_kernel(const T* __restrict__ masks,
                           const float2* __restrict__ points,
                           float* __restrict__ out, int H, int W, I P, I S,
                           I n_points) {
  const I i = (I)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_points) return;
  const I n = i / P;
  int geo;
  float lx, ly;
  geometry(points[S == 1 ? i : (n / S) * P + (i - n * P)], H, W, geo, lx,
           ly);
  out[i] = bilinear(masks + (long long)n * H * W, geo, lx, ly, W);
}

// Dynamic shared memory of `stages` buffers for `kernel`, then the launch.
// CUDA refuses a size beyond what a CTA may take.
template <typename K, typename... A>
int launch_staged(K kernel, unsigned blocks, int buf_bytes, int stages,
                  cudaStream_t s, A... args) {
  const int smem = stages * buf_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* masks, const void* points, void* out, int N, int H,
           int W, int P, int S, int kernel, int tile, int tiles, int group,
           int groups, int buf_bytes, int stages, cudaStream_t s) {
  const long long blocks =
      kernel == kTiles ? (long long)(N / S) * groups * tiles : tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const T* m = static_cast<const T*>(masks);
  const float2* pts = static_cast<const float2*>(points);
  float* o = static_cast<float*>(out);
  if (kernel == kGather) {
    const long long n_points = (long long)N * P;
    if (n_points <= 0xffffffffLL)
      point_sample_gather_kernel<T, unsigned>
          <<<(unsigned)blocks, kThreads, 0, s>>>(m, pts, o, H, W, P, S,
                                                 (unsigned)n_points);
    else
      point_sample_gather_kernel<T, unsigned long long>
          <<<(unsigned)blocks, kThreads, 0, s>>>(m, pts, o, H, W, P, S,
                                                 n_points);
    return (int)cudaGetLastError();
  }
  if (kernel == kStream)
    return launch_staged(point_sample_stream_kernel<T>, (unsigned)blocks,
                         buf_bytes, stages, s, m, pts, o, N, H, W, P, S,
                         tile, buf_bytes, stages);
  return launch_staged(point_sample_tile_kernel<T>, (unsigned)blocks,
                       buf_bytes, stages, s, m, pts, o, H, W, P, S, tile,
                       tiles, group, groups, buf_bytes, stages);
}

}  // namespace

// The plan (`ops/point_sample.py::fwd_plan`): `kernel` kGather (CTAs of
// `tile` = kThreads points of the call's N * P, one a thread), kStream
// (CTAs of `tile` of the call's points, `stages` buffers of `buf_bytes`,
// each holding a whole map) or kTiles (CTAs of `tile` points of a set,
// `tiles` a set, times `groups` of `group` masks, `stages` buffers of
// `buf_bytes` for a band; 0: every tile gathers from device memory).
// Buffers are multiples of 16 bytes. Returns a cudaError_t.
extern "C" int point_sample_fwd(const void* masks, const void* points,
                                void* out, int N, int H, int W, int P, int S,
                                int kernel, int tile, int tiles, int group,
                                int groups, int buf_bytes, int stages,
                                int is_bf16, void* stream) {
  if (N < 0 || H < 1 || W < 1 || P < 0 || S < 1 || N % S != 0 ||
      (long long)H * W >= (1LL << 26) || kernel < kGather || kernel > kTiles)
    return (int)cudaErrorInvalidValue;
  if (N == 0 || P == 0) return (int)cudaSuccess;
  // the tiles cover the call's points (a set's with kTiles), the groups a
  // set's masks (kTiles; else one group of one)
  const bool tiled = kernel == kTiles;
  const long long span = tiled ? P : (long long)N * P;
  const int masks_of = tiled ? S : 1;
  const long long whole = (long long)H * W * (is_bf16 ? 2 : 4) + 15;
  if (tile < 1 || tiles < 1 || (long long)tile * tiles < span ||
      (long long)tile * (tiles - 1) >= span || group < 1 || groups < 1 ||
      (long long)group * groups < masks_of ||
      (long long)group * (groups - 1) >= masks_of || stages < 1 ||
      stages > kMaxStages || buf_bytes < 0 || buf_bytes % 16 != 0 ||
      (kernel == kGather && (tile != kThreads || buf_bytes != 0)) ||
      (kernel == kStream && buf_bytes < whole) ||
      (tiled && tile > kChunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(masks, points, out, N, H, W, P, S, kernel,
                                 tile, tiles, group, groups, buf_bytes,
                                 stages, s);
  return launch<float>(masks, points, out, N, H, W, P, S, kernel, tile, tiles,
                       group, groups, buf_bytes, stages, s);
}

extern "C" const char* point_sample_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
