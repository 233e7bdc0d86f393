// Bilinear point sampling backward (grad of the masks), hand-written for
// Hopper (sm_90a).
//
// Replaces: vitadapter/ops/point_sample_pallas.py::_bwd_kernel (via _bwd),
// which computes d mask = sum_p Ry[:, p] g[p] Rx[:, p]^T as one MXU
// contraction over each point tile, the mask's whole accumulator resident
// in VMEM across the sequential tile axis and written once. grad_points is
// zero by definition there (point_sample_pallas.py:20-24) and is not
// computed here either.
//
// What bounds it on an H100: bytes. A call reads every point's (x, y) and
// g once and writes every cell of d mask once; the flagship's call (400
// masks of 128 x 128, 12,544 points each) moves 73.3 MB, 22 us at 3.35
// TB/s. The adds (about 4 per point) are shared-memory work.
//
// Design: the TPU kernel's resident accumulator, in the shared memory of a
// thread-block cluster. One cluster per (mask, row group); each CTA of the
// cluster owns a band of `rows` rows of the mask's fp32 accumulator in its
// shared memory and zeroes it, then cluster barrier. The cluster's CTAs
// split the mask's points into contiguous shares (so with points sorted by
// y, as the loss sorts them, a CTA's corners mostly fall in its own band);
// each point's corner weights are computed once, and each in-map corner is
// added where its row lives: a shared-memory atomic for the CTA's own
// band, a distributed-shared-memory reduction (`red.shared::cluster`) for
// a neighbour's. Cluster barrier; then each CTA converts its band to the
// mask dtype and writes it once, with 16-byte stores (a scalar head and
// tail where the band's start or end is not 16-byte aligned). No global
// atomics, no fp32 scratch in device memory, no memset, no second kernel.
// The host picks the cluster size and the rows per CTA from H x W
// (`ops/point_sample.py::bwd_plan`): a map that the largest portable
// cluster (8 CTAs of at most 227 KB) cannot hold is cut into row groups,
// each its own cluster that reads all the mask's points and keeps the
// corners in its rows. A cluster of 1 is a plain CTA (no cluster barrier).
// Corners off the map add nothing, and neither does a point with no corner
// on the map or a NaN point. The bilinear weights and the sums are fp32;
// the result is rounded once to the mask dtype.
//
// Measured (tools/kernel_variants.py point_sample_bwd, H100 80GB HBM3 at
// 700 W; ms per flagship bf16 step of 10 calls, sorted points): kept 0.71.
// Hopper has no shared-memory fp32 atomic add: atomicAdd is a compare-and-
// swap loop, and integer atomics on the bits in its place (an ablation)
// take 0.49, no adds at all 0.46, so the loop costs about a third. A
// neighbour's corner is a generic atomic that waits for its reply; with
// sorted points few are, but unsorted points send half the corners there
// and take 3.4 (one CTA a mask, no cluster: 0.99 on both orders). Not
// kept, sorted: one CTA a mask 0.99; bands that each scan all the mask's
// points, no DSMEM, 0.83; clusters of 4 and 8 0.82 and 1.00; every add
// through DSMEM 0.81; 256 or 512 threads 0.85 or 0.78; no prefetch 0.80;
// 32 registers spill. Over-line step (448x448, clusters of 8): 1.05.
//
// Determinism: NOT deterministic. The shared-memory atomics sum the points
// of one cell in an order that changes from run to run (the TPU kernel's
// contraction is deterministic). Checks use a tolerance that covers the
// reassociation.
//
// Layouts (all contiguous): points (N, P, 2) fp32, 8-byte aligned; g (N, P)
// fp32; dmask (N, H, W) in the mask dtype (fp32 or bf16), every cell
// written.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// 384 threads and at most 40 registers (no spill): 4 CTAs of 33 KB (a band
// of 32 KB) an SM, 1536 threads
constexpr int kThreads = 384;
constexpr int kMinBlocks = 4;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kMaxSmem = 232448;       // 227 KB: a CTA's shared memory
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void cluster_or_block_sync(int cluster) {
  if (cluster > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// acc[idx] of CTA `rank` of this cluster += v
__device__ __forceinline__ void add_remote(const float* acc, int idx,
                                           unsigned rank, float v) {
  const unsigned local =
      static_cast<unsigned>(__cvta_generic_to_shared(acc + idx));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("red.shared::cluster.add.f32 [%0], %1;" ::"r"(remote),
               "f"(v)
               : "memory");
}

__device__ __forceinline__ void store16(float* out, const float* v) {
  *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* v) {
  *reinterpret_cast<uint4*>(out) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16(v);
}

// Adds point pt's in-map corners (g * bilinear weight) that fall in the
// group's rows [g0, g1) to the band of the CTA that owns each row.
__device__ __forceinline__ void add_point(float* acc, float2 pt, float gv,
                                          int H, int W, int rows, int g0,
                                          int g1, int rank) {
  // loc * size, then - 0.5, each rounded, as the plain version and JAX
  // round them (__fmul_rn is never contracted into an FMA)
  const float x = __fmul_rn(pt.x, (float)W) - 0.5f;
  const float y = __fmul_rn(pt.y, (float)H) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  // no corner on the map, or NaN: nothing to add
  if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
        y0f <= (float)(H - 1)))
    return;
  const float lx = x - x0f;
  const float ly = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  // the top corner row's owner and row in its band (rel -1: owner -1,
  // last row, so that the bottom corner row is owner 0's first)
  const int rel = y0 - g0;
  int owner = rel < 0 ? -1 : (int)((unsigned)rel / (unsigned)rows);
  int band_row = rel - owner * rows;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    if (dy && ++band_row == rows) {
      ++owner;
      band_row = 0;
    }
    const int yi = y0 + dy;
    if (yi < g0 || yi >= g1) continue;
    const float wy = dy ? ly : 1.f - ly;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xi = x0 + dx;
      if (xi < 0 || xi >= W) continue;
      const float v = gv * ((dx ? lx : 1.f - lx) * wy);
      if (owner == rank)
        atomicAdd(acc + band_row * W + xi, v);
      else
        add_remote(acc, band_row * W + xi, (unsigned)owner, v);
    }
  }
}

// Grid: one CTA per (mask, row group, rank), rank fastest, in clusters of
// `cluster` CTAs along x. CTA `rank` of group `grp` owns rows
// [grp * cluster * rows + rank * rows, + rows) of the mask, clipped to H.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
point_sample_bwd_kernel(const float* __restrict__ points,
                        const float* __restrict__ g, T* __restrict__ dmask,
                        int H, int W, int P, int cluster, int rows,
                        int groups) {
  extern __shared__ float4 smem[];
  float* acc = reinterpret_cast<float*>(smem);
  const int rank = (int)(blockIdx.x % cluster);
  const int cid = (int)(blockIdx.x / cluster);
  const int grp = cid % groups;
  const int n = cid / groups;
  const int g0 = grp * cluster * rows;              // the group's first row
  const int g1 = min(H, g0 + cluster * rows);       // and its end
  const int r0 = g0 + rank * rows;                  // this CTA's first row
  const int cells = max(0, min(rows, H - r0)) * W;  // its band's cells

  for (int i = threadIdx.x; i < cells / 4; i += kThreads)
    smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = (cells & ~3) + threadIdx.x; i < cells; i += kThreads)
    acc[i] = 0.f;
  cluster_or_block_sync(cluster);

  // this CTA's share of the mask's points
  const int p_lo = (int)((long long)P * rank / cluster);
  const int p_hi = (int)((long long)P * (rank + 1) / cluster);
  const float2* pts =
      reinterpret_cast<const float2*>(points) + (long long)n * P;
  const float* gn = g + (long long)n * P;
  // one point at a time, the next one's loads in flight meanwhile
  int i = p_lo + threadIdx.x;
  float2 pt = make_float2(__int_as_float(0x7fc00000), 0.f);  // NaN: none
  float gv = 0.f;
  if (i < p_hi) {
    pt = __ldg(pts + i);
    gv = __ldg(gn + i);
  }
  for (; i < p_hi; i += kThreads) {
    const int j = i + kThreads;
    float2 pt_next = pt;
    float gv_next = 0.f;
    if (j < p_hi) {
      pt_next = __ldg(pts + j);
      gv_next = __ldg(gn + j);
    }
    add_point(acc, pt, gv, H, W, rows, g0, g1, rank);
    pt = pt_next;
    gv = gv_next;
  }
  cluster_or_block_sync(cluster);

  // the band, once, in the mask dtype: 16-byte stores between a scalar
  // head (up to the first 16-byte boundary) and tail
  constexpr int V = 16 / sizeof(T);
  T* out = dmask + ((long long)n * H + r0) * W;
  const int head = min(
      cells, (int)(((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) /
                   sizeof(T)));
  const int nvec = (cells - head) / V;
  for (int i = threadIdx.x; i < head; i += kThreads) store1(out + i, acc[i]);
  const bool aligned = (head & 3) == 0;  // acc + head on 16 bytes
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[V];
    const int at = head + i * V;
    if (aligned) {
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        const float4 q = smem[(at + e) >> 2];
        v[e] = q.x;
        v[e + 1] = q.y;
        v[e + 2] = q.z;
        v[e + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = acc[at + e];
    }
    store16(out + at, v);
  }
  for (int i = head + nvec * V + threadIdx.x; i < cells; i += kThreads)
    store1(out + i, acc[i]);
}

template <typename T>
cudaError_t launch(const float* points, const float* g, T* dmask, int N,
                   int H, int W, int P, int cluster, int rows, int groups,
                   size_t smem, cudaStream_t s) {
  if (smem > (size_t)kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        point_sample_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)N * groups * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, point_sample_bwd_kernel<T>, points, g, dmask,
                         H, W, P, cluster, rows, groups);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// d masks (N, H, W) of the mask dtype, every cell written, from points
// (N, P, 2) and g (N, P). `cluster` CTAs of `rows` rows each per row group
// (the plan of ops/point_sample.py::bwd_plan): 1 <= cluster <= 8, and a
// band of rows * W fp32 within a CTA's 227 KB. Returns a cudaError_t (a
// refused cluster launch included).
extern "C" int point_sample_bwd(const void* points, const void* g,
                                void* dmask, int N, int H, int W, int P,
                                int is_bf16, int cluster, int rows,
                                void* stream) {
  if (N < 0 || H < 1 || W < 1 || P < 0 || P > 0x7fffffff - kThreads ||
      cluster < 1 || cluster > kMaxCluster || rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)rows * (size_t)W;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long span = (long long)cluster * rows;
  const int groups = (int)((H + span - 1) / span);
  if ((long long)N * groups * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* gf = static_cast<const float*>(g);
  const cudaError_t err =
      is_bf16 ? launch(p, gf, static_cast<__nv_bfloat16*>(dmask), N, H, W, P,
                       cluster, rows, groups, smem, s)
              : launch(p, gf, static_cast<float*>(dmask), N, H, W, P,
                       cluster, rows, groups, smem, s);
  return (int)err;
}

extern "C" const char* point_sample_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
