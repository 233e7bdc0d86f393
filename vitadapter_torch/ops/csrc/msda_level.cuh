// Shared by the MSDA kernels msda_level_fwd.cu and msda_level_dgrid.cu
// (one level a launch) and msda_fwd.cu and msda_bwd.cu (all levels in one
// launch): one thread mapping, one geometry, one edge convention.
//
// Thread mapping. A warp is cut into teams of G lanes, one team per
// (batch, query, head); lane gl of a team owns the 16-byte chunks gl,
// gl + G, ... of the D-wide value row (and of the accumulator or g row).
// The grid is (query tiles, heads, batch), so a block's teams take
// neighbouring queries of one head and no lane divides. A point's
// geometry (corner rows, in-map mask, bilinear fractions, weight) is
// computed once, by lane t of the team for point t, and handed to the
// team's lanes by five shuffles per point (one shuffle instruction serves
// every team of the warp); each lane then issues its chunk's corner loads.
// A first version computed each point's geometry in every lane of a group
// of lanes per point; on the H100 it was bound by instruction issue (a
// variant of it that loaded nothing took most of its time).
//
// Two instantiations of each kernel, chosen at launch:
// - vector: a row of D elements, a multiple of VEC, at 16-byte aligned
//   pointers; VEC = 16 / sizeof(T) elements a chunk (one float4 or eight
//   bf16) unless a kernel says otherwise, K chunks a lane, G = the next
//   power of two of the row's chunks over K (lanes past the last chunk of a
//   ragged row idle): at D 32 and K = 1, 8 lanes (fp32) or 4 (bf16) per
//   (query, head);
// - scalar: any other row or pointer; VEC = 1, G = 32, K = ceil(D / 32)
//   elements a lane (D <= 64), one team per warp.
// A team takes its points in rounds of G, one point per lane, so any P.
// The multi-level kernels walk the L * P points of a (batch, query, head)
// level by level in those rounds: lane t finds its point's level (i / P)
// in a table staged in shared memory (a kernel parameter indexed by a
// runtime level is copied to local memory) and hands the team that
// level's row width with the point (`locate_level`).
//
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msda_level {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;

// VEC elements of a row from p as fp32: one 16-byte load (VEC = 4 fp32 or
// 8 bf16), or one element (VEC = 1). The value and g are read only.
template <int VEC>
__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    static_assert(VEC == 1, "fp32 chunks are 4 elements or 1");
    out[0] = __ldg(p);
  }
}

// bf16 to fp32 is exact: the bf16 bits are the fp32 number's high half.
// Shifting the loaded bits keeps every value in registers (taking the
// address of a loaded vector, or of a bf16, puts it on the stack).
template <int VEC>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (VEC == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
  } else {
    static_assert(VEC == 1, "bf16 chunks are 8, 4 or 1 elements");
    const unsigned short bits =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    out[0] = __uint_as_float((uint32_t)bits << 16);
  }
}

// VEC fp32 sums stored as VEC elements of T at p (16-byte aligned for
// VEC > 1): one 16-byte store.
template <int VEC>
__device__ __forceinline__ void store_chunk(float* p, const float* in) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    static_assert(VEC == 1, "fp32 chunks are 4 elements or 1");
    p[0] = in[0];
  }
}

// Rounded to nearest even, as the plain version's `.to(torch.bfloat16)`.
template <int VEC>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float* in) {
  if constexpr (VEC == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(in[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(in[2 * i + 1]))
              << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    static_assert(VEC == 1, "bf16 chunks are 8 elements or 1");
    p[0] = __float2bfloat16(in[0]);
  }
}

// Adds s * in[e] to the VEC fp32 elements at p (16-byte aligned for VEC >
// 1): one vector atomic per four elements (sm_90's red.global.add.v4.f32),
// a scalar one for VEC = 1. The result is not read, so these compile to
// reductions that do not wait for the memory.
template <int VEC>
__device__ __forceinline__ void atomic_add_chunk(float* p, const float* in,
                                                 float s) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      atomicAdd(reinterpret_cast<float4*>(p) + i,
                make_float4(s * in[4 * i], s * in[4 * i + 1],
                            s * in[4 * i + 2], s * in[4 * i + 3]));
  } else {
    static_assert(VEC == 1, "chunks are 4, 8 or 1 elements");
    atomicAdd(p, s * in[0]);
  }
}

// One bilinear point of an (H, W) map, as the team's lanes use it.
struct Point {
  int row0;       // the top-left corner's cell, y0 * W + x0
  unsigned mask;  // bit c: corner c = dx + 2 dy is on the map
  float fx, fy;   // fractional offsets from the top-left corner
  float a;        // its attention weight
};

// The point at location (lx01, ly01) in [0, 1] with weight a; `has`
// false (no such point) gives an empty mask.
__device__ __forceinline__ Point locate(float lx01, float ly01, float a,
                                        bool has, int H, int W) {
  const float x = __fmul_rn(lx01, (float)W) - 0.5f;
  const float y = __fmul_rn(ly01, (float)H) - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  Point pt;
  pt.fx = x - x0f;
  pt.fy = y - y0f;
  pt.a = a;
  pt.row0 = 0;
  pt.mask = 0;
  if (has && x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
      y0f <= (float)(H - 1)) {
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    pt.row0 = y0 * W + x0;
    pt.mask = (x0 >= 0 && y0 >= 0 ? 1u : 0u) |
              (x0 + 1 < W && y0 >= 0 ? 2u : 0u) |
              (x0 >= 0 && y0 + 1 < H ? 4u : 0u) |
              (x0 + 1 < W && y0 + 1 < H ? 8u : 0u);
  }
  return pt;
}

// Lane `src`'s point, for every lane (all 32 lanes call it).
__device__ __forceinline__ Point broadcast(const Point& pt, int src) {
  Point o;
  o.row0 = __shfl_sync(0xffffffffu, pt.row0, src);
  o.mask = __shfl_sync(0xffffffffu, pt.mask, src);
  o.fx = __shfl_sync(0xffffffffu, pt.fx, src);
  o.fy = __shfl_sync(0xffffffffu, pt.fy, src);
  o.a = __shfl_sync(0xffffffffu, pt.a, src);
  return o;
}

// The team layout of one lane.
struct Lanes {
  int b, m, q;    // its (batch, head, query)
  long long bqm;  // flat, in the (B, Lq, M) layouts
  int gl;         // its lane in the team
  int base;       // the team's first lane in the warp
  bool active;    // q < Lq
};

template <int G>
__device__ __forceinline__ Lanes lanes(int Lq, int M) {
  const int lane = threadIdx.x & 31;
  Lanes l;
  l.b = blockIdx.z;
  l.m = blockIdx.y;
  l.q = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / G) + lane / G;
  l.bqm = ((long long)l.b * Lq + l.q) * M + l.m;
  l.gl = lane & (G - 1);
  l.base = lane & ~(G - 1);
  l.active = l.q < Lq;
  return l;
}

// Loads this lane's chunks of the four corners of point pt into v (corner
// c = dx + 2 dy; K chunks of VEC elements each), zero for corners off the
// map. All loads are issued before any is used. vl points at the level's
// first row of this (batch, head); rs is the row stride (M * D); C the
// chunks of a row.
template <typename T, int VEC, int G, int K>
__device__ __forceinline__ void load_corners(const T* __restrict__ vl,
                                             long long rs, const Point& pt,
                                             int W, int gl, int C,
                                             float (&v)[4][K][VEC]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const T* row = vl + (long long)(pt.row0 + (c & 1) + (c >> 1) * W) * rs;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int ch = gl + G * k;
      if (((pt.mask >> c) & 1u) && ch < C) {
        load_chunk<VEC>(row + ch * VEC, v[c][k]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[c][k][e] = 0.f;
      }
    }
  }
}

// The levels of a multi-level value: level l is an (h[l], w[l]) map at
// value rows [start[l], start[l] + h[l] * w[l]).
struct LevelTable {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

// Copies the table into shared memory as (H, W, start) of each level, each
// entry read at a constant index, so the parameter stays in the constant
// bank. Every thread of the block calls it (it synchronises the block).
__device__ __forceinline__ void stage_levels(const LevelTable& t, int4* s) {
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (threadIdx.x == l) s[l] = make_int4(t.h[l], t.w[l], t.start[l], 0);
  __syncthreads();
}

// Point i of the L * P points (level-major) of the lane's (batch, query,
// head), whose locations and weights start at lp and ap, as this lane
// computes it for its team; `has` false gives an empty mask. The corner
// row is the value row (the level's start added), and mask bits 4 and up
// carry the level's W for the lanes that take the point by `broadcast`.
// H and W are the point's level's.
__device__ __forceinline__ Point locate_level(const float* __restrict__ lp,
                                              const float* __restrict__ ap,
                                              int i, int P, bool has,
                                              const int4* levels, int& H,
                                              int& W) {
  const int4 lv = levels[has ? i / P : 0];
  H = lv.x;
  W = lv.y;
  float lx = 0.f, ly = 0.f, a = 0.f;
  if (has) {
    lx = lp[2 * i];
    ly = lp[2 * i + 1];
    a = ap[i];
  }
  Point pt = locate(lx, ly, a, has, H, W);
  pt.row0 += lv.z;
  pt.mask |= (unsigned)W << 4;
  return pt;
}

inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch shape of a level: the team geometry and the grid.
struct Shape {
  bool vec;  // the vector instantiation
  int G, K;
  dim3 grid;
  bool fits;  // the grid is within the card's limits
};

// `aligned`: the pointers the vector loads read or write are 16-byte
// aligned. V: the elements of a vector chunk (16 bytes by default); K: the
// chunks a lane of the vector instantiation owns, so the team is the
// next power of two of the row's chunks over K.
template <typename T, int V = 16 / sizeof(T)>
inline Shape shape(int D, bool aligned, int B, int Lq, int M, int K = 1) {
  Shape s;
  s.vec = aligned && D % V == 0;
  if (s.vec) {
    s.G = next_pow2((D / V + K - 1) / K);
    s.K = K;
  } else {
    s.G = 32;
    s.K = (D + 31) / 32;
  }
  const long long per_block = (long long)kWarps * (32 / s.G);
  const long long tiles = (Lq + per_block - 1) / per_block;
  s.fits = tiles <= 0x7fffffffLL && M <= 65535 && B <= 65535;
  s.grid = dim3((unsigned)(s.fits ? tiles : 1), (unsigned)M, (unsigned)B);
  return s;
}

}  // namespace msda_level
