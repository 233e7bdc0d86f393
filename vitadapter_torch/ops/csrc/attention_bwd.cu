// Fused multi-head attention backward, hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/attention_pallas.py::_bwd_kernel (via
// _fused_mha_bwd), which recomputes the whole (N, N) fp32 probability matrix
// of one (batch, head) in VMEM from q, k, v and emits dq, dk, dv.
//
// What bounds it on an H100: operations. At the flagship shape (N = 1024,
// 16 heads, D = 64) the gradient needs about 10 N^2 D = 10.7 GFLOP per image
// (S = q k^T again, dP = dO v^T, dv = P^T dO, dq = dS k, dk = dS^T q)
// against 18.9 MB of q/k/v/dO/dq/dk/dv (bf16) and O (fp32), about 570 FLOP
// per byte.
//
// The forward saves its output O in fp32 and the row log-sum-exp (lse,
// fp32); the TPU kernel saves only q, k, v and recomputes both. Keeping
// them is a card-side choice that leaves the gradient the same function and
// spares the backward a pass over all keys. Three launches behind one entry
// point, in order on the caller's stream, none with atomics:
//   0. attention_bwd_delta: delta_i = rowsum(dO * O), fp32, a warp per row;
//   1. dq, one CTA per (batch * head, 64-query tile), walking the key
//      tiles: P = exp(S - lse), dS = P (dP - delta), dq += dS k;
//   2. dk and dv, one CTA per (batch * head, 64-key tile), walking the
//      query tiles: dv += P^T dO, dk += dS^T q.
// Deterministic: every output element is summed by one thread in a fixed
// order.
//
// Design, bf16 (the main path): one warpgroup (128 threads) per CTA, every
// product on the tensor cores by wgmma, staged as in attention_fwd.cu: TMA
// loads the CTA's own two tiles once and streams the other side's two
// tiles through a 2-stage ring of mbarrier-completed stages (sm90.cuh).
// S and dP (dq kernel) or S^T and dP^T (dk/dv kernel, keys as the rows) are
// wgmma products of two shared-memory tiles. P and dS stay in registers as
// the A operands of dq += dS k, dv += P^T dO and dk += dS^T q. Their inputs
// are bf16 already, so S and dP are exact products summed in fp32.
//
// Numerics, bf16: P and dS are fp32 values that wgmma can only take as
// bf16. The TPU kernel rounds them to bf16 (attention_pallas.py:85, :94),
// about 1e-3 of a typical gradient element, which breaks the card's 1e-5 x
// max floor on elements near zero. Here each is fed as a hi/lo pair, hi =
// bf16(x), lo = bf16(x - hi): two products per such GEMM, about 2^-17
// relative. delta reads O in fp32: from a bf16 O its error (about 2^-9 of
// O's elements, summed over D) moves dq and dk by more than that floor.
//
// fp32 keeps the CUDA-core kernels (256 threads as a 16 x 16 grid over 64 x
// 64 tiles, fp32 FMAs; TF32 would miss the fp32 tolerance), reading the
// saved lse and delta as the bf16 kernels do.
//
// Layouts (all contiguous): q, k, v, dout, dq, dk, dv (B * H, N, D), bf16
// or fp32; o (B * H, N, D) fp32; lse, delta (B * H, N) fp32 (delta is
// scratch, written here).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- 0. delta = rowsum(dO * O) -------------------------------------------

constexpr int kDeltaWarps = 8;

template <typename T, int D>
__global__ void __launch_bounds__(32 * kDeltaWarps)
attention_bwd_delta(const float* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ delta, long long rows) {
  const long long row =
      (long long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  float sum = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    sum = fmaf(o[row * D + c], to_float(dout[row * D + c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[row] = sum;
}

// ---- fp32: CUDA cores ----------------------------------------------------

constexpr int kB = 64;  // query rows or keys per tile
constexpr int kThreads = 256;

// rows [r0, r0 + 64) of a (N, D) matrix into a (64, D + 1) fp32 tile, zero
// past N
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int N, int tid) {
  constexpr int DP = D + 1;
  for (int idx = tid; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * DP + c] = gr < N ? src[(long long)gr * D + c] : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles padded by one word per row; dS tile padded
  return 4 * kB * (D + 1) + kB * (kB + 1);
}

template <int D>
constexpr int dkdv_smem_floats() {
  // K, V, Q, dO tiles; P and dS tiles; lse and delta of the query tile
  return 4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int N, int n_tiles, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * DP;
  float* Ks = dOs + kB * DP;
  float* Vs = Ks + kB * DP;
  float* Ps = Vs + kB * DP;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kB;
  const long long base = bh * (long long)N * D;

  load_tile<D>(Qs, q + base, q0, N, tid);
  load_tile<D>(dOs, dout + base, q0, N, tid);

  float acc[4][DC];  // dq
  float lr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lr[i] = r < N ? lse[bh * N + r] : 0.f;  // rows past N: zero q and dO
    dr[i] = r < N ? delta[bh * N + r] : 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  // dS = P (dP - delta), dq += dS k
  for (int k0 = 0; k0 < N; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k + base, k0, N, tid);
    load_tile<D>(Vs, v + base, k0, N, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * DP + d];
        oa[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * DP + d];
        vb[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + tx + 16 * j < N;
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float da[4], kb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) da[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) kb[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(da[i], kb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= N) continue;
    float* o = dq + base + (long long)r * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int N,
                       int n_tiles, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * DP;
  float* Qs = Vs + kB * DP;
  float* dOs = Qs + kB * DP;
  float* Ps = dOs + kB * DP;
  float* dSs = Ps + kB * PP;
  float* lse_s = dSs + kB * PP;
  float* D_s = lse_s + kB;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kB;
  const long long base = bh * (long long)N * D;

  load_tile<D>(Ks, k + base, k0, N, tid);
  load_tile<D>(Vs, v + base, k0, N, tid);
  bool key_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) key_ok[j] = k0 + tx + 16 * j < N;

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Qs, q + base, q0, N, tid);
    load_tile<D>(dOs, dout + base, q0, N, tid);
    if (tid < kB) {
      const int gr = q0 + tid;
      lse_s[tid] = gr < N ? lse[bh * N + gr] : INFINITY;  // P = 0 past N
      D_s[tid] = gr < N ? delta[bh * N + gr] : 0.f;
    }
    __syncthreads();
    // tile (query row ty + 16 i, key tx + 16 j)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], oa[4], kb[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty + 16 * i) * DP + d];
        oa[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kb[j] = Ks[(tx + 16 * j) * DP + d];
        vb[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float l = lse_s[r];
      const float dd = D_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = key_ok[j] ? expf(s[i][j] * scale - l) : 0.f;
        Ps[r * PP + tx + 16 * j] = p;
        dSs[r * PP + tx + 16 * j] = p * (dp[i][j] - dd);
      }
    }
    __syncthreads();
    // (key ty + 16 i, channel tx + 16 j): sum over the tile's query rows
#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      float pa[4], sa[4], ob[DC], qb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = Ps[r * PP + ty + 16 * i];
        sa[i] = dSs[r * PP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        ob[j] = dOs[r * DP + tx + 16 * j];
        qb[j] = Qs[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          dva[i][j] = fmaf(pa[i], ob[j], dva[i][j]);
          dka[i][j] = fmaf(sa[i], qb[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= N) continue;
    float* ok = dk + base + (long long)r * D;
    float* ov = dv + base + (long long)r * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      ok[tx + 16 * j] = dka[i][j] * scale;
      ov[tx + 16 * j] = dva[i][j];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *o, *lse;
  void *dq, *dk, *dv;
  float* delta;
  int BH, N;
  float scale;
};

template <typename T, int D>
cudaError_t launch_delta(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.BH * a.N;
  const long long blocks = (rows + kDeltaWarps - 1) / kDeltaWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  attention_bwd_delta<T, D><<<(unsigned)blocks, 32 * kDeltaWarps, 0,
                              stream>>>(a.o, static_cast<const T*>(a.dout),
                                        a.delta, rows);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const int n_tiles = (a.N + kB - 1) / kB;
  const long long blocks = (long long)a.BH * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_delta<float, D>(a, stream);
  if (err != cudaSuccess) return err;
  const float* qq = static_cast<const float*>(a.q);
  const float* kk = static_cast<const float*>(a.k);
  const float* vv = static_cast<const float*>(a.v);
  const float* oo = static_cast<const float*>(a.dout);

  const size_t smem_dq = sizeof(float) * dq_smem_floats<D>();
  auto kdq = attention_bwd_dq_f32<D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return err;
  kdq<<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      qq, kk, vv, oo, a.lse, a.delta, static_cast<float*>(a.dq), a.N,
      n_tiles, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = sizeof(float) * dkdv_smem_floats<D>();
  auto kkv = attention_bwd_dkdv_f32<D>;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  kkv<<<(unsigned)blocks, kThreads, smem_kv, stream>>>(
      qq, kk, vv, oo, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.N, n_tiles, a.scale);
  return cudaGetLastError();
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kRows = 64;   // rows of every tile
constexpr int kTcThreads = 128;
// the CTA's own two tiles, a 2-stage ring of the streamed side's tile
// pairs, and the streamed query tile's lse and delta (dk/dv kernel)
template <int D>
using BwdStaging = sm90::Staging<D, 2, 2, 2 * kRows * 4>;

// acc (64 x 64) = A B^T + C D^T over the inner dimension D: two products
// of K-major shared-memory tiles, into zeroed accumulators
template <int D>
__device__ __forceinline__ void two_products(float (&x)[32], uint32_t a,
                                             uint32_t b, float (&y)[32],
                                             uint32_t c, uint32_t d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
  sm90::fence_regs(x);
  sm90::fence_regs(y);
  sm90::wg_fence();
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
    sm90::mma_ss_n64(x, sm90::desc_k<D, kRows>(a, t),
                     sm90::desc_k<D, kRows>(b, t));
#pragma unroll
  for (int t = 0; t < D / 16; ++t)
    sm90::mma_ss_n64(y, sm90::desc_k<D, kRows>(c, t),
                     sm90::desc_k<D, kRows>(d, t));
  sm90::wg_commit();
}

// acc (64 x D) += X B, X (64 x 64) from the registers x as hi/lo bf16
// pairs, B a (64, D) MN-major shared-memory tile; issued, not waited for
template <int D, int NC, int NW>
__device__ __forceinline__ void split_product(float (&acc)[NC][NW],
                                              const float (&x)[32],
                                              uint32_t b) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::frag_hi_lo(x, kk, hi[kk], lo[kk]);
#pragma unroll
  for (int c = 0; c < NC; ++c) sm90::fence_regs(acc[c]);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint64_t bd = sm90::desc_mn<D, kRows>(b, kk, c);
      sm90::mma_rs(acc[c], hi[kk], bd);
      sm90::mma_rs(acc[c], lo[kk], bd);
    }
  sm90::wg_commit();
}

// rows < N of a (64, D) accumulator times `mul`, as bf16
template <int NC, int NW, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[NC][NW],
                                           __nv_bfloat16* __restrict__ dst,
                                           int r0, int N, float mul) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= N) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < NW / 4; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)r * D + c * 64 +
                                           8 * j + col0) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * h] * mul,
                                  acc[c][4 * j + 2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int N, int n_tiles,
                      float scale) {
  using T = sm90::Tile<D, kRows>;
  constexpr int NC = D == 128 ? 2 : 1;
  constexpr int NW = D == 32 ? 16 : 32;
  extern __shared__ uint8_t smem_raw[];
  BwdStaging<D> ring(smem_raw);
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  // own: Q, dO; ring: K, V
  if (threadIdx.x == 0) ring.start(&tq, &tdo, q0, &tk, &tv, bh, n_tiles);

  const int lane = threadIdx.x & 31;
  const int row = q0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const float sl2 = scale * sm90::kLog2e;
  float l2[2], dl[2];  // rows row, row + 8: lse (base 2) and delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;  // rows past N: zero q and dO, not stored
    l2[h] = r < N ? lse[(long long)bh * N + r] * sm90::kLog2e : 0.f;
    dl[h] = r < N ? delta[(long long)bh * N + r] : 0.f;
  }
  float acc[NC][NW];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NW; ++i) acc[c][i] = 0.f;

  ring.wait_own();
  const uint32_t qs = ring.own(0), dos = ring.own(1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const uint32_t ks = ring.wait(kt);
    const uint32_t vs = ks + T::BYTES;
    float sc[32], dp[32];
    two_products<D>(sc, qs, ks, dp, dos, vs);  // S = Q K^T, dP = dO V^T
    sm90::wg_wait_all();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    const bool ragged = (kt + 1) * kRows > N;  // keys past N: P = 0
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float p = sm90::ex2(fmaf(sc[i], sl2, -l2[h]));
      if (ragged && kt * kRows + 8 * (i >> 2) + col0 + (i & 1) >= N) p = 0.f;
      sc[i] = p * (dp[i] - dl[h]);  // dS
    }
    split_product<D>(acc, sc, ks);  // dq += dS K
    sm90::wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(acc[c]);
    ring.refill(&tk, &tv, kt, bh, n_tiles);
  }
  store_rows<NC, NW, D>(acc, dq + (long long)bh * N * D, q0, N, scale);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int N, int n_tiles,
                        float scale) {
  using T = sm90::Tile<D, kRows>;
  constexpr int NC = D == 128 ? 2 : 1;
  constexpr int NW = D == 32 ? 16 : 32;
  extern __shared__ uint8_t smem_raw[];
  BwdStaging<D> ring(smem_raw);
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  // own: K, V; ring: Q, dO
  if (threadIdx.x == 0) ring.start(&tk, &tv, k0, &tq, &tdo, bh, n_tiles);
  float* l2_s = reinterpret_cast<float*>(ring.extra());
  float* dl_s = l2_s + kRows;

  const int tid = threadIdx.x;
  const int col0 = 2 * (tid & 3);
  const float sl2 = scale * sm90::kLog2e;
  float dka[NC][NW], dva[NC][NW];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NW; ++i) dka[c][i] = dva[c][i] = 0.f;

  ring.wait_own();
  const uint32_t ks = ring.own(0), vs = ring.own(1);
  for (int qt = 0; qt < n_tiles; ++qt) {
    if (tid < kRows) {  // the previous tile's readers passed ring.refill
      const int r = qt * kRows + tid;
      l2_s[tid] = r < N ? lse[(long long)bh * N + r] * sm90::kLog2e
                        : INFINITY;  // P = 0 for queries past N
      dl_s[tid] = r < N ? delta[(long long)bh * N + r] : 0.f;
    }
    const uint32_t qs = ring.wait(qt);
    const uint32_t dos = qs + T::BYTES;
    // keys as rows: S^T = K Q^T, dP^T = V dO^T
    float st[32], dpt[32];
    two_products<D>(st, ks, qs, dpt, vs, dos);
    __syncthreads();  // l2_s, dl_s written
    sm90::wg_wait_all();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    // register i holds (key row, query 8 (i >> 2) + col0 + (i & 1))
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + col0 + (i & 1);
      st[i] = sm90::ex2(fmaf(st[i], sl2, -l2_s[c]));  // P^T
      dpt[i] = st[i] * (dpt[i] - dl_s[c]);   // dS^T
    }
    split_product<D>(dva, st, dos);  // dv += P^T dO
    sm90::wg_wait_all();
    split_product<D>(dka, dpt, qs);  // dk += dS^T Q
    sm90::wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sm90::fence_regs(dva[c]);
      sm90::fence_regs(dka[c]);
    }
    ring.refill(&tq, &tdo, qt, bh, n_tiles);
  }
  store_rows<NC, NW, D>(dka, dk + (long long)bh * N * D, k0, N, scale);
  store_rows<NC, NW, D>(dva, dv + (long long)bh * N * D, k0, N, 1.f);
}

template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  if (!sm90::make_map<D, kRows>(&mq, a.q, a.BH, a.N) ||
      !sm90::make_map<D, kRows>(&mk, a.k, a.BH, a.N) ||
      !sm90::make_map<D, kRows>(&mv, a.v, a.BH, a.N) ||
      !sm90::make_map<D, kRows>(&mdo, a.dout, a.BH, a.N))
    return cudaErrorInvalidValue;
  const int n_tiles = (a.N + kRows - 1) / kRows;
  const long long blocks = (long long)a.BH * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_delta<__nv_bfloat16, D>(a, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = BwdStaging<D>::BYTES;

  auto kdq = attention_bwd_dq_bf16<D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kdq<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.N, n_tiles, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kkv = attention_bwd_dkdv_bf16<D>;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kkv<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      mq, mk, mv, mdo, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.N, n_tiles, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Args& a, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D>(a, stream) : launch_f32<D>(a, stream);
}

}  // namespace

// o, lse: the forward's output in fp32 and its row log-sum-exp; delta: an
// fp32 scratch of BH * N floats. Returns a cudaError_t.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* o, const void* lse,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* delta, int BH, int N, int D, float scale,
                             int is_bf16, void* stream) {
  if (BH < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if ((long long)BH * N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q,  k,  v,  dout, static_cast<const float*>(o),
               static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), BH, N, scale};
  switch (D) {
    case 32: return (int)launch<32>(a, is_bf16, s);
    case 64: return (int)launch<64>(a, is_bf16, s);
    case 128: return (int)launch<128>(a, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
