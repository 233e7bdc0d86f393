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
// Design, fp32: the same three launches, every product on the tensor cores
// in split TF32 (sm90.cuh), after a pre-pass that reads q, k, v and dO once
// and writes hi/lo copies into the caller's scratch: all four as laid out
// (K-major A and B operands of S, dP, S^T, dP^T) and k, q, dO transposed
// to (D, N) in k8_source order (the B operands of dq += dS k, dk += dS^T
// q, dv += P^T dO, which contract over keys or queries: TF32 wgmma takes
// B K-major only). Each product is three wgmmas (A_lo B_hi + A_hi B_lo +
// A_hi B_hi, about 2^-20 relative); P and dS (P^T, dS^T) are split in
// registers, and each tile's contribution to dq, dk, dv sums in a fresh
// accumulator (add_product). One warpgroup a CTA, 64 own rows; the
// streamed side comes in stages of 64 (D = 32), 32 (D = 64) or, one
// stage, 32 keys and 16 queries (D = 128), which keeps the own tiles and
// the ring under 227 KB. Deterministic as the bf16 kernels: no atomics.
//
// Layouts (all contiguous): q, k, v, dout, dq, dk, dv (B * H, N, D), bf16
// or fp32; o (B * H, N, D) fp32; lse (B * H, N) fp32; delta: scratch, (B *
// H, N) fp32 for bf16, and for fp32 delta_floats(B * H, N) + 8 B H N D +
// 6 B H D Np floats (Np: N rounded up to 64), delta then the split copies.

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

// ---- fp32: split TF32 on the tensor cores ---------------------------------

// per head dim, one warpgroup of 64 own rows a CTA: the dq kernel streams
// KT keys a stage (K, V hi/lo as rows, K^T hi/lo), the dk/dv kernel QT
// queries (Q, dO hi/lo as rows, Q^T, dO^T hi/lo); the own tiles are four
// (64, D) hi/lo tiles. Shared memory (dq, dk/dv): 128 and 160 KB at D = 32,
// 160 and 192 KB at D = 64, 224 and 192 KB at D = 128 (one stage each).
template <int D>
struct F32Bwd {
  static constexpr int KT = D == 32 ? 64 : 32;
  static constexpr int QT = D == 32 ? 64 : D == 64 ? 32 : 16;
  static constexpr int STAGES = D == 128 ? 1 : 2;
  using Own = sm90::Tile32<D, 64>;
  using KRow = sm90::Tile32<D, KT>;
  using KCol = sm90::Tile32<KT, D>;
  using QRow = sm90::Tile32<D, QT>;
  using QCol = sm90::Tile32<QT, D>;
  static constexpr uint32_t OWN = 4 * Own::BYTES;
  static constexpr uint32_t DQ_STAGE = 4 * KRow::BYTES + 2 * KCol::BYTES;
  static constexpr uint32_t KV_STAGE = 4 * QRow::BYTES + 4 * QCol::BYTES;
  using DqRing = sm90::Ring<OWN, DQ_STAGE, STAGES>;
  using KvRing = sm90::Ring<OWN, KV_STAGE, STAGES>;
};

// the split copies, hi and lo each: rows (BH, N, D) of q, k, v, dO in maps
// of 64-row boxes (the own tiles) and of the streamed tiles' rows; columns
// (BH, D, Np) of k (dq kernel), q and dO (dk/dv kernel)
struct BwdMaps {
  CUtensorMap own[4];     // dq: Q, dO; dk/dv: K, V (hi, lo each)
  CUtensorMap rows[4];    // dq: K, V; dk/dv: Q, dO
  CUtensorMap cols[4];    // dq: K^T; dk/dv: Q^T, dO^T
};

// rows < N of a (64, D) fp32 accumulator times `mul`
template <int D>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[D / 2],
                                               float* __restrict__ dst,
                                               int r0, int N, float mul) {
  const int lane = threadIdx.x & 31;
  const int row = r0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= N) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + (long long)r * D + 8 * j + col0) =
          make_float2(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// thread 0: the four own tiles at row r0 onto the own barrier
template <int D, typename R>
__device__ __forceinline__ void load_own(R& ring, const BwdMaps& m, int r0,
                                         int bh) {
  using Own = typename F32Bwd<D>::Own;
  sm90::mbar_expect_tx(ring.own_bar(), 4 * Own::BYTES);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sm90::tma_load_tile32<D, 64>(ring.smem + i * Own::BYTES, &m.own[i],
                                 ring.own_bar(), 0, r0, bh);
}

// thread 0: stage `it` of NR row tiles (RT rows each) and NC column tiles
// (D rows of RT columns), all at the streamed side's row it * RT
template <int D, int RT, int NR, int NC, typename R>
__device__ __forceinline__ void load_stage(R& ring, const BwdMaps& m, int it,
                                           int bh) {
  using Row = sm90::Tile32<D, RT>;
  using Col = sm90::Tile32<RT, D>;
  uint8_t* st = ring.stage(it);
  uint64_t* bar = ring.bar(it);
  sm90::mbar_expect_tx(bar, NR * Row::BYTES + NC * Col::BYTES);
#pragma unroll
  for (int i = 0; i < NR; ++i)
    sm90::tma_load_tile32<D, RT>(st + i * Row::BYTES, &m.rows[i], bar, 0,
                                 it * RT, bh);
#pragma unroll
  for (int i = 0; i < NC; ++i)
    sm90::tma_load_tile32<RT, D>(st + NR * Row::BYTES + i * Col::BYTES,
                                 &m.cols[i], bar, it * RT, 0, bh);
}

// dq by query tiles: S = Q K^T and dP = dO V^T (three products each, both
// from shared memory), P = exp(S - lse), dS = P (dP - delta) in registers,
// dq += dS K (dS split in registers, K^T from shared memory)
template <int D>
__global__ void __launch_bounds__(128)
attention_bwd_dq_f32(const __grid_constant__ BwdMaps m,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int N, int n_tiles, float scale) {
  using C = F32Bwd<D>;
  constexpr int KT = C::KT;
  constexpr int NS = KT / 2;
  extern __shared__ uint8_t smem_raw[];
  typename C::DqRing ring(smem_raw);
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * 64;
  const int n_kt = (N + KT - 1) / KT;
  if (threadIdx.x == 0) {
    load_own<D>(ring, m, q0, bh);
    for (int it = 0; it < C::STAGES && it < n_kt; ++it)
      load_stage<D, KT, 4, 2>(ring, m, it, bh);
  }

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
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const float one[2] = {1.f, 1.f};

  const uint32_t own = ring.wait_own();
  auto own_desc = [&](int i) {
    return [=](int t) {
      return sm90::desc_k32<D, 64>(own + i * C::Own::BYTES, t);
    };
  };
  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t st = ring.wait(kt);
    auto row_desc = [&](int i) {
      return [=](int t) {
        return sm90::desc_k32<D, KT>(st + i * C::KRow::BYTES, t);
      };
    };
    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wg_fence();
    // own 0, 1: Q hi, lo; 2, 3: dO hi, lo. rows 0, 1: K; 2, 3: V
    sm90::split_ss<D / 8>(sc, own_desc(0), own_desc(1), row_desc(0),
                          row_desc(1));
    sm90::split_ss<D / 8>(dp, own_desc(2), own_desc(3), row_desc(2),
                          row_desc(3));
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    const bool ragged = (kt + 1) * KT > N;  // keys past N: P = 0
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int h = (i >> 1) & 1;
      float p = sm90::ex2(fmaf(sc[i], sl2, -l2[h]));
      if (ragged && kt * KT + 8 * (i >> 2) + col0 + (i & 1) >= N) p = 0.f;
      sc[i] = p * (dp[i] - dl[h]);  // dS
    }
    uint32_t hi[KT / 8][4], lo[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk)
      sm90::frag_tf32(sc, kk, hi[kk], lo[kk]);
    const uint32_t kc = st + 4 * C::KRow::BYTES;  // K^T hi, lo
    sm90::add_product<KT / 8, D>(acc, hi, lo, kc, kc + C::KCol::BYTES,
                                 one);
    __syncthreads();
    if (threadIdx.x == 0 && kt + C::STAGES < n_kt)
      load_stage<D, KT, 4, 2>(ring, m, kt + C::STAGES, bh);
  }
  store_rows_f32<D>(acc, dq + (long long)bh * N * D, q0, N, scale);
}

// dk and dv by key tiles, keys as the rows: S^T = K Q^T and dP^T = V dO^T
// (shared memory), P^T and dS^T in registers, dv += P^T dO and dk += dS^T Q
// (P^T, dS^T split in registers, dO^T and Q^T from shared memory)
template <int D>
__global__ void __launch_bounds__(128)
attention_bwd_dkdv_f32(const __grid_constant__ BwdMaps m,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int N,
                       int n_tiles, float scale) {
  using C = F32Bwd<D>;
  constexpr int QT = C::QT;
  constexpr int NS = QT / 2;
  extern __shared__ uint8_t smem_raw[];
  typename C::KvRing ring(smem_raw);
  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * 64;
  const int n_qt = (N + QT - 1) / QT;
  if (threadIdx.x == 0) {
    load_own<D>(ring, m, k0, bh);
    for (int it = 0; it < C::STAGES && it < n_qt; ++it)
      load_stage<D, QT, 4, 4>(ring, m, it, bh);
  }

  const int col0 = 2 * (threadIdx.x & 3);
  const float sl2 = scale * sm90::kLog2e;
  const float* lse_h = lse + (long long)bh * N;
  const float* delta_h = delta + (long long)bh * N;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const float one[2] = {1.f, 1.f};

  const uint32_t own = ring.wait_own();
  auto own_desc = [&](int i) {
    return [=](int t) {
      return sm90::desc_k32<D, 64>(own + i * C::Own::BYTES, t);
    };
  };
  for (int qt = 0; qt < n_qt; ++qt) {
    // this thread's queries 8 j + col0 + e of the tile: lse (base 2) and
    // delta; queries past N: P = 0
    float l2c[NS / 2], dlc[NS / 2];
#pragma unroll
    for (int c = 0; c < NS / 2; ++c) {
      const int q = qt * QT + 8 * (c >> 1) + col0 + (c & 1);
      l2c[c] = q < N ? __ldg(lse_h + q) * sm90::kLog2e : INFINITY;
      dlc[c] = q < N ? __ldg(delta_h + q) : 0.f;
    }
    const uint32_t st = ring.wait(qt);
    auto row_desc = [&](int i) {
      return [=](int t) {
        return sm90::desc_k32<D, QT>(st + i * C::QRow::BYTES, t);
      };
    };
    float sc[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = dp[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wg_fence();
    // own 0, 1: K hi, lo; 2, 3: V hi, lo. rows 0, 1: Q; 2, 3: dO
    sm90::split_ss<D / 8>(sc, own_desc(0), own_desc(1), row_desc(0),
                          row_desc(1));
    sm90::split_ss<D / 8>(dp, own_desc(2), own_desc(3), row_desc(2),
                          row_desc(3));
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    // register i holds (key row, query 8 (i >> 2) + col0 + (i & 1))
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 2 * (i >> 2) + (i & 1);
      sc[i] = sm90::ex2(fmaf(sc[i], sl2, -l2c[c]));  // P^T
      dp[i] = sc[i] * (dp[i] - dlc[c]);              // dS^T
    }
    // columns 0, 1: Q^T hi, lo; 2, 3: dO^T hi, lo. At D = 128 the
    // accumulators dk, dv take 128 registers: the tile sums go 32 columns
    // at a time and the fragments of P^T and dS^T one after the other
    constexpr int W = D > 64 ? 32 : D;
    const uint32_t cols = st + 4 * C::QRow::BYTES;
    {
      uint32_t hi[QT / 8][4], lo[QT / 8][4];
#pragma unroll
      for (int kk = 0; kk < QT / 8; ++kk)
        sm90::frag_tf32(sc, kk, hi[kk], lo[kk]);
      sm90::add_product<QT / 8, D, W>(dva, hi, lo,
                                      cols + 2 * C::QCol::BYTES,
                                      cols + 3 * C::QCol::BYTES, one);
    }
    {
      uint32_t hi[QT / 8][4], lo[QT / 8][4];
#pragma unroll
      for (int kk = 0; kk < QT / 8; ++kk)
        sm90::frag_tf32(dp, kk, hi[kk], lo[kk]);
      sm90::add_product<QT / 8, D, W>(dka, hi, lo, cols,
                                      cols + C::QCol::BYTES, one);
    }
    __syncthreads();
    if (threadIdx.x == 0 && qt + C::STAGES < n_qt)
      load_stage<D, QT, 4, 4>(ring, m, qt + C::STAGES, bh);
  }
  store_rows_f32<D>(dka, dk + (long long)bh * N * D, k0, N, scale);
  store_rows_f32<D>(dva, dv + (long long)bh * N * D, k0, N, 1.f);
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

// the delta region of the scratch, in floats: BH N rounded up to 64 (the
// split copies after it stay 256-byte aligned)
inline size_t delta_floats(int BH, int N) {
  return ((size_t)BH * N + 63) / 64 * 64;
}

// a.delta: the scratch, delta_floats(BH, N) + 8 BH N D + 6 BH D Np floats:
// delta, the row copies (hi, lo) of q, k, v, dO, the column copies of k, q,
// dO
template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  using C = F32Bwd<D>;
  const int BH = a.BH, N = a.N, Np = sm90::padded_rows(N);
  const size_t nd = (size_t)BH * N * D, tp = (size_t)BH * D * Np;
  float* r = a.delta + delta_floats(BH, N);  // q, k, v, dO rows: hi, lo
  float* c = r + 8 * nd;                      // k, q, dO columns: hi, lo
  const void* src[4] = {a.q, a.k, a.v, a.dout};
  BwdMaps mq, mkv;  // the dq kernel's and the dk/dv kernel's
  bool ok = true;
  for (int i = 0; i < 2; ++i) {
    float* q = r + i * nd;          // Q hi, lo
    float* k = r + (2 + i) * nd;    // K
    float* v = r + (4 + i) * nd;    // V
    float* o = r + (6 + i) * nd;    // dO
    ok = ok && sm90::make_map32<D, 64>(&mq.own[i], q, BH, N, D) &&
         sm90::make_map32<D, 64>(&mq.own[2 + i], o, BH, N, D) &&
         sm90::make_map32<D, C::KT>(&mq.rows[i], k, BH, N, D) &&
         sm90::make_map32<D, C::KT>(&mq.rows[2 + i], v, BH, N, D) &&
         sm90::make_map32<C::KT, D>(&mq.cols[i], c + i * tp, BH, D, Np) &&
         sm90::make_map32<D, 64>(&mkv.own[i], k, BH, N, D) &&
         sm90::make_map32<D, 64>(&mkv.own[2 + i], v, BH, N, D) &&
         sm90::make_map32<D, C::QT>(&mkv.rows[i], q, BH, N, D) &&
         sm90::make_map32<D, C::QT>(&mkv.rows[2 + i], o, BH, N, D) &&
         sm90::make_map32<C::QT, D>(&mkv.cols[i], c + (2 + i) * tp, BH, D,
                                    Np) &&
         sm90::make_map32<C::QT, D>(&mkv.cols[2 + i], c + (4 + i) * tp, BH,
                                    D, Np);
  }
  if (!ok) return cudaErrorInvalidValue;
  const int n_tiles = (N + 63) / 64;
  const long long blocks = (long long)BH * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_delta<float, D>(a, stream);
  // rows of all four; columns of k (slot 0), q (1), dO (2)
  const int col_slot[4] = {1, 0, -1, 2};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    float* ch = col_slot[i] < 0 ? nullptr : c + 2 * col_slot[i] * tp;
    err = sm90::launch_split<D>(src[i], r + 2 * i * nd, r + (2 * i + 1) * nd,
                                ch, ch == nullptr ? nullptr : ch + tp, BH, N,
                                stream);
  }
  if (err != cudaSuccess) return err;

  auto kdq = attention_bwd_dq_f32<D>;
  err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::DqRing::BYTES);
  if (err != cudaSuccess) return err;
  kdq<<<(unsigned)blocks, 128, C::DqRing::BYTES, stream>>>(
      mq, a.lse, a.delta, static_cast<float*>(a.dq), N, n_tiles, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kkv = attention_bwd_dkdv_f32<D>;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::KvRing::BYTES);
  if (err != cudaSuccess) return err;
  kkv<<<(unsigned)blocks, 128, C::KvRing::BYTES, stream>>>(
      mkv, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), N, n_tiles, a.scale);
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
// fp32 scratch of BH * N floats (bf16) or of delta_floats(BH, N) + 8 BH N D
// + 6 BH D Np floats (fp32: delta and the split copies). Returns a
// cudaError_t.
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
