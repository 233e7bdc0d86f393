// Fused multi-head attention forward, hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/attention_pallas.py::_fwd_kernel, which keeps a
// whole (N, N) fp32 score matrix per (batch, head) in VMEM.
//
// What bounds it on an H100: operations. At the flagship shape (N = 1024,
// 16 heads, D = 64) a call does 4.29 GFLOP per image against 8.39 MB of
// q/k/v/out, about 500 FLOP per byte: the tensor cores' side of the line.
//
// Design, bf16 (the main path): flash attention on the tensor cores. One
// CTA of one warpgroup (128 threads) per (batch * head, 64-query tile): at
// the flagship 512 CTAs, which at about 42 KB of shared memory and under
// 128 registers a thread fit five to an SM, all in one wave, so each SM
// hides one CTA's loads and softmax behind the others' products (128-query
// CTAs of two warpgroups would give 256 CTAs and the same warpgroups per
// SM). TMA loads the query tile once and streams 64-key tiles of K and V
// through a 2-stage ring in shared memory, each stage completing on an
// mbarrier; a 3-D tensor map over (D, N, B * H) zero-fills keys past N
// inside each head (sm90.cuh). Per key tile:
//   S = Q K^T      wgmma m64n64k16, Q and K from shared memory, fp32 sums;
//   online softmax on the accumulator fragments in registers, fp32, base 2
//                  by the SFU's ex2 (keys >= N masked to -inf by index);
//   O += P V       two wgmmas, P from registers as a bf16 hi/lo pair
//                  (below) and V from shared memory, fp32 sums.
// The epilogue scales by 1 / l, rounds to bf16, stores the rows < N, and
// writes each row's log-sum-exp (fp32, natural log) for the backward.
//
// Numerics, bf16: Q, K and V are bf16, so S is their exact products summed
// in fp32. P V takes P as a bf16 hi/lo pair (hi = bf16(P), lo = bf16(P -
// hi): two products, about 2^-17 relative) where the TPU kernel rounds P
// to bf16 (attention_pallas.py:67): a bf16 P moved outputs near zero past
// the card's bf16 tolerance at N = 77, D = 128 (chip_smoke.py). When the
// caller trains (out32 given) the kernel also writes the fp32 output: the
// backward's delta = rowsum(dO * O) needs O to about fp32, since a bf16 O
// moves dq and dk by several times the card's 1e-5 x max tolerance on
// small elements.
//
// Design, fp32: the same flash attention with every product on the tensor
// cores in split TF32 (sm90.cuh). A pre-pass behind the same entry point
// reads q, k and v once and writes hi (TF32-exact) and lo = x - hi copies
// into the caller's scratch: Q and K as they are laid out, V transposed to
// (D, N) in k8_source order, since TF32 wgmma takes B K-major only and
// O += P V contracts over the keys. Each product is then three wgmmas,
// A_lo B_hi + A_hi B_lo + A_hi B_hi, about 2^-20 relative against fp32's
// 1e-5 tolerance (single-pass TF32 misses it). P is split in registers
// (frag_tf32), and each tile's P V sums in a fresh accumulator before it
// joins O (add_product). A stage carries K hi/lo and V^T hi/lo, 64 KB at
// D = 64, so two warpgroups (128 query rows, 256 threads) share each
// stage: 192 KB of shared memory, one CTA per SM. At D = 128 one
// warpgroup of 64 rows takes 32-key tiles (the same 64 KB a stage); at
// D = 32, 96 KB. The pre-pass moves O(N D) bytes against the O(N^2 D)
// products.
//
// Layouts (all contiguous): q, k, v, out (B * H, N, D), bf16 or fp32; aux
// (B * H, N, D) fp32 or null (bf16), the split scratch (fp32); lse (B * H,
// N) fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

// ---- fp32: split TF32 on the tensor cores ---------------------------------

// per head dim: WG warpgroups of 64 query rows share each key tile; KT keys
// per tile. A stage holds K hi, K lo (KT x D) and V^T hi, V^T lo (D x KT):
// 64 KB at D = 64 and 128, so D = 128 takes 32-key tiles and one
// warpgroup. Shared memory: 96 KB (D = 32), 192 KB (D = 64 and 128).
template <int D>
struct F32Fwd {
  static constexpr int WG = D == 128 ? 1 : 2;
  static constexpr int KT = D == 128 ? 32 : 64;
  static constexpr int STAGES = 2;
  static constexpr int ROWS = 64 * WG;
  using QTile = sm90::Tile32<D, ROWS>;
  using KTile = sm90::Tile32<D, KT>;
  using VTile = sm90::Tile32<KT, D>;  // V^T: D rows, KT keys
  static constexpr uint32_t OWN = 2 * QTile::BYTES;
  static constexpr uint32_t STAGE = 2 * KTile::BYTES + 2 * VTile::BYTES;
  using Ring = sm90::Ring<OWN, STAGE, STAGES>;
};

// the split copies: Q and K hi/lo (BH, N, D), V^T hi/lo (BH, D, Np)
struct FwdMaps {
  CUtensorMap qh, ql, kh, kl, vh, vl;
};

template <int D>
__global__ void __launch_bounds__(128 * F32Fwd<D>::WG)
attention_fwd_f32(const __grid_constant__ FwdMaps m, float* __restrict__ out,
                  float* __restrict__ lse, int N, int n_qtiles,
                  float scale) {
  using C = F32Fwd<D>;
  constexpr int KT = C::KT;
  constexpr int NS = KT / 2;  // score registers
  constexpr int NO = D / 2;   // output registers
  extern __shared__ uint8_t smem_raw[];
  typename C::Ring ring(smem_raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * C::ROWS;
  const int n_kt = (N + KT - 1) / KT;
  auto load = [&](int it) {
    uint8_t* st = ring.stage(it);
    uint64_t* bar = ring.bar(it);
    sm90::mbar_expect_tx(bar, C::STAGE);
    sm90::tma_load_tile32<D, KT>(st, &m.kh, bar, 0, it * KT, bh);
    sm90::tma_load_tile32<D, KT>(st + C::KTile::BYTES, &m.kl, bar, 0,
                                 it * KT, bh);
    st += 2 * C::KTile::BYTES;
    sm90::tma_load_tile32<KT, D>(st, &m.vh, bar, it * KT, 0, bh);
    sm90::tma_load_tile32<KT, D>(st + C::VTile::BYTES, &m.vl, bar, it * KT,
                                 0, bh);
  };
  if (tid == 0) {
    sm90::mbar_expect_tx(ring.own_bar(), C::OWN);
    sm90::tma_load_tile32<D, C::ROWS>(ring.smem, &m.qh, ring.own_bar(), 0,
                                      q0, bh);
    sm90::tma_load_tile32<D, C::ROWS>(ring.smem + C::QTile::BYTES, &m.ql,
                                      ring.own_bar(), 0, q0, bh);
    for (int it = 0; it < C::STAGES && it < n_kt; ++it) load(it);
  }

  const float sl2 = scale * sm90::kLog2e;  // scores in base 2
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_[2] = {-INFINITY, -INFINITY};  // rows r, r + 8: max raw score
  float l[2] = {0.f, 0.f};               // this thread's share of the sum
  const int col0 = 2 * (lane & 3);

  const uint32_t qh = ring.wait_own(), ql = qh + C::QTile::BYTES;
  const int qrow = 64 * wg;  // this warpgroup's rows of the query tile
  auto q_hi = [&](int t) { return sm90::desc_k32<D, C::ROWS>(qh, t, qrow); };
  auto q_lo = [&](int t) { return sm90::desc_k32<D, C::ROWS>(ql, t, qrow); };

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t kh = ring.wait(kt), kl = kh + C::KTile::BYTES;
    const uint32_t vh = kl + C::KTile::BYTES, vl = vh + C::VTile::BYTES;

    // S = Q K^T
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wg_fence();
    sm90::split_ss<D / 8>(
        sc, q_hi, q_lo,
        [&](int t) { return sm90::desc_k32<D, KT>(kh, t); },
        [&](int t) { return sm90::desc_k32<D, KT>(kl, t); });
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::fence_regs(sc);

    // online softmax as the bf16 kernel's: register i holds (row r + 8
    // ((i >> 1) & 1), key 8 (i >> 2) + col0 + (i & 1)); keys past N, only
    // in the last tile, are masked to -inf
    if ((kt + 1) * KT > N) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (kt * KT + 8 * (i >> 2) + col0 + (i & 1) >= N) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_[h], mx[h]);  // finite: key kt * KT < N
      alpha[h] = sm90::ex2((m_[h] - m_new) * sl2);
      m_[h] = m_new;
      ms[h] = -m_new * sl2;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sc[i] = sm90::ex2(fmaf(sc[i], sl2, ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
    // O = O alpha + P V, P split in registers, V^T from shared memory
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk)
      sm90::frag_tf32(sc, kk, ph[kk], pl[kk]);
    sm90::add_product<KT / 8, D>(o, ph, pl, vh, vl, alpha);

    __syncthreads();  // both warpgroups are done with the stage
    if (tid == 0 && kt + C::STAGES < n_kt) load(kt + C::STAGES);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int r0 = q0 + qrow + 16 * warp + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= N) continue;
    const float inv = 1.f / l[h];
    float* dst = out + ((long long)bh * N + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j + col0) =
          make_float2(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    if ((lane & 3) == 0)
      lse[(long long)bh * N + r] = m_[h] * scale + logf(l[h]);
  }
}

// split: 4 BH N D + 2 BH D Np floats of scratch for the split copies
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       void* out, float* split, float* lse, int BH, int N,
                       float scale, cudaStream_t stream) {
  using C = F32Fwd<D>;
  const int Np = sm90::padded_rows(N);
  const size_t nd = (size_t)BH * N * D;
  float *qh = split, *ql = qh + nd, *kh = ql + nd, *kl = kh + nd;
  float *vh = kl + nd, *vl = vh + (size_t)BH * D * Np;
  FwdMaps m;
  if (!sm90::make_map32<D, C::ROWS>(&m.qh, qh, BH, N, D) ||
      !sm90::make_map32<D, C::ROWS>(&m.ql, ql, BH, N, D) ||
      !sm90::make_map32<D, C::KT>(&m.kh, kh, BH, N, D) ||
      !sm90::make_map32<D, C::KT>(&m.kl, kl, BH, N, D) ||
      !sm90::make_map32<C::KT, D>(&m.vh, vh, BH, D, Np) ||
      !sm90::make_map32<C::KT, D>(&m.vl, vl, BH, D, Np))
    return cudaErrorInvalidValue;
  const int n_qtiles = (N + C::ROWS - 1) / C::ROWS;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      sm90::launch_split<D>(q, qh, ql, nullptr, nullptr, BH, N, stream);
  if (err == cudaSuccess)
    err = sm90::launch_split<D>(k, kh, kl, nullptr, nullptr, BH, N, stream);
  if (err == cudaSuccess)
    err = sm90::launch_split<D>(v, nullptr, nullptr, vh, vl, BH, N, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = C::Ring::BYTES;
  auto kernel = attention_fwd_f32<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 128 * C::WG, smem, stream>>>(
      m, static_cast<float*>(out), lse, N, n_qtiles, scale);
  return cudaGetLastError();
}

// ---- bf16: tensor cores --------------------------------------------------

constexpr int kRows = 64;    // query rows per CTA, keys per tile
constexpr int kTcThreads = 128;
// the query tile, and a 2-stage ring of (K, V) tile pairs
template <int D>
using FwdStaging = sm90::Staging<D, 1, 2>;

// out32: null, or the fp32 output for the backward
template <int D>
__global__ void __launch_bounds__(kTcThreads)
attention_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ out32, float* __restrict__ lse, int N,
                   int n_qtiles, float scale) {
  using T = sm90::Tile<D, kRows>;
  constexpr int NC = D == 128 ? 2 : 1;   // output column chunks (wgmma N)
  constexpr int NW = D == 32 ? 16 : 32;  // accumulator registers per chunk
  extern __shared__ uint8_t smem_raw[];
  FwdStaging<D> ring(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kRows;
  const int n_kt = (N + kRows - 1) / kRows;
  if (tid == 0) ring.start(&tq, nullptr, q0, &tk, &tv, bh, n_kt);

  const float sl2 = scale * sm90::kLog2e;  // scores in base 2
  float o[NC][NW];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < NW; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows r, r + 8: max raw score
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  const int col0 = 2 * (lane & 3);

  ring.wait_own();
  const uint32_t qs = ring.own(0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const uint32_t ks = ring.wait(kt);
    const uint32_t vs = ks + T::BYTES;

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    sm90::fence_regs(sc);
    sm90::wg_fence();
#pragma unroll
    for (int t = 0; t < D / 16; ++t)
      sm90::mma_ss_n64(sc, sm90::desc_k<D, kRows>(qs, t),
                       sm90::desc_k<D, kRows>(ks, t));
    sm90::wg_commit();
    sm90::wg_wait_all();
    sm90::fence_regs(sc);

    // online softmax on the raw scores (scale > 0 commutes with the max),
    // scaled into base 2 inside each exponent's FMA; register i holds
    // (row r + 8 ((i >> 1) & 1), key 8 (i >> 2) + col0 + (i & 1)); keys past
    // N, only in the last tile, are masked to -inf
    if ((kt + 1) * kRows > N) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kt * kRows + 8 * (i >> 2) + col0 + (i & 1) >= N) sc[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes of a quad hold one row
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: key kt * 64 < N
      alpha[h] = sm90::ex2((m[h] - m_new) * sl2);
      m[h] = m_new;
      ms[h] = -m_new * sl2;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = sm90::ex2(fmaf(sc[i], sl2, ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < NW; ++i) o[c][i] *= alpha[(i >> 1) & 1];

    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::frag_hi_lo(sc, kk, hi[kk], lo[kk]);
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(o[c]);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const uint64_t vd = sm90::desc_mn<D, kRows>(vs, kk, c);
        sm90::mma_rs(o[c], hi[kk], vd);
        sm90::mma_rs(o[c], lo[kk], vd);
      }
    sm90::wg_commit();
    sm90::wg_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) sm90::fence_regs(o[c]);

    ring.refill(&tk, &tv, kt, bh, n_kt);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int r0 = q0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= N) continue;
    const float inv = 1.f / l[h];
    const long long row = ((long long)bh * N + r) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < NW / 4; ++j) {
        const int col = c * 64 + 8 * j + col0;
        const float2 v = make_float2(o[c][4 * j + 2 * h] * inv,
                                     o[c][4 * j + 2 * h + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(out + row + col) =
            __floats2bfloat162_rn(v.x, v.y);
        if (out32) *reinterpret_cast<float2*>(out32 + row + col) = v;
      }
    if ((lane & 3) == 0)
      lse[(long long)bh * N + r] = m[h] * scale + logf(l[h]);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, float* out32, float* lse, int BH, int N,
                        float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map<D, kRows>(&mq, q, BH, N) ||
      !sm90::make_map<D, kRows>(&mk, k, BH, N) ||
      !sm90::make_map<D, kRows>(&mv, v, BH, N))
    return cudaErrorInvalidValue;
  const int n_qtiles = (N + kRows - 1) / kRows;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = FwdStaging<D>::BYTES;
  auto kernel = attention_fwd_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), out32, lse, N, n_qtiles,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* aux, float* lse, int BH, int N, float scale,
                   int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch_bf16<D>(q, k, v, out, static_cast<float*>(aux), lse, BH, N,
                          scale, stream);
  if (aux == nullptr) return cudaErrorInvalidValue;
  return launch_f32<D>(q, k, v, out, static_cast<float*>(aux), lse, BH, N,
                       scale, stream);
}

}  // namespace

// aux: for bf16, null or the fp32 output for the backward; for fp32, the
// scratch of the split copies, 4 BH N D + 2 BH D Np floats (Np: N rounded
// up to a multiple of 64). lse: (BH, N) fp32, written. Returns a
// cudaError_t.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, void* aux, void* lse, int BH, int N,
                             int D, float scale, int is_bf16, void* stream) {
  if (BH < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if ((long long)BH * N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32:
      return (int)launch<32>(q, k, v, out, aux, l, BH, N, scale, is_bf16, s);
    case 64:
      return (int)launch<64>(q, k, v, out, aux, l, BH, N, scale, is_bf16, s);
    case 128:
      return (int)launch<128>(q, k, v, out, aux, l, BH, N, scale, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
