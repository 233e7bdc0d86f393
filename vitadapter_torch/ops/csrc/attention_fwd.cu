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
// fp32 keeps the CUDA-core kernel: 256 threads as a 16 x 16 grid over 64 x
// 64 tiles, fp32 FMAs (TF32 would miss the fp32 tolerance), the same online
// softmax in base e, and the same log-sum-exp output.
//
// Layouts (all contiguous): q, k, v, out (B * H, N, D), bf16 or fp32; out32
// (B * H, N, D) fp32 or null (bf16 only); lse (B * H, N) fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

// ---- fp32: CUDA cores ----------------------------------------------------

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile
constexpr int kThreads = 256;

template <int D>
constexpr int smem_floats() {
  // Q and K tiles padded by one word per row (conflict-free column reads),
  // V tile, P tile padded by one word per row.
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * (kBN + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse, int N, int n_qtiles, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBN + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBM * DP;
  float* Vs = Ks + kBN * DP;
  float* Ps = Vs + kBN * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBM;
  const long long base = bh * (long long)N * D;

  for (int idx = tid; idx < kBM * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = q0 + r;
    Qs[r * DP + c] = gr < N ? q[base + (long long)gr * D + c] : 0.f;
  }

  float acc[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBN * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int gr = k0 + r;
      const bool ok = gr < N;
      const long long g = base + (long long)gr * D + c;
      Ks[r * DP + c] = ok ? k[g] : 0.f;
      Vs[r * D + c] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + tx + 16 * j < N;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // finite: the first key of every tile is < N
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vb[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= N) continue;
    const float inv = 1.f / l_i[i];
    float* o = out + base + (long long)r * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0) lse[bh * N + r] = m_i[i] + logf(l_i[i]);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       float* lse, int BH, int N, float scale,
                       cudaStream_t stream) {
  const int n_qtiles = (N + kBM - 1) / kBM;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = attention_fwd_f32<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, N,
      n_qtiles, scale);
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
                   float* out32, float* lse, int BH, int N, float scale,
                   int is_bf16, cudaStream_t stream) {
  if (!is_bf16 && out32 != nullptr) return cudaErrorInvalidValue;
  return is_bf16
             ? launch_bf16<D>(q, k, v, out, out32, lse, BH, N, scale, stream)
             : launch_f32<D>(q, k, v, out, lse, BH, N, scale, stream);
}

}  // namespace

// out32: null, or (bf16 only) the fp32 output for the backward; lse:
// (BH, N) fp32, written. Returns a cudaError_t.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, void* out32, void* lse, int BH, int N,
                             int D, float scale, int is_bf16, void* stream) {
  if (BH < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if ((long long)BH * N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o32 = static_cast<float*>(out32);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 32:
      return (int)launch<32>(q, k, v, out, o32, l, BH, N, scale, is_bf16, s);
    case 64:
      return (int)launch<64>(q, k, v, out, o32, l, BH, N, scale, is_bf16, s);
    case 128:
      return (int)launch<128>(q, k, v, out, o32, l, BH, N, scale, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
