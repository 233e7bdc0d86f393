// Fused multi-head attention backward, hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/attention_pallas.py::_bwd_kernel (via
// _fused_mha_bwd), which recomputes the whole (N, N) fp32 probability matrix
// of one (batch, head) in VMEM from q, k, v and emits dq, dk, dv.
//
// What bounds it on an H100: operations. At the flagship shape (N = 1024,
// 16 heads, D = 64) a call does about 10 N^2 D = 10.7 GFLOP per image
// (recompute q k^T, then dv = P^T do, dP = do v^T, dq = dS k, dk = dS^T q)
// against 14.7 MB of q/k/v/do/dq/dk/dv, about 700 FLOP per byte.
//
// Design: flash-attention style, in two kernels launched back to back, so
// that neither needs atomics and nothing (N, N) leaves the SM; the forward
// saves nothing but q, k, v (as the TPU kernel).
//   1. attention_bwd_dq, one block per (batch * head, 64-query tile): pass 1
//      re-runs the forward's online softmax over all key tiles, giving the
//      row log-sum-exp and the fp32 output O; D_i = rowsum(dO * O). Both go
//      to a small fp32 scratch (B * H, N, 2). Pass 2 walks the key tiles
//      again: P = exp(s - lse), dP = dO v^T, dS = P (dP - D),
//      dq += dS k.
//   2. attention_bwd_dkdv, one block per (batch * head, 64-key tile): walks
//      the query tiles, recomputes P and dS from the saved lse and D, and
//      accumulates dv += P^T dO and dk += dS^T q in registers.
// 256 threads as a 16 x 16 grid, each owning a 4 x 4 patch of a 64 x 64
// score tile and a 4 x D/16 patch of its output tile, as in
// attention_fwd.cu. Inputs are widened to fp32 in shared memory and every
// product is an fp32 FMA on the CUDA cores: no tensor cores yet. The
// scores, P, dP, dS and D stay fp32; the TPU kernel rounds P and dS to the
// value dtype before its products (attention_pallas.py:85, :94). Keys past N
// get P = 0; query rows past N have zero q and dO and are not written.
//
// Determinism: deterministic. Every output element is summed by one thread
// in a fixed order; no atomics.
//
// Layouts (all contiguous): q, k, v, dout, dq, dk, dv (B * H, N, D), bf16 or
// fp32; stats (B * H, N, 2) fp32 scratch (lse, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kB = 64;  // query rows or keys per tile
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// sum over the 16 threads of a tile row: lanes 0-15 or 16-31 of one warp
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// rows [r0, r0 + 64) of a (N, D) matrix into a (64, D + 1) fp32 tile, zero
// past N
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int N, int tid) {
  constexpr int DP = D + 1;
  for (int idx = tid; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int gr = r0 + r;
    dst[r * DP + c] = gr < N ? to_float(src[(long long)gr * D + c]) : 0.f;
  }
}

template <int D>
constexpr int dq_smem_floats() {
  // Q, dO, K, V tiles padded by one word per row; P / dS tile padded
  return 4 * kB * (D + 1) + kB * (kB + 1);
}

template <int D>
constexpr int dkdv_smem_floats() {
  // K, V, Q, dO tiles; P and dS tiles; lse and D of the query tile
  return 4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 T* __restrict__ dq, float* __restrict__ stats, int N,
                 int n_tiles, float scale) {
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

  load_tile<T, D>(Qs, q + base, q0, N, tid);
  load_tile<T, D>(dOs, dout + base, q0, N, tid);

  // pass 1: the forward's online softmax, for lse and O
  float acc[4][DC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, k + base, k0, N, tid);
    load_tile<T, D>(Vs, v + base, k0, N, tid);
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
      mx = row_max(mx);  // finite: the first key of every tile is < N
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      l_i[i] = l_i[i] * alpha + row_sum(sum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float pa[4], vb[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vb[j] = Vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pa[i], vb[j], acc[i][j]);
    }
  }

  // lse and D = rowsum(dO * O), O in fp32
  float lse[4], Dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float inv = 1.f / l_i[i];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      part = fmaf(dOs[r * DP + tx + 16 * j], acc[i][j] * inv, part);
    Dr[i] = row_sum(part);
    lse[i] = m_i[i] + logf(l_i[i]);
    if (tx == 0 && q0 + r < N) {
      float* st = stats + (bh * (long long)N + q0 + r) * 2;
      st[0] = lse[i];
      st[1] = Dr[i];
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;  // now dq
  }

  // pass 2: dS = P (dP - D), dq += dS k
  for (int k0 = 0; k0 < N; k0 += kB) {
    __syncthreads();
    load_tile<T, D>(Ks, k + base, k0, N, tid);
    load_tile<T, D>(Vs, v + base, k0, N, tid);
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
        const float p = ok ? expf(s[i][j] * scale - lse[i]) : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - Dr[i]);
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
    T* o = dq + base + (long long)r * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      o[tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ stats, T* __restrict__ dk,
                   T* __restrict__ dv, int N, int n_tiles, float scale) {
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

  load_tile<T, D>(Ks, k + base, k0, N, tid);
  load_tile<T, D>(Vs, v + base, k0, N, tid);
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
    load_tile<T, D>(Qs, q + base, q0, N, tid);
    load_tile<T, D>(dOs, dout + base, q0, N, tid);
    if (tid < kB) {
      const int gr = q0 + tid;
      const float* st = stats + (bh * (long long)N + gr) * 2;
      lse_s[tid] = gr < N ? st[0] : INFINITY;  // P = 0 on padded rows
      D_s[tid] = gr < N ? st[1] : 0.f;
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
    T* ok = dk + base + (long long)r * D;
    T* ov = dv + base + (long long)r * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      ok[tx + 16 * j] = from_float<T>(dka[i][j] * scale);
      ov[tx + 16 * j] = from_float<T>(dva[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int BH, int N, float scale,
                   cudaStream_t stream) {
  const int n_tiles = (N + kB - 1) / kB;
  const long long blocks = (long long)BH * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(dout);

  const size_t smem_dq = sizeof(float) * dq_smem_floats<D>();
  auto kdq = attention_bwd_dq<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  kdq<<<(unsigned)blocks, kThreads, smem_dq, stream>>>(
      qq, kk, vv, oo, static_cast<T*>(dq), stats, N, n_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = sizeof(float) * dkdv_smem_floats<D>();
  auto kkv = attention_bwd_dkdv<T, D>;
  err = cudaFuncSetAttribute(
      kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  kkv<<<(unsigned)blocks, kThreads, smem_kv, stream>>>(
      qq, kk, vv, oo, stats, static_cast<T*>(dk), static_cast<T*>(dv), N,
      n_tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* stats, int BH, int N, int D, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, BH, N, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, BH, N, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, dq, dk, dv, stats, BH, N, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// stats: an fp32 scratch of BH * N * 2 floats. Returns a cudaError_t.
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* dout, void* dq, void* dk, void* dv,
                             void* stats, int BH, int N, int D, float scale,
                             int is_bf16, void* stream) {
  if (BH < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if ((long long)BH * N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, st, BH, N,
                                        D, scale, s)
              : dispatch<float>(q, k, v, dout, dq, dk, dv, st, BH, N, D,
                                scale, s);
  return (int)err;
}

extern "C" const char* attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
