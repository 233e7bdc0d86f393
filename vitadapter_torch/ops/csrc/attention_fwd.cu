// Fused multi-head attention forward, hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/attention_pallas.py::_fwd_kernel, which keeps a
// whole (N, N) fp32 score matrix per (batch, head) in VMEM.
//
// What bounds it on an H100: operations. At the flagship shape (N = 1024,
// 16 heads, D = 64) a call does 4.29 GFLOP per image against 8.39 MB of
// q/k/v/out, about 500 FLOP per byte.
//
// Design: a flash-style tiled kernel with an online softmax, so the scores
// never leave the SM. One block per (batch * head, 64-query tile), 256
// threads as a 16 x 16 grid. The query tile stays in shared memory; 64-key
// tiles of K and V are staged in shared memory in turn. Each thread owns a
// 4 x 4 patch of the 64 x 64 score tile and a 4 x D/16 patch of the output
// tile. Scores, softmax statistics and the output sum are fp32, as in the TPU
// kernel; the probabilities stay fp32 for the P.V product (the TPU kernel
// rounds them to the value dtype). Inputs are widened to fp32 as they are
// staged and all products are fp32 FMAs on the CUDA cores: this first version
// does not use the tensor cores (mma/wgmma), which is what would lift it
// towards the bound. Keys past N are masked with -inf; query rows past N are
// not written.
//
// Layouts (all contiguous): q, k, v, out (B * H, N, D), bf16 or fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile
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

template <int D>
constexpr int smem_floats() {
  // Q and K tiles padded by one word per row (conflict-free column reads),
  // V tile, P tile padded by one word per row.
  return kBM * (D + 1) + kBN * (D + 1) + kBN * D + kBM * (kBN + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int N,
                     int n_qtiles, float scale) {
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
    Qs[r * DP + c] = gr < N ? to_float(q[base + (long long)gr * D + c]) : 0.f;
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
      Ks[r * DP + c] = ok ? to_float(k[g]) : 0.f;
      Vs[r * D + c] = ok ? to_float(v[g]) : 0.f;
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
    T* o = out + base + (long long)r * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int N, float scale, cudaStream_t stream) {
  const int n_qtiles = (N + kBM - 1) / kBM;
  const long long blocks = (long long)BH * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = attention_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), N, n_qtiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int BH, int N, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, BH, N, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, BH, N, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, BH, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* out, int BH, int N, int D, float scale,
                             int is_bf16, void* stream) {
  if (BH < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if ((long long)BH * N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, BH, N, D, scale, s)
              : dispatch<float>(q, k, v, out, BH, N, D, scale, s);
  return (int)err;
}

extern "C" const char* attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
