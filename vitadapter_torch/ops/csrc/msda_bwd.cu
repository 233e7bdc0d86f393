// Multi-scale deformable attention (MSDA) backward, hand-written for Hopper
// (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_bwd_ml_kernel (via _backward_ml
// and _bwd). The TPU kernel rebuilds the relu one-hot interpolation matrices
// of the forward and contracts them on the MXU: grad_value as C^T @ g
// accumulated over sequential query tiles, and the per-point reductions for
// the attention weights and the locations.
//
// What bounds it on an H100: bytes and atomics. A flagship call reads the
// value (1-11 MB in bf16), fp32 locations, weights and the incoming gradient,
// and writes grad_value plus fp32 grad_loc / grad_attn, against a few fp32
// FMAs per channel per corner, far under the CUDA cores' ridge of about 20
// FLOP per byte.
//
// Design: the forward's direct gather, run backwards, as the reference CUDA
// col2im does. One warp per (batch, query, head), lanes on the channels. For
// each in-map corner of each point, a lane reads its channel of the value row
// and of g, adds attn * w * g to grad_value with an fp32 atomicAdd (a warp's
// 32 lanes hit one 128-byte line), and keeps its share of three dot products:
// sum_c w_c (g.v_c) for grad_attn and the x / y derivative taps for grad_loc.
// Three warp reductions per point finish them; lane 0 writes the point's
// grad_attn and grad_loc. grad_value accumulates in an fp32 buffer; a second
// kernel casts it to bf16 when the value is bf16 (fp32 values accumulate in
// the output directly).
//
// Edges follow the forward: corners off the map read zero and get no
// gradient; coordinates whose corners all lie off the map (also NaN and
// values too large for an int) are skipped before conversion; the floor
// convention keeps both derivative taps active at integer coordinates
// (msda_pallas.py:1249-1256). grad_loc carries the chain-rule factors
// attn * W and attn * H (msda_pallas.py:1401-1406).
//
// Determinism: NOT deterministic. The fp32 atomicAdd into grad_value sums the
// corners of different queries in an order that changes from run to run
// (the TPU kernel's contraction is deterministic); grad_loc and grad_attn are
// deterministic. Checks compare with a tolerance that covers the
// reassociation, not bit-equality.
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2) fp32;
// attn (B, Lq, M, L, P) fp32; g (B, Lq, M, D) in the value dtype; dvalue_f32
// (B, S, M, D) fp32 scratch (zeroed here); dvalue (B, S, M, D) in the value
// dtype (may alias dvalue_f32 for fp32); dloc, dattn fp32 like loc, attn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// CPL: channels per lane, ceil(D / 32).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, const T* __restrict__ g,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ dattn, int Lq, int S, int M, int D, int L,
                int P, long long n_warps, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (warp >= n_warps) return;
  // warp = (b * Lq + q) * M + m
  const int m = (int)(warp % M);
  const long long b = warp / M / Lq;
  const long long row_stride = (long long)M * D;  // one value row s
  const long long vb_off = b * S * row_stride + (long long)m * D;
  const float* lp = loc + warp * (L * P * 2);
  const float* ap = attn + warp * (L * P);
  float* dlp = dloc + warp * (L * P * 2);
  float* dap = dattn + warp * (L * P);

  float gv[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
    const int d = lane + 32 * j;
    gv[j] = d < D ? to_float(g[warp * D + d]) : 0.f;
  }

  for (int l = 0; l < L; ++l) {
    const int H = lv.h[l];
    const int W = lv.w[l];
    const long long lvl_off = vb_off + (long long)lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float a = ap[i];
      // loc * size, then - 0.5, each rounded, as the plain version and
      // JAX round them (__fmul_rn is never contracted into an FMA)
      const float x = __fmul_rn(lp[2 * i], (float)W) - 0.5f;
      const float y = __fmul_rn(lp[2 * i + 1], (float)H) - 0.5f;
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      // no corner on the map (also NaN and values too large for int):
      // every gradient of this point is zero
      if (!(x0f >= -1.f && x0f <= (float)(W - 1) && y0f >= -1.f &&
            y0f <= (float)(H - 1))) {
        if (lane == 0) {
          dap[i] = 0.f;
          dlp[2 * i] = 0.f;
          dlp[2 * i + 1] = 0.f;
        }
        continue;
      }
      const float lx = x - x0f;
      const float ly = y - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      float s_attn = 0.f, s_x = 0.f, s_y = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int dx = c & 1;
        const int dy = c >> 1;
        const int xi = x0 + dx;
        const int yi = y0 + dy;
        if (xi < 0 || xi >= W || yi < 0 || yi >= H) continue;
        const float wx = dx ? lx : 1.f - lx;
        const float wy = dy ? ly : 1.f - ly;
        // floor convention: d wx / dx is -1 at x0, +1 at x0 + 1
        const float sx = dx ? 1.f : -1.f;
        const float sy = dy ? 1.f : -1.f;
        const float w = wx * wy;
        const long long row = lvl_off + ((long long)yi * W + xi) * row_stride;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) {
            dot = fmaf(gv[j], to_float(value[row + d]), dot);
            atomicAdd(dvalue + row + d, a * w * gv[j]);
          }
        }
        s_attn = fmaf(w, dot, s_attn);
        s_x = fmaf(sx * wy, dot, s_x);
        s_y = fmaf(wx * sy, dot, s_y);
      }
      s_attn = warp_sum(s_attn);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        dap[i] = s_attn;
        dlp[2 * i] = s_x * a * (float)W;
        dlp[2 * i + 1] = s_y * a * (float)H;
      }
    }
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16(src[i]);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   const void* g, float* dvalue_f32, float* dloc,
                   float* dattn, int B, int S, int M, int D, int Lq, int L,
                   int P, const Levels& lv, cudaStream_t stream) {
  const long long n_warps = (long long)B * Lq * M;
  const long long blocks = (n_warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* v = static_cast<const T*>(value);
  const float* lc = static_cast<const float*>(loc);
  const float* at = static_cast<const float*>(attn);
  const T* gg = static_cast<const T*>(g);
  if (D <= 32)
    msda_bwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, gg, dvalue_f32, dloc, dattn, Lq, S, M, D, L, P, n_warps,
        lv);
  else
    msda_bwd_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, lc, at, gg, dvalue_f32, dloc, dattn, Lq, S, M, D, L, P, n_warps,
        lv);
  return cudaGetLastError();
}

}  // namespace

// shapes: 2 * L ints (H_l, W_l); starts: L ints. dvalue_f32 is an fp32
// scratch of the value's size (the output itself when the value is fp32).
// Returns a cudaError_t.
extern "C" int msda_bwd(const void* value, const void* loc, const void* attn,
                        const void* g, void* dvalue_f32, void* dvalue,
                        void* dloc, void* dattn, int B, int S, int M, int D,
                        int Lq, int L, int P, const int* shapes,
                        const int* starts, int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1 || B < 0 ||
      S < 0 || M < 0 || Lq < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_value = (long long)B * S * M * D;
  cudaError_t err =
      cudaMemsetAsync(dvalue_f32, 0, sizeof(float) * n_value, s);
  if (err != cudaSuccess) return (int)err;
  if ((long long)B * Lq * M > 0) {
    Levels lv = {};
    for (int l = 0; l < L; ++l) {
      lv.h[l] = shapes[2 * l];
      lv.w[l] = shapes[2 * l + 1];
      lv.start[l] = starts[l];
    }
    float* dv = static_cast<float*>(dvalue_f32);
    float* dl = static_cast<float*>(dloc);
    float* da = static_cast<float*>(dattn);
    err = is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, g, dv, dl, da, B,
                                          S, M, D, Lq, L, P, lv, s)
                  : launch<float>(value, loc, attn, g, dv, dl, da, B, S, M,
                                  D, Lq, L, P, lv, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (is_bf16 && n_value > 0) {
    const long long blocks = (n_value + 255) / 256;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    cast_to_bf16<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(dvalue_f32),
        static_cast<__nv_bfloat16*>(dvalue), n_value);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" const char* msda_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
