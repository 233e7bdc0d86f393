// Multi-scale deformable attention (MSDA) forward of ONE level, added into
// an fp32 accumulator; hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_sample_kernel (levels with
// H * W > 1024) and ::_sample_kernel_onehot_pf (levels with H * W <= 1024),
// both via _sample_level_pallas, which the JAX dispatch takes level by level
// when one head's value holds more than 8 MiB (msda_pallas.py:858-877). The
// TPU kernels build one-hot interpolation matrices (per sample Wy . V . Wx,
// or all P points folded into one one-hot row) and contract them on the MXU,
// because gathers are slow on a TPU; both compute the same per-level
// function, so one kernel serves both.
//
// What bounds it on an H100 (80GB HBM3, 700 W): not the gathers. Each
// point reads four value rows of D * itemsize bytes (128 at fp32 D 32) at
// data-dependent places, and the arithmetic is one fp32 FMA per channel
// per corner. At the ratio-1.5 pixel decoder (96768 queries, 32 heads) a
// launch took 0.58 ms with every point on one cell (every corner after the
// first an L1 hit), 0.62-0.78 ms on locations shaped as the model makes
// them and 0.65-0.83 ms on uniform ones (vitadapter_torch/tools/
// msda_level_ab.py): the per-(query, head) work sets the time, the fp32
// accumulator's read and write (792 MB; 0.27 ms as one PyTorch add over
// it), the locations and weights, and instruction issue. The gathers stay
// in L2 even on uniform locations: a block's teams take neighbouring
// queries of one head and the heads run in turn, so the value rows in use
// are one head's level (9.4 MB at the finest level).
//
// Design (msda_level.cuh): a team of G lanes per (batch, query, head), 8
// at fp32 D 32 (4 at bf16), each lane owning a 16-byte chunk of the row;
// lane t computes point t's geometry once, the team takes it by shuffles,
// and each lane issues its chunk's four corner loads (two points at a time
// on the fp32 path) before it uses any. Each lane sums its own channels
// over all points and corners in fp32, so no lane adds another's, and adds
// the sum into its chunk of the accumulator row. Each accumulator element
// has one writer and one summation order, and the wrapper launches the
// levels in order on one stream: deterministic. The bilinear x attention
// weight and the sum stay fp32 where the TPU kernels round Wy and tmp * Wx
// (_sample_kernel) or the folded one-hot row (_sample_kernel_onehot_pf) to
// a bf16 value's dtype.
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2) fp32
// in [0, 1] (x, y); attn (B, Lq, M, L, P) fp32; acc (B, Lq, M, D) fp32.
// The level covers value rows [start, start + H * W).

#include "msda_level.cuh"

namespace {

using namespace msda_level;

// The accumulator's VEC fp32 elements at p (read and written by the one
// lane that owns them, so not through the read-only path).
template <int VEC>
__device__ __forceinline__ void load_acc(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = p[e];
  }
}

template <int VEC>
__device__ __forceinline__ void store_acc(float* p, const float* in) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = in[e];
  }
}

// This lane's chunks of its accumulator row (zeros past the row's end and
// for a query past Lq).
template <int VEC, int G, int K>
__device__ __forceinline__ void load_own_acc(const float* acc,
                                             const Lanes& ln, int C, int D,
                                             float (&old)[K][VEC]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = ln.gl + G * k;
    if (ln.active && ch < C) {
      load_acc<VEC>(acc + ln.bqm * D + ch * VEC, old[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) old[k][e] = 0.f;
    }
  }
}

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kThreads)
msda_level_fwd_kernel(const T* __restrict__ value,
                      const float* __restrict__ loc,
                      const float* __restrict__ attn, float* __restrict__ acc,
                      int Lq, int S, int M, int D, int L, int P, int level,
                      int start, int H, int W) {
  const Lanes ln = lanes<G>(Lq, M);
  const int C = D / VEC;  // chunks of a row
  const long long rs = (long long)M * D;
  const T* vl = value + ((long long)ln.b * S + start) * rs + ln.m * D;
  const long long pbase = (ln.bqm * L + level) * P;

  // this lane's chunks of the accumulator row, added to at the end: the
  // vector instantiations read it before the gathers, so its latency hides
  // under theirs; the scalar ones after them (read early, ptxas spilled
  // there)
  float old[K][VEC];
  if constexpr (VEC > 1) load_own_acc<VEC, G, K>(acc, ln, C, D, old);

  float sum[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[k][e] = 0.f;
  // rounds of G points, one point's geometry per lane; the same trip
  // counts in every lane, so the shuffles see the whole warp
  for (int first = 0; first < P; first += G) {
    const int p = first + ln.gl;
    const bool has = ln.active && p < P;
    float lx = 0.f, ly = 0.f, a = 0.f;
    if (has) {
      lx = loc[2 * (pbase + p)];
      ly = loc[2 * (pbase + p) + 1];
      a = attn[pbase + p];
    }
    const Point mine = locate(lx, ly, a, has, H, W);
    const int n = P - first < G ? P - first : G;
    // two points' corner loads in flight on the fp32 vector path; one
    // elsewhere (two made ptxas spill there)
#pragma unroll (VEC > 1 && sizeof(T) == 4 ? 2 : 1)
    for (int i = 0; i < n; ++i) {
      const Point pt = broadcast(mine, ln.base + i);
      float v[4][K][VEC];
      load_corners<T, VEC, G, K>(vl, rs, pt, W, ln.gl, C, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float wgt = ((c & 1) ? pt.fx : 1.f - pt.fx) *
                          ((c >> 1) ? pt.fy : 1.f - pt.fy) * pt.a;
        if (!((pt.mask >> c) & 1u)) continue;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sum[k][e] = fmaf(wgt, v[c][k][e], sum[k][e]);
      }
    }
  }

  if (!ln.active) return;
  if constexpr (VEC == 1) load_own_acc<VEC, G, K>(acc, ln, C, D, old);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = ln.gl + G * k;
    if (ch >= C) continue;
#pragma unroll
    for (int e = 0; e < VEC; ++e) old[k][e] += sum[k][e];
    store_acc<VEC>(acc + ln.bqm * D + ch * VEC, old[k]);
  }
}

template <typename T, int VEC, int G, int K>
void run(const Shape& s, const void* value, const void* loc,
         const void* attn, float* acc, int S, int M, int D, int Lq, int L,
         int P, int level, int start, int H, int W, cudaStream_t stream) {
  msda_level_fwd_kernel<T, VEC, G, K><<<s.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), acc, Lq, S, M, D, L, P, level, start,
      H, W);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   float* acc, int B, int S, int M, int D, int Lq, int L,
                   int P, int level, int start, int H, int W,
                   cudaStream_t stream) {
  const Shape s = shape<T>(D, aligned16(value) && aligned16(acc), B, Lq, M);
  if (!s.fits) return cudaErrorInvalidConfiguration;
  constexpr int V = 16 / sizeof(T);
#define MSDA_LEVEL_RUN(VEC, G, K)                                           \
  run<T, VEC, G, K>(s, value, loc, attn, acc, S, M, D, Lq, L, P, level,     \
                    start, H, W, stream)
  if (!s.vec) {
    if (s.K == 1) MSDA_LEVEL_RUN(1, 32, 1);
    else MSDA_LEVEL_RUN(1, 32, 2);
  } else {
    switch (s.G) {
      case 1: MSDA_LEVEL_RUN(V, 1, 1); break;
      case 2: MSDA_LEVEL_RUN(V, 2, 1); break;
      case 4: MSDA_LEVEL_RUN(V, 4, 1); break;
      case 8: MSDA_LEVEL_RUN(V, 8, 1); break;
      default: MSDA_LEVEL_RUN(V, 16, 1); break;
    }
  }
#undef MSDA_LEVEL_RUN
  return cudaGetLastError();
}

}  // namespace

// Adds level `level` (rows [start, start + H * W) of the value) into the
// fp32 accumulator. Returns a cudaError_t.
extern "C" int msda_level_fwd(const void* value, const void* loc,
                              const void* attn, void* acc, int B, int S,
                              int M, int D, int Lq, int L, int P, int level,
                              int start, int H, int W, int is_bf16,
                              void* stream) {
  if (D < 1 || D > 64 || P < 1 || L < 1 || level < 0 || level >= L ||
      H < 1 || W < 1 || start < 0 || (long long)start + (long long)H * W > S)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * M == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, a, B, S, M, D, Lq, L,
                                      P, level, start, H, W, s)
              : launch<float>(value, loc, attn, a, B, S, M, D, Lq, L, P,
                              level, start, H, W, s);
  return (int)err;
}

extern "C" const char* msda_level_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
