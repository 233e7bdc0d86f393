// Multi-scale deformable attention (MSDA) forward, all levels in one
// launch; hand-written for Hopper (sm_90a).
//
// Replaces: vitadapter/ops/msda_pallas.py::_fwd_ml_kernel, and covers
// ::_fwd_ml_bandmm_kernel (the same function by band matmul, opt-in). The
// TPU kernels build relu one-hot interpolation matrices and contract them
// with the value on the MXU, because gathers are slow on a TPU.
//
// What bounds it on an H100 (80GB HBM3, 700 W): not the bytes. A flagship
// call reads the value rows its points touch (1-11 MB in bf16), fp32
// locations and weights, and writes the output, against one fp32 FMA per
// channel per in-map corner: 0.028 ms at the pixel decoder (bf16) by bytes.
// The first design (one warp per (batch, query, head), lanes on the
// channels, every lane computing every point's geometry, a 2- or 4-byte
// load a lane per corner, the level table read from local memory) took
// 0.796 ms there, bound by instruction issue as the per-level kernels'
// first design was (msda_level.cuh). Now the per-(query, head) work sets
// the time (vitadapter_torch/tools/msda_variants.py at commit 09b25cb, whose
// ablations tools/kernel_variants.py carries on): per flagship bf16
// forward 1.70 ms on uniform locations, 1.64 on model-shaped ones and 1.38
// with every point on one cell (every corner after the first an L1 hit); a
// variant that loads no value (geometry, shuffles and sums only) takes
// 0.77.
//
// Design (msda_level.cuh): a team of G lanes per (batch, query, head), each
// lane owning two 16-byte chunks of the row (K = 2): at D 32, 4 lanes in
// fp32 and 2 in bf16, so a point's geometry, shuffles and addressing serve
// twice the channels they would with one chunk a lane (2.02 ms per
// forward on uniform locations, 1.86 on model-shaped ones). The team walks
// its L * P points in rounds of G, level by level; lane t computes point
// t's level, corner rows, mask and fractions once (`locate_level`, the
// level table staged in shared memory) and the team takes them by
// shuffles; each lane issues its chunks' corner loads (two points at a
// time on the fp32 path) before it uses any. A call's value fits the 50 MB
// L2, so corner reads that neighbouring queries share come from L2. Each
// lane sums its own channels over the points in the order (level, point,
// corner) in fp32 and writes its output chunks once, rounded to the value
// dtype, with 16-byte stores: deterministic. The bilinear x attention
// weight stays fp32 where the TPU kernel rounds it to a bf16 value's dtype
// before its dot.
//
// Layouts (all contiguous): value (B, S, M, D); loc (B, Lq, M, L, P, 2) fp32
// in [0, 1] (x, y); attn (B, Lq, M, L, P) fp32; out (B, Lq, M, D) in the
// value dtype. Level l covers value rows [start[l], start[l] + H_l * W_l).

#include "msda_level.cuh"

namespace {

using namespace msda_level;

template <typename T, int VEC, int G, int K>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, T* __restrict__ out, int Lq,
                int S, int M, int D, int L, int P, LevelTable table) {
  __shared__ int4 levels[kMaxLevels];
  stage_levels(table, levels);
  const Lanes ln = lanes<G>(Lq, M);
  const int C = D / VEC;  // chunks of a row
  const int LP = L * P;
  const long long rs = (long long)M * D;
  const T* vb = value + (long long)ln.b * S * rs + ln.m * D;
  const float* lp = loc + 2 * ln.bqm * LP;
  const float* ap = attn + ln.bqm * LP;

  float sum[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) sum[k][e] = 0.f;
  // rounds of G points, one point's geometry per lane; the same trip
  // counts in every lane, so the shuffles see the whole warp
  for (int first = 0; first < LP; first += G) {
    const int i = first + ln.gl;
    int H, W;
    const Point mine =
        locate_level(lp, ap, i, P, ln.active && i < LP, levels, H, W);
    const int n = LP - first < G ? LP - first : G;
    // two points' corner loads in flight on the fp32 vector path; one
    // elsewhere (as msda_level_fwd.cu)
#pragma unroll (VEC > 1 && sizeof(T) == 4 ? 2 : 1)
    for (int j = 0; j < n; ++j) {
      const Point pt = broadcast(mine, ln.base + j);
      float v[4][K][VEC];
      load_corners<T, VEC, G, K>(vb, rs, pt, (int)(pt.mask >> 4), ln.gl, C,
                                 v);
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
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ch = ln.gl + G * k;
    if (ch < C)
      store_chunk<VEC>(out + ln.bqm * D + ch * VEC, sum[k]);
  }
}

template <typename T, int VEC, int G, int K>
void run(const Shape& s, const void* value, const void* loc,
         const void* attn, void* out, int S, int M, int D, int Lq, int L,
         int P, const LevelTable& table, cudaStream_t stream) {
  msda_fwd_kernel<T, VEC, G, K><<<s.grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(attn), static_cast<T*>(out), Lq, S, M, D, L,
      P, table);
}

template <typename T>
cudaError_t launch(const void* value, const void* loc, const void* attn,
                   void* out, int B, int S, int M, int D, int Lq, int L,
                   int P, const LevelTable& table, cudaStream_t stream) {
  // two 16-byte chunks a lane on the vector path
  const Shape s = shape<T>(D, aligned16(value) && aligned16(out), B, Lq, M,
                           2);
  if (!s.fits) return cudaErrorInvalidConfiguration;
  constexpr int V = 16 / sizeof(T);
#define MSDA_FWD_RUN(VEC, G, K) \
  run<T, VEC, G, K>(s, value, loc, attn, out, S, M, D, Lq, L, P, table, stream)
  if (!s.vec) {
    if (s.K == 1) MSDA_FWD_RUN(1, 32, 1);
    else MSDA_FWD_RUN(1, 32, 2);
  } else {
    switch (s.G) {
      case 1: MSDA_FWD_RUN(V, 1, 2); break;
      case 2: MSDA_FWD_RUN(V, 2, 2); break;
      case 4: MSDA_FWD_RUN(V, 4, 2); break;
      default: MSDA_FWD_RUN(V, 8, 2); break;
    }
  }
#undef MSDA_FWD_RUN
  return cudaGetLastError();
}

}  // namespace

// shapes: 2 * L ints (H_l, W_l); starts: L ints. Returns a cudaError_t.
extern "C" int msda_fwd(const void* value, const void* loc, const void* attn,
                        void* out, int B, int S, int M, int D, int Lq, int L,
                        int P, const int* shapes, const int* starts,
                        int is_bf16, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * Lq * M == 0) return (int)cudaSuccess;
  LevelTable table = {};
  for (int l = 0; l < L; ++l) {
    table.h[l] = shapes[2 * l];
    table.w[l] = shapes[2 * l + 1];
    table.start[l] = starts[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(value, loc, attn, out, B, S, M, D, Lq,
                                      L, P, table, s)
              : launch<float>(value, loc, attn, out, B, S, M, D, Lq, L, P,
                              table, s);
  return (int)err;
}

extern "C" const char* msda_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
