// Hopper (sm_90a) building blocks shared by the attention kernels: TMA tile
// loads completing on mbarriers, wgmma shared-memory descriptors for the
// swizzled tiles TMA writes, and the bf16 and TF32 wgmma instructions they
// use; for the fp32 kernels, the pre-pass that splits each operand into
// TF32 hi and lo copies (split TF32, below).
//
// Tiles. A (rows, D) bf16 tile of a contiguous (B * H, N, D) tensor is
// loaded by TMA as D / CW column blocks of (rows, CW), CW = 64 (128-byte
// rows, 128-byte swizzle) or, for D = 32, CW = 32 (64-byte rows, 64-byte
// swizzle); each block is 1024-byte aligned. A 3-D tensor map over
// (D, N, B * H) zero-fills rows past N inside each head.
//
// Operands. wgmma reads a tile "K-major" when the product's inner dimension
// is D (S = Q K^T: both Q and K), and "MN-major" when it is the tile's rows
// (O += P V: V is K x N with N = D contiguous). The same tile in shared
// memory serves both; only the descriptor differs.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU (ex2.approx, about 2 ulp, subnormal results flushed to 0):
// exp2f adds range handling to every call that the softmax never needs
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- shared memory, mbarriers, TMA ---------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the calling thread's arrival, expecting `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the barrier's phase of parity `parity` has completed; a wait
// of more than about 10 s (a load that never lands) traps, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) {
    __syncwarp();
    return;
  }
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
  __syncwarp();  // the warp leaves the wait together (for .aligned wgmma)
}

// one (CW, rows, 1) box of a 3-D tensor map at (column c0, row c1, head c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---- tiles ---------------------------------------------------------------

template <int D, int ROWS>
struct Tile {
  static constexpr int CW = D == 32 ? 32 : 64;         // columns per block
  static constexpr int NB = D / CW;                    // column blocks
  static constexpr uint32_t BLOCK = ROWS * CW * 2;     // bytes per block
  static constexpr uint32_t BYTES = NB * BLOCK;
  static constexpr uint32_t ATOM = 8 * CW * 2;         // 8 rows of a block
  static constexpr uint32_t LAYOUT = CW == 64 ? 1 : 2; // 128B / 64B swizzle
};

// the whole tile: NB boxes onto one barrier (its expect_tx is the caller's)
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int head) {
  using T = Tile<D, ROWS>;
#pragma unroll
  for (int b = 0; b < T::NB; ++b)
    tma_load_3d(dst + b * T::BLOCK, map, bar, b * T::CW, row, head);
}

// A CTA's shared memory for the attention kernels: OWN tiles of its own
// rows loaded once, a ring of STAGES stages, each a pair of tiles streamed
// in turn (K and V, or Q and dO) that completes on one mbarrier, and EXTRA
// bytes. The base is aligned to 1024 bytes for the swizzled tiles. Every
// thread constructs it (the constructor synchronises the CTA); thread 0
// issues the loads.
template <int D, int OWN, int STAGES, int EXTRA = 0>
struct Staging {
  using T = Tile<D, 64>;
  static constexpr uint32_t RING = OWN * T::BYTES;
  static constexpr uint32_t EXTRA_AT = RING + STAGES * 2 * T::BYTES;
  static constexpr uint32_t BARS = EXTRA_AT + EXTRA;
  static constexpr uint32_t BYTES = BARS + 8 * (STAGES + 1) + 1024;

  uint8_t* smem;
  uint32_t base;
  uint64_t* full;  // the ring's barriers, then the own tiles' one

  __device__ explicit Staging(uint8_t* raw) {
    const uint32_t r = smem_u32(raw);
    smem = raw + (((r + 1023) & ~1023u) - r);
    base = smem_u32(smem);
    full = reinterpret_cast<uint64_t*>(smem + BARS);
    if (threadIdx.x == 0) {
      for (int s = 0; s <= STAGES; ++s) mbar_init(full + s, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // thread 0: the own tiles (maps own0, own1) at `row`, and ring tiles
  // 0 .. STAGES - 1 (maps a, b) of the n the CTA walks, of head `head`
  __device__ void start(const CUtensorMap* own0, const CUtensorMap* own1,
                        int row, const CUtensorMap* a, const CUtensorMap* b,
                        int head, int n) {
    mbar_expect_tx(full + STAGES, OWN * T::BYTES);
    tma_load_tile<D, 64>(smem, own0, full + STAGES, row, head);
    if (OWN == 2)
      tma_load_tile<D, 64>(smem + T::BYTES, own1, full + STAGES, row, head);
    for (int it = 0; it < STAGES && it < n; ++it) load(a, b, it, head);
  }

  __device__ uint32_t own(int i) const { return base + i * T::BYTES; }
  __device__ void wait_own() { mbar_wait(full + STAGES, 0); }
  __device__ uint8_t* extra() const { return smem + EXTRA_AT; }

  // waits for ring tile `it`; the shared address of its pair (the second
  // tile T::BYTES further)
  __device__ uint32_t wait(int it) {
    mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    return base + RING + (it % STAGES) * 2 * T::BYTES;
  }

  // after ring tile `it`'s last use: once every thread is done with it,
  // thread 0 loads tile it + STAGES into its stage, if there is one
  __device__ void refill(const CUtensorMap* a, const CUtensorMap* b, int it,
                         int head, int n) {
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES < n) load(a, b, it + STAGES, head);
  }

 private:
  __device__ void load(const CUtensorMap* a, const CUtensorMap* b, int it,
                       int head) {
    uint64_t* bar = full + it % STAGES;
    uint8_t* st = smem + RING + (it % STAGES) * 2 * T::BYTES;
    mbar_expect_tx(bar, 2 * T::BYTES);
    tma_load_tile<D, 64>(st, a, bar, it * 64, head);
    tma_load_tile<D, 64>(st + T::BYTES, b, bar, it * 64, head);
  }
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)layout << 62;
  return d;
}

// K-major: the tile's rows are the product's M or N, its columns the inner
// dimension; the k16 step t covers columns [16 t, 16 t + 16)
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int t) {
  using T = Tile<D, ROWS>;
  const uint32_t col = 16 * t;
  const uint32_t addr = tile + (col / T::CW) * T::BLOCK + (col % T::CW) * 2;
  return make_desc(addr, 16, T::ATOM, T::LAYOUT);
}

// MN-major: the tile's rows are the inner dimension (the k16 step kk covers
// rows [16 kk, 16 kk + 16)), column block c the N columns. One wgmma never
// spans two blocks, so the offset between blocks is never read; both
// offsets hold the 8-row stride.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int c) {
  using T = Tile<D, ROWS>;
  const uint32_t addr = tile + c * T::BLOCK + kk * 16 * T::CW * 2;
  return make_desc(addr, T::ATOM, T::ATOM, T::LAYOUT);
}

// ---- fp32 tiles for split TF32 ------------------------------------------
//
// TF32 wgmma (m64nNk8) reads both operands K-major only: the product's
// inner dimension contiguous along each tile row. A (ROWS, COLS) fp32 tile
// is loaded by TMA as COLS / CW column blocks of (ROWS, CW): CW = 32
// (128-byte rows, 128-byte swizzle) or, for a 16-column tile, CW = 16
// (64-byte rows, 64-byte swizzle); each block is 1024-byte aligned. A k8
// step is 32 bytes of a row, as a bf16 k16 step is.

template <int COLS, int ROWS>
struct Tile32 {
  static constexpr int CW = COLS >= 32 ? 32 : 16;      // columns per block
  static constexpr int NB = COLS / CW;                 // column blocks
  static constexpr uint32_t BLOCK = ROWS * CW * 4;     // bytes per block
  static constexpr uint32_t BYTES = NB * BLOCK;
  static constexpr uint32_t ATOM = 8 * CW * 4;         // 8 rows of a block
  static constexpr uint32_t LAYOUT = CW == 32 ? 1 : 2; // 128B / 64B swizzle
  static_assert(COLS % CW == 0 && ROWS % 8 == 0, "fp32 tile shape");
};

// the whole tile at (column c0, row r0, head) onto one barrier (its
// expect_tx is the caller's)
template <int COLS, int ROWS>
__device__ __forceinline__ void tma_load_tile32(uint8_t* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int r0,
                                                int head) {
  using T = Tile32<COLS, ROWS>;
#pragma unroll
  for (int b = 0; b < T::NB; ++b)
    tma_load_3d(dst + b * T::BLOCK, map, bar, c0 + b * T::CW, r0, head);
}

// K-major operand of the k8 step t (columns [8 t, 8 t + 8)) from row row0
// (a multiple of 8) of the tile at shared address `tile`
template <int COLS, int ROWS>
__device__ __forceinline__ uint64_t desc_k32(uint32_t tile, int t,
                                             int row0 = 0) {
  using T = Tile32<COLS, ROWS>;
  const uint32_t col = 8 * t;
  const uint32_t addr = tile + (col / T::CW) * T::BLOCK + row0 * T::CW * 4 +
                        (col % T::CW) * 4;
  return make_desc(addr, 16, T::ATOM, T::LAYOUT);
}

// A CTA's shared memory for the fp32 kernels: OWN bytes of tiles loaded
// once (completing on their own mbarrier) and a ring of STAGES stages of
// STAGE bytes, each completing on one mbarrier. The base is aligned to
// 1024 bytes; every thread constructs it (the constructor synchronises the
// CTA) and thread 0 issues the loads.
template <uint32_t OWN, uint32_t STAGE, int STAGES>
struct Ring {
  static constexpr uint32_t BARS = OWN + STAGES * STAGE;
  static constexpr uint32_t BYTES = BARS + 8 * (STAGES + 1) + 1024;

  uint8_t* smem;
  uint64_t* full;  // the stages' barriers, then the own tiles' one

  __device__ explicit Ring(uint8_t* raw) {
    const uint32_t r = smem_u32(raw);
    smem = raw + (((r + 1023) & ~1023u) - r);
    full = reinterpret_cast<uint64_t*>(smem + BARS);
    if (threadIdx.x == 0) {
      for (int s = 0; s <= STAGES; ++s) mbar_init(full + s, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  __device__ uint64_t* own_bar() const { return full + STAGES; }
  __device__ uint8_t* stage(int it) const {
    return smem + OWN + (it % STAGES) * STAGE;
  }
  __device__ uint64_t* bar(int it) const { return full + it % STAGES; }
  __device__ uint32_t wait_own() {
    mbar_wait(full + STAGES, 0);
    return smem_u32(smem);
  }
  // waits for stage load `it`; its shared address
  __device__ uint32_t wait(int it) {
    mbar_wait(bar(it), (it / STAGES) & 1);
    return smem_u32(stage(it));
  }
};

// ---- wgmma ---------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SM90_ACC16(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define SM90_ACC32(d)                                                       \
  SM90_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])

// d (64 x 64, fp32) += A (64 x 16) B (16 x 64), A and B K-major in shared
// memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_ACC32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64), B MN-major
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers) B (16 x 32), B MN-major
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
      "}\n"
      : SM90_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


#define SM90_ACC8(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7])
#define SM90_ACC64(d)                                                       \
  SM90_ACC32(d),                                                            \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),      \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),      \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),      \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),      \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),      \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),      \
      "+f"(d[62]), "+f"(d[63])

// d (64 x N, fp32) += A (64 x 8) B (8 x N) in TF32, B K-major in shared
// memory, A K-major in shared memory (mma_tf32_ss) or in registers
// (mma_tf32_rs, one TF32 value a register: see frag_tf32). The operand
// lists are spelled out: inline asm numbers its operands by position.
#define SM90_TF32_MMA(N, ACC, DLIST, SS_P, SS_AB, RS_P, RS_AB)                \
  __device__ __forceinline__ void mma_tf32_ss(float(&d)[N / 2], uint64_t a, \
                                              uint64_t b) {                 \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
                 DLIST "}, " SS_AB ", p, 1, 1;\n}\n"                         \
                 : ACC(d)                                                   \
                 : "l"(a), "l"(b), "r"(1));                                 \
  }                                                                         \
  __device__ __forceinline__ void mma_tf32_rs(                              \
      float(&d)[N / 2], const uint32_t(&a)[4], uint64_t b) {                \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P ", 0;\n"          \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
                 DLIST "}, " RS_AB ", p, 1, 1;\n}\n"                         \
                 : ACC(d)                                                   \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),      \
                   "r"(1));                                                 \
  }
SM90_TF32_MMA(16, SM90_ACC8,
              "%0, %1, %2, %3, %4, %5, %6, %7",
              "%10", "%8, %9", "%13",
              "{%8, %9, %10, %11}, %12")
SM90_TF32_MMA(32, SM90_ACC16,
              "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
              "%14, %15",
              "%18", "%16, %17", "%21",
              "{%16, %17, %18, %19}, %20")
SM90_TF32_MMA(64, SM90_ACC32,
              "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
              "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
              "%26, %27, %28, %29, %30, %31",
              "%34", "%32, %33", "%37",
              "{%32, %33, %34, %35}, %36")
SM90_TF32_MMA(128, SM90_ACC64,
              "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
              "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
              "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
              "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
              "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
              "%62, %63",
              "%66", "%64, %65", "%69",
              "{%64, %65, %66, %67}, %68")
#undef SM90_TF32_MMA
#undef SM90_ACC64
#undef SM90_ACC8
#undef SM90_ACC32
#undef SM90_ACC16

// two fp32 as a bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragments of the k16 step kk from a 64 x 64 accumulator laid out as
// wgmma writes it (thread: rows r, r + 8; columns 8 j + 2 (lane % 4) + {0,
// 1}): the accumulator's columns become the product's inner dimension.
// `hi` holds bf16(x), `lo` bf16(x - hi), so hi + lo carries x to about
// 2^-17 relative.
__device__ __forceinline__ void frag_hi_lo(const float (&s)[32], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
    __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[r] = *reinterpret_cast<uint32_t*>(&h);
    lo[r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// hi = x with its 13 low mantissa bits cleared: exactly TF32, and x - hi
// is exact in fp32
__device__ __forceinline__ uint32_t tf32_hi_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

// TF32 A fragments of the k8 step kk from a 64 x n accumulator laid out as
// wgmma writes it (thread: rows g, g + 8, g = lane / 4; columns 8 j +
// 2 (lane % 4) + {0, 1}), split into hi and lo = x - hi. wgmma's TF32 A
// fragment holds (rows g, g + 8) x (k = lane % 4, lane % 4 + 4) in a0-a3
// (a0 (g, k), a1 (g + 8, k), a2 (g, k + 4), a3 (g + 8, k + 4)), so the
// accumulator's columns 2 c and 2 c + 1 of each eight are fed as k = c
// and c + 4: the B operand's inner dimension must be stored in that order
// (`k8_source`).
template <int R>
__device__ __forceinline__ void frag_tf32(const float (&x)[R], int kk,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const float v[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1],
                      x[4 * kk + 3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    hi[r] = tf32_hi_bits(v[r]);
    lo[r] = __float_as_uint(v[r] - __uint_as_float(hi[r]));
  }
}

// the accumulator column that a B operand stores at position p of its
// inner dimension (frag_tf32's k order): k = c' holds column 2 c' and
// k = c' + 4 column 2 c' + 1 of each eight
__device__ __forceinline__ int k8_source(int p) {
  const int j = p & 7;
  return (p & ~7) + (j < 4 ? 2 * j : 2 * j - 7);
}

// o (64 x n, fp32) += A B in split TF32, the three products small first
// (A_lo B_hi, A_hi B_lo, A_hi B_hi), A K-major in shared memory
// (descriptors a_hi(t), a_lo(t) of the k8 step t) or from registers
// (hi[t], lo[t]); issued, not waited for
template <int K8, int R, typename AH, typename AL, typename BH, typename BL>
__device__ __forceinline__ void split_ss(float (&o)[R], AH a_hi, AL a_lo,
                                         BH b_hi, BL b_lo) {
#pragma unroll
  for (int t = 0; t < K8; ++t) sm90::mma_tf32_ss(o, a_lo(t), b_hi(t));
#pragma unroll
  for (int t = 0; t < K8; ++t) sm90::mma_tf32_ss(o, a_hi(t), b_lo(t));
#pragma unroll
  for (int t = 0; t < K8; ++t) sm90::mma_tf32_ss(o, a_hi(t), b_hi(t));
}

template <int K8, int R, typename BH, typename BL>
__device__ __forceinline__ void split_rs(float (&o)[R],
                                         const uint32_t (&hi)[K8][4],
                                         const uint32_t (&lo)[K8][4],
                                         BH b_hi, BL b_lo) {
#pragma unroll
  for (int t = 0; t < K8; ++t) sm90::mma_tf32_rs(o, lo[t], b_hi(t));
#pragma unroll
  for (int t = 0; t < K8; ++t) sm90::mma_tf32_rs(o, hi[t], b_lo(t));
#pragma unroll
  for (int t = 0; t < K8; ++t) sm90::mma_tf32_rs(o, hi[t], b_hi(t));
}

// acc (64 x D) = acc * mul + A B: A (64 x 8 K8) split in registers, B^T a
// (D, 8 K8) hi/lo tile pair in shared memory. wgmma truncates as it
// accumulates (about 2^-23 of the running sum a step, with a bias), so a
// sum over all keys kept in its accumulator drifts past fp32's tolerance:
// each tile's product is summed by wgmma into a zeroed accumulator of at
// most W columns at a time and added to acc by a rounded fp32 FMA. Waits
// for its products.
template <int K8, int D, int W = (D > 64 ? 64 : D)>
__device__ __forceinline__ void add_product(float (&acc)[D / 2],
                                            const uint32_t (&hi)[K8][4],
                                            const uint32_t (&lo)[K8][4],
                                            uint32_t b_hi, uint32_t b_lo,
                                            const float (&mul)[2]) {
#pragma unroll
  for (int c = 0; c < D / W; ++c) {
    float t[W / 2];
#pragma unroll
    for (int i = 0; i < W / 2; ++i) t[i] = 0.f;
    fence_regs(t);
    wg_fence();
    split_rs<K8>(
        t, hi, lo,
        [=](int k) { return desc_k32<8 * K8, D>(b_hi, k, c * W); },
        [=](int k) { return desc_k32<8 * K8, D>(b_lo, k, c * W); });
    wg_commit();
    wg_wait_all();
    fence_regs(t);
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      acc[c * W / 2 + i] =
          fmaf(acc[c * W / 2 + i], mul[(i >> 1) & 1], t[i]);
  }
}

// ---- the split pre-pass (fp32) -------------------------------------------

// keys (or queries) of a transposed split copy: N padded to whole 64-row
// tiles
inline int padded_rows(int N) { return (N + 63) / 64 * 64; }

constexpr int kSplitRows = 32;  // rows of x per block of the pre-pass

// x (BH, N, D) fp32 into hi (tf32_hi_bits) and lo = x - hi copies,
// reading x once: rows_hi/lo (BH, N, D) as x is laid out, and cols_hi/lo
// (BH, D, Np) transposed, each eight of the inner dimension in frag_tf32's
// order (k8_source) and zero past N (TF32 wgmma reads this copy as a
// K-major B operand whose inner dimension is N). Either pair may be null.
// One block per 32 rows of one (batch, head).
template <int D>
__global__ void __launch_bounds__(256)
split_tf32(const float* __restrict__ x, float* __restrict__ rows_hi,
           float* __restrict__ rows_lo, float* __restrict__ cols_hi,
           float* __restrict__ cols_lo, int N, int Np) {
  __shared__ float t[kSplitRows][D + 1];
  const int tiles = Np / kSplitRows;
  const long long bh = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * kSplitRows;
  const float* src = x + bh * N * D;
  for (int i = threadIdx.x; i < kSplitRows * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const float v = r0 + r < N ? src[(long long)(r0 + r) * D + c] : 0.f;
    t[r][c] = v;
    if (rows_hi != nullptr && r0 + r < N) {
      const long long o = (bh * N + r0 + r) * D + c;
      const float h = __uint_as_float(tf32_hi_bits(v));
      rows_hi[o] = h;
      rows_lo[o] = v - h;
    }
  }
  if (cols_hi == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < kSplitRows * D; i += blockDim.x) {
    const int d = i / kSplitRows, p = i % kSplitRows;
    const float v = t[k8_source(p)][d];
    const float h = __uint_as_float(tf32_hi_bits(v));
    const long long o = (bh * D + d) * Np + r0 + p;
    cols_hi[o] = h;
    cols_lo[o] = v - h;
  }
}

template <int D>
inline cudaError_t launch_split(const void* x, float* rows_hi,
                                float* rows_lo, float* cols_hi,
                                float* cols_lo, int BH, int N,
                                cudaStream_t stream) {
  const int Np = padded_rows(N);
  const long long blocks = (long long)BH * (Np / kSplitRows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  split_tf32<D><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(x), rows_hi, rows_lo, cols_hi, cols_lo, N,
      Np);
  return cudaGetLastError();
}

// ---- tensor maps (host) --------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime (the
// library does not link libcuda itself)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 3-D map over a contiguous bf16 (BH, N, D) tensor, boxes of (CW, rows,
// 1), swizzled as Tile<D, rows> expects; false if the encoding fails
template <int D, int ROWS>
inline bool make_map(CUtensorMap* map, const void* ptr, int BH, int N) {
  using T = Tile<D, ROWS>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)N * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::CW, (cuuint32_t)ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             T::CW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 3-D map over a contiguous fp32 (BH, rows, cols) tensor, boxes of (CW,
// box_rows, 1), swizzled as Tile32<COLS, box_rows> expects; false if the
// encoding fails
template <int COLS, int BOX_ROWS>
inline bool make_map32(CUtensorMap* map, const void* ptr, int BH, int rows,
                       int cols) {
  using T = Tile32<COLS, BOX_ROWS>;
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)rows * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)T::CW, (cuuint32_t)BOX_ROWS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             T::CW == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
