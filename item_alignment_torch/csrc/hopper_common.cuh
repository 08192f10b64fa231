// Hopper (sm_90a) building blocks of the bf16 attention kernels
// (fused_attention.cu, flash_blockwise_fwd.cu, flash_blockwise_bwd.cu):
// mbarriers, TMA tile loads and their tensor maps, wgmma shared-memory
// descriptors and products, setmaxnreg, a flushing exp2, a byte permute,
// and a forward block's registers, shared memory, producer and launch
// (FwdRegs, FwdRing, launch_fwd_block: kernel #4's; fused_attention.cu
// keeps its own copy of the same block, #1's); and for the fp32 kernels,
// 16-byte `cp.async` copies and fp32-accurate products on the tensor cores
// ("3xTF32" on mma.sync m16n8k8, below).
//
// Tiles in shared memory.  A tile of R rows by HD bf16 columns (one row of
// q, k, v or g per sequence position) is stored as HD / W column blocks of
// R rows by W columns, W = min(HD, 64), so that one row of a block is one
// swizzle span: 128 bytes (W = 64, the 128-byte swizzle) or 64 bytes (W =
// 32, the 64-byte swizzle).  TMA writes each block with that swizzle and
// wgmma reads it back through a descriptor of the same mode; both define
// the swizzle on shared-memory address bits, so every block starts on a
// 1024-byte boundary.  Rows past the end of the sequence are zero-filled by
// TMA.
//
// wgmma (m64nNk16, bf16 in, fp32 accumulate) takes its B operand from such
// a tile in one of two orientations:
//   - K-major: the head dimension is the reduction (q k^T, g v^T); one
//     16-deep step is 32 bytes into a row;
//   - MN-major ("transposed", trans-b = 1): the rows are the reduction and
//     the head dimension is N (ds k, p^T g, ds^T q); one step is 16 rows.
// Its accumulator holds, per warp w of the warpgroup and lane 4g + t, rows
// 16w + g and 16w + g + 8 and columns 8j + 2t, 8j + 2t + 1 of every 8-column
// group j, in d[4j .. 4j + 3]: the mma.sync m16n8 layout, repeated.  An A
// operand in registers is the mma.sync m16n8k16 A fragment of the warp's 16
// rows, so two 8-column groups of an accumulator make one (acc_to_a).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace ia {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// box (c0 = column, c1 = row, c2 = head, c3 = batch row) of a [B, S, N, H]
// tensor map -> shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// the column blocks of one ROWS-row tile, rows row0.. of head h, batch row b
template <int ROWS, int HD>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row0, int h, int b) {
  constexpr int W = HD < 64 ? HD : 64;
#pragma unroll
  for (int cb = 0; cb < HD / W; ++cb) tma_load_4d(dst + cb * ROWS * W, map, bar, cb * W, row0, h, b);
}

// ---------------------------------------------------------------------------
// registers
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

// 2^x by the special-function unit alone: exp2f adds a rescale for results
// below 2^-126, which this flushes to zero instead
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// fp32 products on the tensor cores: 3xTF32
// ---------------------------------------------------------------------------
//
// TF32 keeps 11 significant bits.  x = big + small, with big = x rounded to
// TF32 (cvt.rna) and small = the exact rest x - big rounded to TF32 again,
// holds x to 2^-22 of |x|; a b = big_a big_b + big_a small_b + small_a
// big_b + (small_a small_b, below 2^-22 |a b|, dropped).  Each TF32 product
// is exact and the tensor cores accumulate in fp32, so three mma.sync per
// product give fp32 accuracy: CUTLASS's OpMultiplyAddFastF32, in the order
// it issues them (the small terms first).  The tensor cores' fp32
// accumulation truncates, though: a sum held in their accumulator through
// 3 H / 8 mma drifts several times further than fp32's rounded adds, which
// shows where the sum then cancels.  mma_3xtf32_rn takes each 8-deep step
// into a fresh accumulator and adds it in fp32, rounding to nearest.

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile.  Lane 4g + t holds A (16 x 8) as (row g,
// col t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) as (row t, col
// g), (t + 4, g); d as (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in fp32 accuracy from split operands
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

// the same through a fresh accumulator, added to d with rounding to nearest
__device__ __forceinline__ void mma_3xtf32_rn(float (&d)[4], const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4],
                                              const uint32_t (&b_big)[2],
                                              const uint32_t (&b_small)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, a_big, a_small, b_big, b_small);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// the A operand at rows row, row + 8 and columns col, col + 4 of an fp32
// tile in shared memory (row pitch LD floats), split
template <int LD>
__device__ __forceinline__ void a_split(const float* tile, int row, int col, uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  const float* at = tile + row * LD + col;
  split_tf32(at[0], big[0], small[0]);
  split_tf32(at[8 * LD], big[1], small[1]);
  split_tf32(at[4], big[2], small[2]);
  split_tf32(at[8 * LD + 4], big[3], small[3]);
}

// the B operand at offsets off and off + step of a tile split in shared
// memory (big halves in `big`, small ones at the same offsets of `small`)
__device__ __forceinline__ void b_frag(const float* big, const float* small, int off, int step,
                                       uint32_t (&b)[2], uint32_t (&s)[2]) {
  b[0] = __float_as_uint(big[off]);
  b[1] = __float_as_uint(big[off + step]);
  s[0] = __float_as_uint(small[off]);
  s[1] = __float_as_uint(small[off + step]);
}

// An accumulator tile (16 rows x 8 columns) as the A operand of a product
// that contracts over its columns, split.  The contraction takes logical k
// = t and t + 4 to be columns 2t and 2t + 1, which lane 4g + t already
// holds, so no lane exchanges a value; the B operand's lane then loads rows
// 2t and 2t + 1 of its 8-row group (b0, b1).
__device__ __forceinline__ void acc_a_split(const float (&c)[4], uint32_t (&big)[4],
                                            uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// ---------------------------------------------------------------------------
// cp.async: asynchronous global -> shared copies, zero-filled where !ok
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of HD fp32 values from row0 of a [S, HD] slice (row stride
// s_stride elements) into a tile of pitch LD; rows past S are zeros.  vec:
// the slice and its stride allow 16-byte copies, else 4-byte ones.
template <int ROWS, int HD, int LD, int NTHREADS>
__device__ __forceinline__ void f32_tile_async(float* dst, const float* src, long long s_stride,
                                               int row0, int S, bool vec) {
  static_assert(ROWS * HD % (4 * NTHREADS) == 0, "whole 16-byte chunks a thread");
  if (vec) {
#pragma unroll
    for (int u = 0; u < ROWS * HD / (4 * NTHREADS); ++u) {
      const int c = threadIdx.x + u * NTHREADS;
      const int r = c / (HD / 4);
      const int d = (c - r * (HD / 4)) * 4;
      const bool ok = row0 + r < S;
      cp_async16(dst + r * LD + d, ok ? src + (long long)(row0 + r) * s_stride + d : src, ok);
    }
  } else {
    for (int c = threadIdx.x; c < ROWS * HD; c += NTHREADS) {
      const int r = c / HD;
      const int d = c - r * HD;
      const bool ok = row0 + r < S;
      cp_async4(dst + r * LD + d, ok ? src + (long long)(row0 + r) * s_stride + d : src, ok);
    }
  }
}

// A tile of ROWS rows by HD fp32 columns (pitch LD floats) split into TF32
// halves by the block's NTHREADS threads, once for every warp: the big
// halves in place, the small ones at the same offsets of `small`
template <int ROWS, int HD, int LD, int NTHREADS>
__device__ __forceinline__ void split_tile_tf32(float* raw, float* small) {
  static_assert(ROWS * HD % (4 * NTHREADS) == 0, "whole float4s a thread");
#pragma unroll
  for (int u = 0; u < ROWS * HD / (4 * NTHREADS); ++u) {
    const int c = (threadIdx.x + u * NTHREADS) * 4;
    const int off = (c / HD) * LD + c % HD;
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint32_t b[4], sm[4];
    split_tf32(x.x, b[0], sm[0]);
    split_tf32(x.y, b[1], sm[1]);
    split_tf32(x.z, b[2], sm[2]);
    split_tf32(x.w, b[3], sm[3]);
    *reinterpret_cast<uint4*>(raw + off) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + off) = make_uint4(sm[0], sm[1], sm[2], sm[3]);
  }
}

// byte n of the result is byte (sel >> 4n) & 7 of {b, a} (a: bytes 0-3),
// or, where bit 3 of that nibble is set, that byte's sign bit repeated
// over all eight bits
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// every committed batch of this warpgroup has completed
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma wait: it does not know that wgmma writes them later
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (given in bytes, held in 16-byte units) and the swizzle mode (1:
// 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(mode) << 62;
}

// descriptors of a ROWS x HD tile laid out as above, for 16-deep step kk
template <int ROWS, int HD>
struct TileDesc {
  static constexpr int W = HD < 64 ? HD : 64;
  static constexpr uint32_t SPAN = W * 2;           // bytes of one row of a block
  static constexpr uint32_t MODE = W == 64 ? 1 : 2;  // 128- or 64-byte swizzle
  static constexpr uint32_t BLOCK = ROWS * SPAN;     // bytes of one column block
  // the head dimension is the reduction: 16 columns from 16 * kk
  __device__ __forceinline__ static uint64_t k_major(const bf16* tile, int kk) {
    const bf16* p = tile + (kk * 16 / W) * ROWS * W + (kk * 16) % W;
    return smem_desc(p, 16, 8 * SPAN, MODE);
  }
  // the rows are the reduction: rows 16 * kk .. 16 * kk + 15, all columns
  __device__ __forceinline__ static uint64_t mn_major(const bf16* tile, int kk) {
    return smem_desc(tile + kk * 16 * W, BLOCK, 8 * SPAN, MODE);
  }
};

// D (64 x N) = A B (+ D when scale_d is 1) over one 16-deep step.  ss: A and
// B K-major from shared memory; rs: A from registers, B MN-major.
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void ss(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};


// ---------------------------------------------------------------------------
// a forward block (kernels #1 and #4)
// ---------------------------------------------------------------------------

// Registers of a forward block: a consumer warpgroup (warps 0-3) and a
// producer warpgroup (4-7), MIN_BLOCKS blocks an SM.  ptxas gives each
// thread ENTRY_REGS under __launch_bounds__(THREADS, MIN_BLOCKS); the
// producer warpgroup lowers its own to PRODUCER_REGS (setmaxnreg) and the
// consumers raise theirs to CONSUMER_REGS.  The raise waits until the
// block's pool holds POOL registers, so a launch checks the pool first.
template <int MIN_BLOCKS>
struct FwdRegs {
  static constexpr int THREADS = 256;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int ENTRY_REGS = 65536 / (THREADS * MIN_BLOCKS) / 8 * 8;
  static constexpr int RAISED = (THREADS * ENTRY_REGS - 128 * PRODUCER_REGS) / 128 / 8 * 8;
  static constexpr int CONSUMER_REGS = RAISED < 240 ? RAISED : 240;
  static constexpr int POOL = 128 * PRODUCER_REGS + 128 * CONSUMER_REGS;
};

struct QkvMaps {
  CUtensorMap q, k, v;
};

// Shared memory of a forward block, from a 1024-byte boundary: the block's
// Q tile (64 queries), a ring of STAGES stages of a K and a V tile (64 keys
// each), each stage's key bias, and the barriers: full (the TMA bytes and
// the producer warp's 32 arrivals) and empty (one arrival per consumer
// warp) per stage, and one for Q.
template <int HD, int STAGES>
struct FwdRing {
  static constexpr int ROWS = 64;
  static constexpr int PRODUCER = 4;  // the warp that loads
  static constexpr int TILE = ROWS * HD;
  static constexpr uint32_t TILE_BYTES = TILE * 2;
  static constexpr int KV_OFF = TILE_BYTES;
  static constexpr int BIAS_OFF = KV_OFF + STAGES * 2 * TILE_BYTES;
  static constexpr int BAR_OFF = BIAS_OFF + STAGES * ROWS * 4;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment

  bf16* q;
  bf16* kv;  // stage s: K, then V
  float* bias;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;

  __device__ explicit FwdRing(unsigned char* raw) {
    unsigned char* sm = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    q = reinterpret_cast<bf16*>(sm);
    kv = reinterpret_cast<bf16*>(sm + KV_OFF);
    bias = reinterpret_cast<float*>(sm + BIAS_OFF);
    full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
    empty = full + STAGES;
    q_full = empty + STAGES;
  }
  // the stage of key tile `it`
  __device__ const bf16* k_tile(int it) const { return kv + 2 * (it % STAGES) * TILE; }
  __device__ const bf16* v_tile(int it) const { return k_tile(it) + TILE; }
  __device__ const float* key_bias(int it) const { return bias + (it % STAGES) * ROWS; }

  // thread 0 sets up the barriers; every thread of the block calls this
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 32);  // the producer warp's lanes
        mbar_init(&empty[s], 4);  // one per consumer warp
      }
      mbar_init(q_full, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // The producer warp: the block's Q tile (queries m0..) once, then each of
  // the n_tiles K and V tiles into the ring once the consumers have released
  // its stage, with the tile's key bias times bias_scale (0 past S, or
  // everywhere without a bias) written by the warp's lanes.  The [B, S]
  // fp32 bias rows are S * 4 bytes apart, no multiple of 16 at S = 510, so
  // TMA cannot load them.
  __device__ void produce(const QkvMaps& maps, const float* bias_row, float bias_scale, int S,
                          int m0, int h, int b) const {
    const int lane = threadIdx.x % 32;
    const int n_tiles = (S + ROWS - 1) / ROWS;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, TILE_BYTES);
      tma_load_tile<ROWS, HD>(q, &maps.q, q_full, m0, h, b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const int k0 = it * ROWS;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
      for (int r = lane; r < ROWS; r += 32)
        bias[s * ROWS + r] = (bias_row && k0 + r < S) ? bias_row[k0 + r] * bias_scale : 0.f;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        tma_load_tile<ROWS, HD>(kv + 2 * s * TILE, &maps.k, &full[s], k0, h, b);
        tma_load_tile<ROWS, HD>(kv + (2 * s + 1) * TILE, &maps.v, &full[s], k0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  }

  __device__ void wait_q() const { mbar_wait(q_full, 0); }
  __device__ void wait(int it) const { mbar_wait(&full[it % STAGES], (it / STAGES) & 1); }
  // a consumer warp is done with key tile `it` (its products have completed)
  __device__ void release(int it) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[it % STAGES]);
  }
};


// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that no
// -lcuda link is needed; nullptr if the driver has none
inline EncodeTiledFn tensor_map_encoder() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a bf16 [B, S, N, HD] tensor (strides in elements, the
// head dimension contiguous) whose box is one column block of a ROWS-row
// tile, swizzled as TileDesc expects.  A dimension of size 1 may have any
// stride; TMA wants strides that are positive multiples of 16 bytes.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, int B, int S, int N, int HD,
                                 int rows, long long sb, long long ss, long long sn) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const int W = HD < 64 ? HD : 64;
  auto stride = [](long long elems, int size) {
    return cuuint64_t(size == 1 ? 16 : elems * 2);
  };
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(S), cuuint64_t(N), cuuint64_t(B)};
  const cuuint64_t strides[3] = {stride(ss, S), stride(sn, N), stride(sb, B)};
  const cuuint32_t box[4] = {cuuint32_t(W), cuuint32_t(rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A forward block's launch: refuses a build whose registers at
// entry would leave the consumers' raise waiting forever (the block's pool
// below R::POOL), makes the tensor maps of the Q, K and V tiles, and
// launches one block per 64 queries of each (batch row, head).
template <typename R, typename Kernel, typename P>
cudaError_t launch_fwd_block(Kernel kernel, int smem, const P& p, const void* const (&src)[3],
                             const long long (&strides)[3][3], int B, int S, int N, int HD,
                             cudaStream_t st) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * R::THREADS < R::POOL) return cudaErrorInvalidConfiguration;
  QkvMaps maps;
  CUtensorMap* map[3] = {&maps.q, &maps.k, &maps.v};
  for (int i = 0; i < 3; ++i) {
    err = make_tile_map(map[i], src[i], B, S, N, HD, 64, strides[i][0], strides[i][1],
                        strides[i][2]);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + 63) / 64, N, B);
  kernel<<<grid, R::THREADS, smem, st>>>(p, maps);
  return cudaGetLastError();
}

}  // namespace ia
