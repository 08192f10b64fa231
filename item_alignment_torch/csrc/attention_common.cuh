// Pieces shared by the attention-dropout kernels (attention_dropout_fwd.cu,
// attention_dropout_bwd.cu): the dropout mask's integer hash, the mma.sync
// and cp.async helpers, and the tile loaders.
//
// The dropout mask.  The TPU kernels draw their keep bits from the TPU's
// hardware PRNG, which nothing else reproduces.  Here the keep bit of score
// (b, n, i, j) is a pure function of (seed, b, n, i, j), so the forward and
// both backward kernels regenerate the same mask whatever their tiling:
//
//   head = mix32(mix32(seed ^ 0x9e3779b9) ^ (b * N + n))
//   row  = mix32(head ^ i)
//   word = mix32(row ^ (j >> 2))            // 4 bytes: keys 4w .. 4w+3
//   keep = ((word >> (8 * (j & 3))) & 255) >= round(rate * 256)
//
// mix32 is the "lowbias32" integer finaliser (xorshift-multiply, two 32-bit
// multiplies).  The byte is compared with round(rate * 256), as the TPU
// kernels' _keep_mask_u8 compares its uint8 draws, so the effective rate is
// quantised to 1/256.  ops/cuda_attention_train.py:keep_mask_reference
// computes the same bits with int64 tensor ops.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ia {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps
constexpr float INIT_MAX = -1e30f;
constexpr float MIN_DENOM = 1e-37f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t head_key(uint32_t seed, uint32_t bn) {
  return mix32(mix32(seed ^ 0x9e3779b9U) ^ bn);
}

__device__ __forceinline__ uint32_t row_key(uint32_t head, uint32_t i) { return mix32(head ^ i); }

__device__ __forceinline__ uint32_t key_word(uint32_t row, uint32_t j) {
  return mix32(row ^ (j >> 2));
}

__device__ __forceinline__ bool keep_bit(uint32_t word, uint32_t j, uint32_t threshold) {
  return ((word >> (8 * (j & 3))) & 0xffu) >= threshold;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// the four lanes 4g .. 4g+3 of an mma fragment row hold one row between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with `valid` false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// all but the most recently committed group have landed
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// rows [row0, row0 + ROWS) of one (batch, head) slice -> shared memory with
// row pitch LD (in elements); rows past S are zero-filled
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, long long s_stride,
                                               int row0, int S) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS;
    const int d = (c - r * CHUNKS) * 8;
    const int row = row0 + r;
    const bool valid = row < S;
    cp_async16(dst + r * LD + d, valid ? src + (long long)row * s_stride + d : src, valid);
  }
}

template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long s_stride,
                                              int row0, int S) {
  for (int c = threadIdx.x; c < ROWS * HD; c += THREADS) {
    const int r = c / HD;
    const int d = c - r * HD;
    const int row = row0 + r;
    dst[r * LD + d] = row < S ? src[(long long)row * s_stride + d] : 0.f;
  }
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulate.
// Fragment ownership: lane = 4g + t.  An accumulator holds (row g, cols 2t,
// 2t+1) in c[0..1] and (row g+8, the same cols) in c[2..3]; an A fragment
// holds (row g, cols 2t..2t+1), (row g+8, ...), (row g, cols 2t+8..), (row
// g+8, cols 2t+8..) in a[0..3].
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 rows x 16 cols, starting at p) of a row-major shared tile
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const bf16* p, int ld, int g, int t) {
  const bf16* base = p + g * ld + 2 * t;
  a[0] = ld_u32(base);
  a[1] = ld_u32(base + 8 * ld);
  a[2] = ld_u32(base + 8);
  a[3] = ld_u32(base + 8 * ld + 8);
}

// B fragment (16 k x 8 n) where the shared tile is row-major [n][k]: the
// k-dimension is contiguous (K in Q K^T)
__device__ __forceinline__ void load_b_frag_nk(uint32_t b[2], const bf16* p, int ld, int g, int t) {
  const bf16* base = p + g * ld + 2 * t;
  b[0] = ld_u32(base);
  b[1] = ld_u32(base + 8);
}

// B fragment (16 k x 8 n) where the shared tile is row-major [k][n]: the
// n-dimension is contiguous (V in P V), through ldmatrix.trans
__device__ __forceinline__ void load_b_frag_kn(uint32_t b[2], const bf16* p, int ld, int lane) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p + (lane & 15) * ld)));
}

// the accumulators s[2kk], s[2kk+1] (16 rows x 16 cols) as one A fragment
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4], const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace ia
