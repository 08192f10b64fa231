// Pieces shared by the attention kernels with row statistics
// (attention_dropout_fwd.cu, attention_dropout_bwd.cu for S <= 512;
// flash_blockwise_fwd.cu, flash_blockwise_bwd.cu for longer sequences): the
// dropout mask's integer hash, the mma.sync and cp.async helpers, the tile
// loaders, the float-float split of lse and the delta kernel of the
// backward passes.
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
#include <type_traits>

namespace ia {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;  // 4 warps
constexpr int DELTA_THREADS = 256;
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

// The B fragments of two adjacent 8-row groups (b0: rows 0..7, b1: rows
// 8..15 of the row-major [n][k] tile at p, the k-dimension contiguous: K in
// Q K^T) over one 16-deep k step, through one ldmatrix.x4: lane 4g + t gets
// (row g, k 2t..2t+1) in b[0] and (row g, k 2t+8..2t+9) in b[1].  Rows must
// be 16-byte aligned.
__device__ __forceinline__ void load_b_frag_nk_x2(uint32_t b0[2], uint32_t b1[2], const bf16* p,
                                                  int ld, int lane) {
  const int m = lane >> 3;  // this lane addresses one row of matrix m
  const bf16* row = p + ((m >> 1) * 8 + (lane & 7)) * ld + (m & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(smem_addr(row)));
}

// An A fragment (16 rows x 16 cols at p of a row-major shared tile) through
// one ldmatrix.x4
__device__ __forceinline__ void load_a_frag_x4(uint32_t a[4], const bf16* p, int ld, int lane) {
  const int m = lane >> 3;
  const bf16* row = p + ((m & 1) * 8 + (lane & 7)) * ld + (m >> 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr(row)));
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

// lse + ln keep_p as a float-float pair: x - hi is exact for the scores
// that matter (a fully masked row's x equals hi), and lo carries the rest
__device__ __forceinline__ void split_lse(double lse, float& hi, float& lo) {
  hi = float(lse);
  lo = float(lse - double(hi));
}

// the (batch row b, head h) slice of a [B, S, N, H] tensor
template <typename T>
__device__ __forceinline__ const T* slice(const void* base, int b, int h, long long sb,
                                          long long sn) {
  return static_cast<const T*>(base) + b * sb + h * sn;
}

// delta[b, n, i] = sum over h of g[b, i, n, h] * out[b, i, n, h] in fp32,
// the row term of both backward passes; one thread per (b, i, n) row
struct DeltaParams {
  const void* g;
  const void* out;
  float* delta;  // [B, N, S]
  int S, N;
  long long g_sb, g_ss, g_sn;
  long long out_sb, out_ss, out_sn;
};

template <typename T, int HD>
__global__ void __launch_bounds__(DELTA_THREADS) attn_delta(DeltaParams p, long long rows) {
  const long long row = (long long)blockIdx.x * DELTA_THREADS + threadIdx.x;
  if (row >= rows) return;
  const int n = int(row % p.N);
  const int i = int(row / p.N % p.S);
  const int b = int(row / ((long long)p.N * p.S));
  const T* gp = static_cast<const T*>(p.g) + b * p.g_sb + i * p.g_ss + n * p.g_sn;
  const T* op = static_cast<const T*>(p.out) + b * p.out_sb + i * p.out_ss + n * p.out_sn;
  float acc = 0.f;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int d = 0; d < HD; d += 8) {  // 16-byte loads
      const uint4 gv = *reinterpret_cast<const uint4*>(gp + d);
      const uint4 ov = *reinterpret_cast<const uint4*>(op + d);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 gf = __bfloat1622float2(g2[c]);
        const float2 of = __bfloat1622float2(o2[c]);
        acc = fmaf(gf.x, of.x, acc);
        acc = fmaf(gf.y, of.y, acc);
      }
    }
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) acc = fmaf(gp[d], op[d], acc);
  }
  p.delta[((long long)b * p.N + n) * p.S + i] = acc;
}

template <typename T, int HD>
cudaError_t launch_delta(const DeltaParams& p, int B, cudaStream_t st) {
  const long long rows = (long long)B * p.S * p.N;
  const unsigned blocks = unsigned((rows + DELTA_THREADS - 1) / DELTA_THREADS);
  attn_delta<T, HD><<<blocks, DELTA_THREADS, 0, st>>>(p, rows);
  return cudaGetLastError();
}

}  // namespace ia
