// Pieces shared by the attention kernels: the dropout mask's integer hash,
// warp and quad reductions, the fp32 tile loader of the correctness paths,
// the packing of fp32 accumulators into a bf16 A operand, the float-float
// split of lse and the delta kernel of the backward (flash_blockwise_bwd.cu,
// which serves #3's contract, #5 and #6), for the serving kernel #1
// (fused_attention.cu), the forward #4 that also serves #2's contract
// (flash_blockwise_fwd.cu) and the backward.
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

// bn = b * bn_stride + n + bn_base: the head's index in the global [B, N]
// grid of the step, so that a call on rows b0.. and heads n0.. of a larger
// batch (bn_stride = the global head count, bn_base = b0 * bn_stride + n0)
// draws that slice of the larger call's bits; (N, 0) for a whole batch
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

// Two 8-column groups of an fp32 accumulator (16 rows x 16 cols; lane 4g + t
// holds (row g, cols 2t, 2t+1) in lo[0..1] and (row g+8, ...) in lo[2..3],
// the next group in hi) as one bf16 A operand of a 16-deep product: (row g,
// cols 2t..2t+1), (row g+8, ...), (row g, cols 2t+8..), (row g+8, cols
// 2t+8..) in a[0..3]
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

// The arguments of a forward launch (#1's and #4's, bf16 and fp32): q, k,
// v and out (o) [B, S, N, H] with strides in elements, the [B, S] fp32 key
// bias rows (stride bias_sb) or nullptr, and for #4 the float64 lse
// [B, N, S] and the dropout constants (#1 has no lse and takes threshold 0
// and keep_p 1).
struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* o;
  double* lse;
  int S, N;
  long long q_sb, q_ss, q_sn;
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn;
  long long bias_sb;
  float scale;
  uint32_t seed, threshold;
  float keep_p;
  uint32_t bn_stride, bn_base;  // the keep bits' (b, n) index (see head_key)
};

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
