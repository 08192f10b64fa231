// The fp32 forward block of kernels #1 (fused_attention.cu: attn_fwd_f32,
// the serving kernel) and #4 (flash_blockwise_fwd.cu: flash_fwd_f32, which
// also serves #2's contract), for Hopper (sm_90a): one template for both,
//
//   x   = q.k * scale + key_bias                 (fmaf, natural units)
//   out = softmax(x) V, with the regenerated dropout mask (DROP) and
//   lse = m + log(max(l, 1e-37)) in float64      (LSE: #4 writes it)
//
// over an online softmax whose running max m is the exact row max seen so
// far, from the finite -1e30, so that a row whose keys all carry the -1e9
// mask bias gives the uniform mean of V.  l sums p before dropout; out is
// o / (max(l, 1e-37) * keep_p).  x is the fmaf the fp32 backward
// recomputes (flash_blockwise_bwd.cu), and lse is taken from x in natural
// units: a bias premultiplied by log2(e) would round -1e9 * log2(e) by up
// to 64 and move a fully masked row's lse by up to 44.
//
// Bound on this card (H100 SXM).  The call reads Q, K, V and the key bias
// and writes out (and lse): 4*B*S*N*H*4 + 4*B*S (+ 8*B*N*S) bytes; it does
// 4*B*N*S^2*H FLOP.  In fp32 on the tensor cores every product is three
// TF32 products (3xTF32, hopper_common.cuh), so the least time is the
// lesser of FLOP / 67 TFLOP/s (the fp32 pipe) and 3 FLOP / 495 TFLOP/s
// (dense TF32): at B=8, S=512, N=12, H=64, 6.44 GFLOP -> 0.0390 ms against
// 50.3 MB -> 0.0150 ms, bound by operations.
//
// Design.  The earlier fp32 kernels built each score with H scalar FMAs
// from shared memory, took the 16 rows of a warp one after another and
// sent P through shared memory to another scalar loop for P V: 5.5 TFLOP/s,
// 8% of the fp32 pipe.  Here:
//   - both products run on the tensor cores as mma.sync m16n8k8 TF32 with
//     fp32 accumulate, three per fp32 product (small*big, big*small,
//     big*big: mma_3xtf32), each summed in place in its accumulator:
//     under the CPU model of the tensor cores' truncating accumulation
//     (tests/test_torch_attention_tf32.py, emulated_forward) the in-place
//     sums stay within half the limits in every case, the one-hot row
//     included (fresh accumulators per 8-deep step, as the backward's g v^T
//     needs, are not);
//   - a block is four warps and owns 64 queries of one (batch row, head),
//     16 a warp in the m16n8 accumulator layout (lane 4g + t: rows g and g
//     + 8); it loops over tiles of LOOP = 32 keys, K and V double-buffered
//     by 16-byte cp.async (4-byte copies where a view's alignment or
//     strides do not allow 16), the next tile's key bias (-inf past S, so
//     no score needs a test) written beside them;
//   - each K and V tile is split into TF32 big and small halves once, in
//     shared memory, for all four warps; Q once a block: at H <= 64 each
//     warp keeps the big halves of its A fragments in registers for the
//     whole block (H / 2 a thread) and writes the small halves over the
//     fp32 Q tile, at H = 128 the block splits the Q tile in shared memory
//     (big in place, small beside) and the warps read both from there;
//   - three blocks an SM at H <= 64 (MIN_BLOCKS): with both halves of Q in
//     registers a thread took 174 and two blocks fitted, and the third
//     block ran ahead by 7-33% (PERF.md);
//   - tiles keep a row pitch of H + 4 floats, so that a warp's fragment
//     loads (row g, column t; or rows 2t, 2t + 1, column g) hit 32 banks;
//   - the softmax works on the accumulators in registers: the row max over
//     the quad by two shuffles, p = exp2((x - m) log2(e)) by the
//     special-function unit alone (exp2_ftz), o and l rescaled by alpha, l
//     kept per thread until the epilogue; with dropout, lanes t and t ^ 1
//     share the hash word of each row and 8-key group, so each hashes one
//     row's and takes the other's by shuffle, and the keep bit selects p,
//     with no branch per score; a kernel without dropout hashes nothing;
//   - p feeds P V from the accumulators with no lane exchange: the
//     contraction takes logical k = t, t + 4 to be columns 2t, 2t + 1,
//     which lane 4g + t holds (acc_a_split), and V's B operand comes from
//     rows 2t and 2t + 1 of each 8-row group of the split V tile;
//   - no atomics: a block owns its rows, so results repeat bit for bit.
// Shared memory: 37,120 bytes a block at H = 32, 69,888 at H = 64, 169,216
// at H = 128.

#pragma once

#include <cmath>
#include <cstdint>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace ia {

constexpr int F32_FWD_ROWS = 64;  // queries a block: 4 warps x 16
constexpr int F32_FWD_LOOP = 32;  // keys a tile

// Shared memory of the fp32 forward block: the Q tile (once split: at H <=
// 64 its small halves in place, at H = 128 its big halves in place and the
// small ones beside), two stages of a K and a V tile, the small halves of
// the stage being worked on (whose big halves replace its fp32 values), and
// each stage's key bias; row pitch HD + 4 floats.
template <int HD>
struct F32FwdTiles {
  static constexpr int LD = HD + 4;
  static constexpr bool Q_BIG_IN_REGS = HD <= 64;  // see f32_fwd_block
  static constexpr int LOOP = F32_FWD_LOOP;
  // blocks an SM (__launch_bounds__): three fit in shared memory at H <= 64
  // and then hold a thread to 168 registers; one at H = 128
  static constexpr int MIN_BLOCKS = HD <= 64 ? 3 : 1;
  static constexpr int Q = F32_FWD_ROWS * LD;  // floats
  static constexpr int Q_SMALL = Q_BIG_IN_REGS ? 0 : Q;
  static constexpr int TILE = LOOP * LD;
  static constexpr int BYTES = (Q + Q_SMALL + 6 * TILE + 2 * LOOP) * 4;

  float* q;
  float* q_small;
  float* kv;     // stage s: K, then V
  float* small;  // K's small halves, then V's
  float* bias;

  __device__ explicit F32FwdTiles(unsigned char* smem) {
    q = reinterpret_cast<float*>(smem);
    q_small = q + Q;
    kv = q_small + Q_SMALL;
    small = kv + 4 * TILE;
    bias = small + 2 * TILE;
  }
  __device__ float* k(int s) const { return kv + 2 * s * TILE; }
  __device__ float* v(int s) const { return k(s) + TILE; }
  __device__ float* key_bias(int s) const { return bias + s * LOOP; }
};

// the offset of element i of the A operand at rows row, row + 8 and
// columns col, col + 4 of a tile of pitch LD (a_split's order)
template <int LD>
__device__ __forceinline__ int a_off(int i, int row, int col) {
  return (row + 8 * (i & 1)) * LD + col + 4 * (i >> 1);
}

// The block: one per 64 queries of each (batch row, head) on THREADS
// threads, F32FwdTiles<HD>::BYTES of dynamic shared memory.  DROP: regenerate
// the keep bits (threshold > 0); LSE: write lse.
template <int HD, bool DROP, bool LSE>
__device__ __forceinline__ void f32_fwd_block(const FwdParams& p) {
  using T = F32FwdTiles<HD>;
  constexpr int LD = T::LD;
  constexpr int LOOP = T::LOOP;
  extern __shared__ __align__(128) unsigned char smem[];
  const T sh(smem);

  const int S = p.S;
  const int m0 = blockIdx.x * F32_FWD_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w0 = (tid / 32) * 16;  // the warp's first row in the block
  const int g = lane >> 2;
  const int t = lane & 3;
  // 16-byte copies need every input 16-byte aligned with its strides in
  // multiples of 4 floats; other views take 4-byte copies
  const bool vec =
      ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
        reinterpret_cast<uintptr_t>(p.v)) & 15) == 0 &&
      ((p.q_sb | p.q_ss | p.q_sn | p.k_sb | p.k_ss | p.k_sn | p.v_sb | p.v_ss | p.v_sn) & 3) == 0;
  const float* ks = slice<float>(p.k, b, h, p.k_sb, p.k_sn);
  const float* vs = slice<float>(p.v, b, h, p.v_sb, p.v_sn);
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  // K and V tile `it` into stage s, and its key bias (-inf past S)
  const auto load_tile = [&](int s, int it) {
    f32_tile_async<LOOP, HD, LD, THREADS>(sh.k(s), ks, p.k_ss, it * LOOP, S, vec);
    f32_tile_async<LOOP, HD, LD, THREADS>(sh.v(s), vs, p.v_ss, it * LOOP, S, vec);
    cp_async_commit();
    const int j = it * LOOP + tid;
    if (tid < LOOP) sh.key_bias(s)[tid] = j < S ? (bias ? bias[j] : 0.f) : -INFINITY;
  };

  f32_tile_async<F32_FWD_ROWS, HD, LD, THREADS>(
      sh.q, slice<float>(p.q, b, h, p.q_sb, p.q_sn), p.q_ss, m0, S, vec);
  load_tile(0, 0);  // one cp.async group with Q

  // dropout: lanes t and t ^ 1 need the same hash word of each row and
  // 8-key group (keys 2t and 2t + 1 of a row share one); this lane hashes
  // row g + 8 (t & 1) and takes the other row's word from lane t ^ 1
  uint32_t rk = 0u;
  if constexpr (DROP) {
    const uint32_t hk = head_key(p.seed, uint32_t(b) * p.bn_stride + uint32_t(h) + p.bn_base);
    rk = row_key(hk, uint32_t(m0 + w0 + g + 8 * (t & 1)));
  }

  // Q's A fragments, split once a block: at H <= 64 the big halves stay in
  // registers and the small ones replace the fp32 Q tile (see above)
  constexpr int QREGS = T::Q_BIG_IN_REGS ? HD / 8 : 1;
  uint32_t qb[QREGS][4];
  // accumulators (the m16n8 layout): o[nd] holds rows g and g + 8, columns
  // nd * 8 + 2t and + 1 of the output
  float o[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {INIT_MAX, INIT_MAX};  // the exact row max of x
  float l[2] = {0.f, 0.f};            // this thread's share of the row sums

  const int n_tiles = (S + LOOP - 1) / LOOP;
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(cur ^ 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` (and at it = 0 Q) is in shared memory
    if (it == 0) {
      if constexpr (T::Q_BIG_IN_REGS) {
        // each element of the warp's 16 rows is one lane's: split in place
#pragma unroll
        for (int kd = 0; kd < HD / 8; ++kd)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* at = sh.q + a_off<LD>(i, w0 + g, kd * 8 + t);
            uint32_t small;
            split_tf32(*at, qb[kd][i], small);
            *at = __uint_as_float(small);
          }
      } else {
        split_tile_tf32<F32_FWD_ROWS, HD, LD, THREADS>(sh.q, sh.q_small);
      }
    }
    split_tile_tf32<2 * LOOP, HD, LD, THREADS>(sh.k(cur), sh.small);  // V follows K
    __syncthreads();

    const float* Kt = sh.k(cur);
    const float* Vt = sh.v(cur);
    const float* Ks = sh.small;
    const float* Vs = sh.small + T::TILE;
    const float* bt = sh.key_bias(cur);

    // s = Q K^T: the warp's 16 queries x LOOP keys
    float s[LOOP / 8][4];
#pragma unroll
    for (int nt = 0; nt < LOOP / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 8; ++kd) {
      uint32_t ab[4], as[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int off = a_off<LD>(i, w0 + g, kd * 8 + t);
        if constexpr (T::Q_BIG_IN_REGS) {
          ab[i] = qb[kd][i];
          as[i] = __float_as_uint(sh.q[off]);
        } else {
          ab[i] = __float_as_uint(sh.q[off]);
          as[i] = __float_as_uint(sh.q_small[off]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < LOOP / 8; ++nt) {
        uint32_t bb[2], bs[2];
        b_frag(Kt, Ks, (nt * 8 + g) * LD + kd * 8 + t, 4, bb, bs);
        mma_3xtf32(s[nt], ab, as, bb, bs);
      }
    }

    // x, the running max and p, branch-free: s[nt][2r + c] is row g + 8r,
    // key nt * 8 + 2t + c of the tile
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < LOOP / 8; ++nt) {
      const float2 kb = *reinterpret_cast<const float2*>(bt + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fmaf(s[nt][e], p.scale, e & 1 ? kb.y : kb.x);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_ftz((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < LOOP / 8; ++nt) {
      const uint32_t j = uint32_t(it * LOOP + nt * 8 + 2 * t);
      const uint32_t mine = DROP ? key_word(rk, j) : 0u;
      const uint32_t other = DROP ? __shfl_xor_sync(0xffffffffu, mine, 1) : 0u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t word = (t & 1) == r ? mine : other;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          const float pe = exp2_ftz((s[nt][e] - m[r]) * LOG2E);
          l[r] += pe;
          s[nt][e] = !DROP || keep_bit(word, j + c, p.threshold) ? pe : 0.f;
        }
      }
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];

    // o += (keep * p) V over the tile's keys
#pragma unroll
    for (int kk = 0; kk < LOOP / 8; ++kk) {
      uint32_t pb[4], ps[4];
      acc_a_split(s[kk], pb, ps);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        uint32_t bb[2], bs[2];
        b_frag(Vt, Vs, (kk * 8 + 2 * t) * LD + nd * 8 + g, LD, bb, bs);
        mma_3xtf32(o[nd], pb, ps, bb, bs);
      }
    }
    __syncthreads();  // the stage and the small halves are free again
  }

  float* op = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(quad_sum(l[r]), MIN_DENOM);
    const int i = m0 + w0 + g + 8 * r;
    if (i >= S) continue;
    if constexpr (LSE) {
      if (t == 0) p.lse[((long long)b * p.N + h) * S + i] = double(m[r]) + log(double(denom));
    }
    // one reciprocal a row (two ulps), not a division an element
    const float inv = __fdividef(1.f, denom * p.keep_p);
    float* row = op + (long long)i * p.o_ss + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(row + nd * 8) = make_float2(o[nd][2 * r] * inv, o[nd][2 * r + 1] * inv);
  }
}

// a launch of the fp32 forward block `kernel` (an instantiation of a
// __global__ wrapper of f32_fwd_block<HD, ...>) over every 64 queries of
// each (batch row, head)
template <int HD, typename Kernel>
cudaError_t launch_f32_fwd(Kernel kernel, const FwdParams& p, int B, cudaStream_t st) {
  constexpr int smem = F32FwdTiles<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + F32_FWD_ROWS - 1) / F32_FWD_ROWS, p.N, B);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace ia
