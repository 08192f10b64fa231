// Fused multi-head attention forward for Hopper (sm_90a): kernel #1, the
// serving kernel.
//
// Replaces the TPU kernel `_attn_kernel` (item_alignment_tpu/ops/
// pallas_attention.py:63-84, launched by `_fused_attention_impl`, public
// function `fused_attention`):
//
//   out = softmax(Q K^T / sqrt(H) + key_bias) V
//
// with fp32 scores and softmax statistics, the unnormalised probabilities
// rounded to V's dtype before the P.V product, and a final divide by
// max(rowsum, 1e-37).  Q, K, V and the output use the JAX layout
// [B, S, N, H] and are addressed through strides (the fused-QKV split views
// included), S <= 512, H in {32, 64, 128}.
//
// The TPU kernel holds a whole [S, S] fp32 score tile per head in VMEM; at
// S = 512 that is 1 MiB, far beyond the 227 KB of shared memory of an H100
// block, so this kernel is blocked: a loop over 64-key tiles with an online
// softmax whose running max is the exact row max seen so far (never an
// upper bound: see the note on large-norm rows in pallas_attention.py),
// starting at the finite -1e30, so a row whose keys all carry the -1e9 mask
// bias gives the uniform mean of V instead of NaN.  Keys past S are left out
// of the max and the sum (p = 0), not treated as masked keys.
//
// Bound on this card (H100 SXM datasheet: 989 TFLOP/s dense bf16, 3.35
// TB/s; NVIDIA H100 80GB HBM3 at 700 W in our runs).  The call reads Q, K,
// V and the key bias once and writes O: 4*B*S*N*H*2 bytes + 4*B*S; it does
// 4*B*N*S^2*H FLOP.  At B=64, S=510, N=16, H=64: 267.5 MB -> 0.0799 ms
// against 68.2 GFLOP -> 0.0690 ms, so it is bound by bytes at 0.0799 ms.
// A co-limit is the exponentials: the special-function unit issues 16 ex2
// a clock an SM, and the 266M scores at that shape take about 0.07 ms at
// 1.75 GHz; beside each one go an FMA (scale and bias), a max, a subtract
// and an add.
//
// Design (bf16).  A block is one consumer warpgroup of 64 queries and a
// producer warpgroup, the forward block that kernel #4
// (flash_blockwise_fwd.cu) is built from too: FwdRegs, FwdRing and
// launch_fwd_block of hopper_common.cuh, with the key bias staged times
// log2(e):
//   - every product is a `wgmma` (m64nNk16, fp32 accumulate).  S = Q K^T
//     reads both operands from shared memory, K-major; P is packed to bf16
//     in registers as the register A operand of O += P V, which reads V
//     MN-major through wgmma's transpose, so no tile is stored twice;
//   - one warp of the producer warpgroup loads the block's Q once and keeps
//     a two-stage ring of K and V tiles full by TMA,
//     tracked by `mbarrier`s (full: the TMA bytes and the warp's 32
//     arrivals; empty: one arrival per consumer warp).  Its lanes write each
//     stage's key bias, premultiplied by log2(e), by plain loads: the
//     [B, S] fp32 rows are 2040 or 1020 bytes apart at S = 510 or 255, not
//     the multiple of 16 that TMA's strides need.  TMA zero-fills rows past
//     S, and the epilogue stores no query row past S;
//   - the producer warpgroup gives its registers to the consumers
//     (`setmaxnreg`); a launch checks that the block's register pool holds
//     what the consumers ask for, so the raise can never wait forever;
//   - the per-score work has no branch: a score is one FMA of the raw
//     product with scale * log2(e) and the premultiplied bias, its
//     exponential `ex2.approx.ftz` (the special-function unit alone).  Only
//     the last, ragged tile (510 = 7 * 64 + 62, 255 = 3 * 64 + 63) selects
//     its columns past S to -inf: it is a separate instantiation of the
//     tile step, peeled from the loop.  The row sums stay per thread until
//     the end (one shuffle reduction a row, not one a tile);
//   - the consumer warpgroup waits for its products before it goes on; the
//     other blocks on the SM run their softmax under its products.  So a
//     block holds one consumer warpgroup, and as many blocks share an SM as
//     fit: four at H <= 64 (42,536 bytes of shared memory a block, the
//     consumers at 104 registers), two at H = 128 (the consumers at 232).
//     Blocks an SM set the pace: timed in turns at both serving lengths,
//     S = 510 and 255, each added block ran ahead of fewer, and 128
//     queries a block (two consumer warpgroups, one block an SM) ran behind
//     64 at H = 64 and at H = 128 (PERF.md).
// fp32 runs the fp32 forward block of attention_f32.cuh, which #4 shares:
// both products on the tensor cores in 3xTF32 (mma.sync m16n8k8), four
// warps of 16 queries, 32-key tiles split once a block in shared memory.

#include <cmath>

#include "attention_common.cuh"
#include "attention_f32.cuh"
#include "hopper_common.cuh"

namespace {

using namespace ia;

constexpr int BLOCK_N = 64;  // keys per KV tile (bf16)
constexpr int WG_ROWS = 64;  // queries of a consumer warpgroup (bf16)

using Params = FwdParams;  // lse null, no dropout

// ---------------------------------------------------------------------------
// bf16: wgmma, a TMA ring and a producer warpgroup
// ---------------------------------------------------------------------------

template <int HD>
struct Fwd {
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 2;  // as many as fit an SM
  using Regs = FwdRegs<MIN_BLOCKS>;
  using Ring = FwdRing<HD, 2>;
  static_assert(Regs::CONSUMER_REGS >= 96, "too few registers for the consumers");
};

template <int HD>
__global__ void __launch_bounds__(Fwd<HD>::Regs::THREADS, Fwd<HD>::MIN_BLOCKS)
    attn_fwd_bf16(const Params p, const __grid_constant__ QkvMaps maps) {
  using F = Fwd<HD>;
  using R = typename F::Ring;
  using T = TileDesc<WG_ROWS, HD>;  // Q, K and V tiles alike: 64 rows
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  ring.init();

  const int S = p.S;
  const int m0 = blockIdx.x * WG_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= R::PRODUCER) {
    setmaxnreg_dec<F::Regs::PRODUCER_REGS>();
    if (warp == R::PRODUCER)
      ring.produce(maps, p.bias ? p.bias + b * p.bias_sb : nullptr, LOG2E, S, m0, h, b);
    return;
  }

  setmaxnreg_inc<F::Regs::CONSUMER_REGS>();
  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale_log2 = p.scale * LOG2E;  // scores in the log2 domain

  // accumulators (the wgmma layout): rows 16 * (warp % 4) + g and that + 8
  // of the warpgroup's 64, in d[4j + 0, 1] and d[4j + 2, 3] of each
  // 8-column group j, columns 8j + 2t and 8j + 2t + 1
  float o[HD / 2], s[BLOCK_N / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < BLOCK_N / 2; ++e) s[e] = 0.f;
  float m[2] = {INIT_MAX, INIT_MAX};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  ring.wait_q();

  // one KV tile; RAGGED (the last tile, S % 64 != 0) selects its columns
  // past S away, every other tile runs no test on any score
  auto step = [&](int it, auto ragged) {
    constexpr bool RAGGED = decltype(ragged)::value;
    const bf16* Kt = ring.k_tile(it);
    const bf16* Vt = ring.v_tile(it);
    const float* bt = ring.key_bias(it);
    ring.wait(it);

    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<BLOCK_N>::ss(s, T::k_major(ring.q, kk), T::k_major(Kt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * j + e4;
        float x = fmaf(s[e], scale_log2, e4 & 1 ? bb.y : bb.x);
        if constexpr (RAGGED) x = it * BLOCK_N + 8 * j + 2 * t + (e4 & 1) < S ? x : -INFINITY;
        s[e] = x;
        mx[e4 >> 1] = fmaxf(mx[e4 >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2_ftz(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < BLOCK_N / 2; ++e) {
      const float pe = exp2_ftz(s[e] - m[(e >> 1) & 1]);
      l[(e >> 1) & 1] += pe;
      s[e] = pe;
    }
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += P V, P rounded to bf16 (two 8-key groups of s make one A operand)
    uint32_t pa[BLOCK_N / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk, s + 8 * kk + 4);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) Wgmma<HD>::rs(o, pa[kk], T::mn_major(Vt, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    ring.release(it);  // this warp is done with the stage
  };

  const int n_full = S / BLOCK_N;
#pragma unroll 1
  for (int it = 0; it < n_full; ++it) step(it, std::false_type{});
  if (n_full * BLOCK_N < S) step(n_full, std::true_type{});

  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) denom[r] = fmaxf(quad_sum(l[r]), MIN_DENOM);
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = m0 + warp * 16 + g + 8 * r;
    if (i >= S) continue;
    bf16* orow = op + (long long)i * p.o_ss + 2 * t;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) = __floats2bfloat162_rn(
          o[4 * jd + 2 * r] / denom[r], o[4 * jd + 2 * r + 1] / denom[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the fp32 forward block of attention_f32.cuh, no lse, no dropout
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(THREADS, F32FwdTiles<HD>::MIN_BLOCKS) attn_fwd_f32(const Params p) {
  f32_fwd_block<HD, false, false>(p);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch_bf16(const Params& p, int B, int N, cudaStream_t st) {
  const void* const src[3] = {p.q, p.k, p.v};
  const long long strides[3][3] = {{p.q_sb, p.q_ss, p.q_sn}, {p.k_sb, p.k_ss, p.k_sn},
                                   {p.v_sb, p.v_ss, p.v_sn}};
  using F = Fwd<HD>;
  return launch_fwd_block<typename F::Regs>(attn_fwd_bf16<HD>, F::Ring::BYTES, p, src, strides, B,
                                            p.S, N, HD, st);
}


}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64 or 128.  Strides are
// in elements; the head dimension must be contiguous, and for bfloat16 the
// pointers must be 16-byte aligned and the other strides multiples of 8 and,
// where the size is above 1, positive (TMA).  `bias` may be null.  Returns
// the cudaError_t of the launch (0 on success).
int ia_fused_attention_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                           const void* bias, void* o, int B, int S, int N, long long q_sb, long long q_ss, long long q_sn, long long k_sb,
                           long long k_ss, long long k_sn, long long v_sb, long long v_ss,
                           long long v_sn, long long o_sb, long long o_ss, long long o_sn,
                           long long bias_sb, float scale, void* stream) {
  const Params p{q,    k,    v,    static_cast<const float*>(bias), o, nullptr, S, N,
                 q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn, o_sb, o_ss, o_sn,
                 bias_sb, scale, 0u, 0u, 1.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (head_dim == 32) return launch_bf16<32>(p, B, N, st);
    if (head_dim == 64) return launch_bf16<64>(p, B, N, st);
    if (head_dim == 128) return launch_bf16<128>(p, B, N, st);
  } else if (dtype == 0) {
    if (head_dim == 32) return launch_f32_fwd<32>(attn_fwd_f32<32>, p, B, st);
    if (head_dim == 64) return launch_f32_fwd<64>(attn_fwd_f32<64>, p, B, st);
    if (head_dim == 128) return launch_f32_fwd<128>(attn_fwd_f32<128>, p, B, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory a bf16 block at this head dim takes; -1
// for a head dim the kernel does not have
int ia_fused_attention_smem_bytes(int head_dim) {
  if (head_dim == 32) return Fwd<32>::Ring::BYTES;
  if (head_dim == 64) return Fwd<64>::Ring::BYTES;
  if (head_dim == 128) return Fwd<128>::Ring::BYTES;
  return -1;
}

// the same for an fp32 block (attention_f32.cuh)
int ia_fused_attention_f32_smem_bytes(int head_dim) {
  if (head_dim == 32) return F32FwdTiles<32>::BYTES;
  if (head_dim == 64) return F32FwdTiles<64>::BYTES;
  if (head_dim == 128) return F32FwdTiles<128>::BYTES;
  return -1;
}

const char* ia_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
