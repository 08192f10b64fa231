// Blockwise attention forward with in-kernel dropout and float64 row
// statistics, for Hopper (sm_90a): kernel #4, which also serves #2's
// contract.
//
// Replaces two TPU kernels of item_alignment_tpu/ops/pallas_attention.py:
//   - `_flash_kernel` (:458-519, launched by `_flash_blockwise_impl` :663;
//     public functions `fused_attention_blockwise_dropout` and, at rate 0,
//     `fused_attention_blockwise`), the forward for S > 512;
//   - `_attn_dropout_kernel` (:203-238, launched by
//     `_fused_attention_dropout_impl` :359; public function
//     `fused_attention_dropout` and, at rate 0, the forward of
//     `fused_attention`'s VJP), the forward at S <= 512.
// Both compute, per query row, over key tiles, the running triple (m, l,
// acc) from the finite start m = -1e30:
//
//   x     = q.k / sqrt(H) + key_bias
//   m'    = max(m, rowmax(x)),  alpha = exp(m - m')       (exact running max)
//   p     = exp(x - m')
//   l     = l * alpha + rowsum(p)                          (undropped mass)
//   acc   = acc * alpha + (keep * p) V                     (p rounded to V's type)
//   out   = acc / (max(l, 1e-37) * keep_p)                 (inverted dropout)
//   lse   = m + log(max(l, 1e-37))                         ([B, N, S], float64)
//
// keep is the hashed keep bit of attention_common.cuh, a function of (seed,
// b, n, i, j) alone: the TPU kernels draw theirs from the hardware
// generator, reseeded per tile; here the forward, the dQ and the dK/dV
// kernels (flash_blockwise_bwd.cu) tile differently and still draw the same
// bits.  lse is float64 for the fully masked row: its scores are exactly
// -1e9 (the mask bias swallows q.k in fp32), so an fp32 lse, -1e9 + log(S),
// would round back to -1e9 and the backward's exp(x - lse) give 1 instead
// of 1/S.  The TPU kernels assert S % block == 0; this one masks a ragged
// last tile and takes any S.  Q, K, V and out use the JAX layout
// [B, S, N, H], addressed through strides held in 64 bits.
//
// Bound on this card (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s).  The
// call reads Q, K, V and the key bias once and writes out and lse:
// 4*B*S*N*H*2 + 8*B*N*S + 4*B*S bytes; it does 4*B*N*S^2*H FLOP.  At the
// long train shape B=16, S=1024, N=16, H=64: 68.7 GFLOP -> 0.0695 ms against
// 136 MB -> 0.041 ms, bound by operations.  At #2's train shape B=40,
// S=510: 42.6 GFLOP -> 0.043 ms against 170 MB -> 0.051 ms, bound by bytes.
// A co-limit is the instruction rate of the per-score work (one
// instruction a clock per warp scheduler): beside each score's exponential
// (16 a clock an SM on the special-function unit) go an FMA for x, a max,
// an FMA for the exponent, an add to l and, with dropout, an eighth of a
// 32-bit hash and a quarter of a byte compare that is applied to the
// packed bf16 p.
//
// Design (bf16).  As fused_attention.cu (kernel #1), from the pieces of
// hopper_common.cuh: a block is one consumer warpgroup of 64 queries of one
// (batch row, head) and a producer warpgroup (FwdRing, FwdRegs):
//   - one warp of the producer warpgroup loads the block's Q once by TMA and
//     keeps a two-stage ring of K and V tiles (64 keys each) full, tracked
//     by `mbarrier`s; its lanes write each stage's key bias, which TMA
//     cannot load (the [B, S] fp32 rows are 2040 bytes apart at S = 510).
//     The producer warpgroup gives its registers to the consumers
//     (`setmaxnreg`); the launch checks that the block's pool covers the
//     consumers' raise, so the raise can never wait forever;
//   - every product is a `wgmma` (m64nNk16, fp32 accumulate).  S = Q K^T
//     reads both operands from shared memory, K-major; keep * p is packed
//     to bf16 in registers as the A operand of O += P V, which reads V
//     MN-major through wgmma's transpose;
//   - the per-score work has no branch.  x is one FMA of the raw product
//     with the scale and the key bias, in natural units, bit for bit what
//     the backward recomputes; the exponent is a second FMA, x * log2(e) -
//     c with c = m' * log2(e) rounded to fp32, and the exponential
//     `ex2.approx.ftz` (the special-function unit alone; probabilities below
//     2^-126 flush to zero).  Taking c as the shift keeps lse exact where
//     x is huge: lse = (c + log2 l) / log2(e) in float64, with the same fp32
//     log2(e), is what the exponents summed, so the fully masked row gets
//     -1e9 + log(S).  (A bias premultiplied by log2(e), as #1 takes it,
//     would round -1e9 * log2(e) by up to 64 and move that row's lse by up
//     to 44.)  The row's max element then weighs 2^(m log2(e) - c), not
//     exactly 1: the epilogue scales l for out by that weight rounded to
//     bf16 over the weight, as P V saw it, so that a row one key dominates
//     (the x30 rows of the checks) gives that key's v as exactly as the
//     plain version.  Only the last, ragged tile (510 = 7 * 64 + 62, 1020 =
//     15 * 64 + 60) selects its columns past S to -inf: it is a separate
//     instantiation of the tile step, peeled from the loop.  The row sums
//     stay per thread until the epilogue;
//   - dropout is a template parameter (DROP): the rate-0 forwards (long
//     serving, the forward of fused_attention's VJP) hash nothing.  With it,
//     lanes t and t ^ 1 need the same two hash words of each 8-key group
//     (keys 2t, 2t + 1 of rows g and g + 8 share one word per row); each
//     hashes one and fetches the other by shuffle, as the dK/dV kernel
//     does.  The keep bits apply to p after it is packed to bf16 pairs: two
//     byte permutes and an add turn a word's two bytes into a mask of 16
//     bits each, and one AND applies it (l has summed the undropped p);
//   - the consumer warpgroup waits for each batch of products before it
//     goes on (a wait deferred past the loop's back edge makes ptxas
//     serialise the wgmmas); the other blocks on the SM run their softmax
//     under its products.  So a block holds one consumer warpgroup, and as
//     many blocks share an SM as fit (MIN_BLOCKS): four at H <= 64 (42,536
//     bytes of shared memory a block, 64 registers a thread at entry, the
//     consumers at 104 with dropout too), two at H = 128.  Timed in turns,
//     three blocks an SM at H = 64 ran behind four at both train shapes,
//     with dropout and without (PERF.md).
// fp32 runs the fp32 forward block of attention_f32.cuh, which #1 shares:
// both products on the tensor cores in 3xTF32 (mma.sync m16n8k8), dropout
// a template parameter as here.

#include <cmath>

#include "attention_common.cuh"
#include "attention_f32.cuh"
#include "hopper_common.cuh"

namespace {

using namespace ia;

constexpr int BQ = 64;   // queries per block
constexpr int BKV = 64;  // keys per tile

using Params = FwdParams;

// ---------------------------------------------------------------------------
// bf16: wgmma, a TMA ring and a producer warpgroup
// ---------------------------------------------------------------------------

template <int HD>
struct Fwd {
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : 2;  // blocks an SM
  using Regs = FwdRegs<MIN_BLOCKS>;
  using Ring = FwdRing<HD, 2>;
  static_assert(Regs::CONSUMER_REGS >= 96, "too few registers for the consumers");
};

// DROP: dropout on (threshold > 0); without it no keep bit is hashed
template <int HD, bool DROP>
__global__ void __launch_bounds__(Fwd<HD>::Regs::THREADS, Fwd<HD>::MIN_BLOCKS)
    flash_fwd_bf16(const Params p, const __grid_constant__ QkvMaps maps) {
  using F = Fwd<HD>;
  using R = typename F::Ring;
  using T = TileDesc<BQ, HD>;  // Q, K and V tiles alike: 64 rows
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  ring.init();

  const int S = p.S;
  const int m0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= R::PRODUCER) {
    setmaxnreg_dec<F::Regs::PRODUCER_REGS>();
    if (warp == R::PRODUCER)
      ring.produce(maps, p.bias ? p.bias + b * p.bias_sb : nullptr, 1.f, S, m0, h, b);
    return;
  }

  setmaxnreg_inc<F::Regs::CONSUMER_REGS>();
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = m0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  // dropout: this lane hashes row row0 + 8 * (t & 1); `gather` moves the
  // bytes of keys 2t and 2t + 1 (bytes 2 (t & 1) and 2 (t & 1) + 1 of their
  // word) into the low bytes of two 16-bit halves, and `bump` adds 0x8000 -
  // threshold to each half, whose bit 15 is then the keep bit
  uint32_t rk = 0, gather = 0, bump = 0;
  if constexpr (DROP) {
    const uint32_t hk = head_key(p.seed, uint32_t(b) * p.bn_stride + uint32_t(h) + p.bn_base);
    rk = row_key(hk, uint32_t(row0 + 8 * (t & 1)));
    const uint32_t a = 2 * (t & 1);
    gather = a | 0x40u | (a + 1) << 8 | 0x4000u;
    bump = (0x8000u - p.threshold) * 0x10001u;
  }

  // accumulators (the wgmma layout): rows row0 and row0 + 8 in d[4j + 0, 1]
  // and d[4j + 2, 3] of each 8-column group j, columns 8j + 2t and 8j + 2t + 1
  float o[HD / 2], s[BKV / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < BKV / 2; ++e) s[e] = 0.f;
  float m[2] = {INIT_MAX, INIT_MAX};  // the exact row max of x
  // the exponents' shift: m * log2(e) rounded to fp32
  float c[2] = {INIT_MAX * LOG2E, INIT_MAX * LOG2E};
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
      Wgmma<BKV>::ss(s, T::k_major(ring.q, kk), T::k_major(Kt, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bt + 8 * j + 2 * t);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int e = 4 * j + e4;
        float x = fmaf(s[e], p.scale, e4 & 1 ? bb.y : bb.x);
        if constexpr (RAGGED) x = it * BKV + 8 * j + 2 * t + (e4 & 1) < S ? x : -INFINITY;
        s[e] = x;
        mx[e4 >> 1] = fmaxf(mx[e4 >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float cn = mx[r] * LOG2E;
      alpha[r] = exp2_ftz(c[r] - cn);
      m[r] = mx[r];
      c[r] = cn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
      const float pe = exp2_ftz(fmaf(s[e], LOG2E, -c[(e >> 1) & 1]));
      l[(e >> 1) & 1] += pe;
      s[e] = pe;
    }
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

    // O += (keep * P) V, P rounded to bf16: two 8-key groups of s make one
    // A operand, whose registers hold (row, keys 2t and 2t + 1) of group
    // 2kk for rows row0, row0 + 8, then of group 2kk + 1
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) acc_to_a(pa[kk], s + 8 * kk, s + 8 * kk + 4);
    if constexpr (DROP) {
#pragma unroll
      for (int jk = 0; jk < BKV / 8; ++jk) {
        const uint32_t mine = key_word(rk, uint32_t(it * BKV + 8 * jk + 2 * t));
        const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t word = (t & 1) == r ? mine : other;
          // 0xffff in each half whose key is kept (bit 15 of the half
          // repeated over its two bytes), 0 where it is dropped
          const uint32_t keep = prmt(prmt(word, 0u, gather) + bump, 0u, 0xbb99u);
          pa[jk >> 1][2 * (jk & 1) + r] &= keep;
        }
      }
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) Wgmma<HD>::rs(o, pa[kk], T::mn_major(Vt, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    ring.release(it);  // this warp is done with the stage
  };

  const int n_full = S / BKV;
#pragma unroll 1
  for (int it = 0; it < n_full; ++it) step(it, std::false_type{});
  if (n_full * BKV < S) step(n_full, std::true_type{});

  // l sums 2^(x log2(e) - c), which gives the row's max element pm =
  // 2^(m log2(e) - c), within an ulp of c of 1 but not 1, where P V took
  // it rounded to bf16.  lse takes l as it is; out takes it scaled by
  // bf16(pm) / pm, so that a row that one key dominates gives that key's v
  // divided by keep_p as exactly as a softmax whose max element is 1.
  float denom[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] = fmaxf(quad_sum(l[r]), MIN_DENOM);
    const float pm = exp2_ftz(fmaf(m[r], LOG2E, -c[r]));
    denom[r] = fmaxf(lsum[r] / pm * __bfloat162float(__float2bfloat16_rn(pm)), MIN_DENOM);
  }
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sn;
  double* lse = p.lse + ((long long)b * p.N + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= S) continue;
    // log of the sum of exp(x): the exponents summed 2^(x log2(e) - c)
    // with this fp32 log2(e), so the float64 lse divides by the same one
    if (t == 0) lse[i] = (double(c[r]) + log2(double(lsum[r]))) / double(LOG2E);
    const float div = denom[r] * p.keep_p;
    bf16* orow = op + (long long)i * p.o_ss + 2 * t;
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jd) = __floats2bfloat162_rn(
          o[4 * jd + 2 * r] / div, o[4 * jd + 2 * r + 1] / div);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the fp32 forward block of attention_f32.cuh, with lse
// ---------------------------------------------------------------------------

template <int HD, bool DROP>
__global__ void __launch_bounds__(THREADS, F32FwdTiles<HD>::MIN_BLOCKS) flash_fwd_f32(const Params p) {
  f32_fwd_block<HD, DROP, true>(p);
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 1) {
    const void* const src[3] = {p.q, p.k, p.v};
    const long long strides[3][3] = {{p.q_sb, p.q_ss, p.q_sn}, {p.k_sb, p.k_ss, p.k_sn},
                                     {p.v_sb, p.v_ss, p.v_sn}};
    using F = Fwd<HD>;
    return launch_fwd_block<typename F::Regs>(
        p.threshold ? flash_fwd_bf16<HD, true> : flash_fwd_bf16<HD, false>, F::Ring::BYTES, p,
        src, strides, B, p.S, p.N, HD, st);
  }
  return launch_f32_fwd<HD>(p.threshold ? flash_fwd_f32<HD, true> : flash_fwd_f32<HD, false>, p,
                            B, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64 or 128.  Strides are
// in elements; the head dimension must be contiguous, and for bfloat16 the
// pointers must be 16-byte aligned and the other strides multiples of 8
// and, where the size is above 1, positive (TMA).  `bias` may be null;
// `lse` is a contiguous float64 [B, N, S].  threshold = round(rate * 256)
// (0: no dropout), keep_p = 1 - threshold / 256.  The keep bit of (b, n)
// hashes b * bn_stride + n + bn_base (N and 0 for a whole batch; the
// global head count and b0 * bn_stride + n0 for rows b0.. and heads n0.. of
// a larger one).  Any S >= 1.  Returns the
// cudaError_t of the launch (0 on success).
int ia_flash_fwd(int dtype, int head_dim, const void* q, const void* k,
                 const void* v, const void* bias, void* o, void* lse, int B, int S, int N,
                 long long q_sb, long long q_ss, long long q_sn, long long k_sb, long long k_ss,
                 long long k_sn, long long v_sb, long long v_ss, long long v_sn, long long o_sb,
                 long long o_ss, long long o_sn, long long bias_sb, float scale,
                 unsigned int seed, unsigned int threshold, float keep_p,
                 unsigned int bn_stride, unsigned int bn_base, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || (dtype != 0 && dtype != 1) || threshold > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    static_cast<const float*>(bias),
                 o,    static_cast<double*>(lse),
                 S,    N,    q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
                 o_sb, o_ss, o_sn, bias_sb, scale, seed, threshold, keep_p,
                 bn_stride,    bn_base};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_hd<32>(dtype, p, B, st);
  if (head_dim == 64) return launch_hd<64>(dtype, p, B, st);
  if (head_dim == 128) return launch_hd<128>(dtype, p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory a bf16 block at this head dim takes; -1
// for a head dim the kernel does not have
int ia_flash_fwd_smem_bytes(int head_dim) {
  if (head_dim == 32) return Fwd<32>::Ring::BYTES;
  if (head_dim == 64) return Fwd<64>::Ring::BYTES;
  if (head_dim == 128) return Fwd<128>::Ring::BYTES;
  return -1;
}

// the same for an fp32 block (attention_f32.cuh)
int ia_flash_fwd_f32_smem_bytes(int head_dim) {
  if (head_dim == 32) return F32FwdTiles<32>::BYTES;
  if (head_dim == 64) return F32FwdTiles<64>::BYTES;
  if (head_dim == 128) return F32FwdTiles<128>::BYTES;
  return -1;
}

const char* ia_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
