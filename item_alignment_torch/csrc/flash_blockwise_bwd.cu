// Blockwise attention backward for long sequences (S > 512): a dQ kernel and
// a dK/dV kernel with the forward's dropout mask regenerated, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// item_alignment_tpu/ops/pallas_attention.py (both launched by
// `_flash_blockwise_bwd_impl`, :708 and :734, the backward of
// `fused_attention_blockwise_dropout`) and, with the delta kernel, serves
// the contract of `_attn_dropout_bwd_kernel` (`_fused_attention_dropout_bwd`,
// :402), the backward at S <= 512.  From the forward's float64 lse,
// delta = rowsum(g * out) and x = q.k / sqrt(H) + bias:
//
//   p_r = exp(x - (lse + ln keep_p))                  (= probs / keep_p)
//   ds  = p_r * (where(keep, g v^T, 0) - delta * keep_p)
//   dq  = sum over key tiles   of ds (k / sqrt(H))            (ia_flash_dq)
//   dk  = sum over query tiles of ds^T (q / sqrt(H))          (ia_flash_dkv)
//   dv  = sum over query tiles of (keep * p_r)^T g            (ia_flash_dkv)
//
// with ds and keep * p_r rounded to the input type before their products,
// as the TPU kernels round them.  keep is the hashed keep bit of
// attention_common.cuh, a function of (seed, b, n, i, j) alone, so both
// kernels draw the forward's bits (flash_blockwise_fwd.cu) whatever their
// tiling; the TPU kernels get there by reseeding per (q tile, kv tile).
// x - lse keeps the float64 lse's precision (lse + ln keep_p as a
// float-float pair), so a fully masked row gets the uniform 1/S back.  delta is computed
// outside the TPU kernels (:699-700); here ia_flash_delta launches the delta
// kernel of attention_common.cuh.  The TPU kernels assert S % block == 0;
// these mask a ragged last tile and take any S.  Offsets are held in 64 bits.
//
// Bound on this card (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s), counting
// the products in each body (the TPU CostEstimate attaches 12*B*N*S^2*H to
// both calls): dQ has three (q k^T, g v^T, ds k), 6*B*N*S^2*H FLOP, and
// reads q, k, v, g and writes dq; dK/dV has four (k q^T, v g^T, p^T g,
// ds^T q), 8*B*N*S^2*H FLOP, and reads the same four and writes dk and dv.
// At B=16, S=1024, N=16, H=64 in bf16: dQ 103.1 GFLOP -> 0.104 ms against
// 172 MB -> 0.051 ms; dK/dV 137.4 GFLOP -> 0.139 ms against 206 MB -> 0.061
// ms.  Both are bound by operations.  Beside the products every score
// costs an exp2, the float-float lse, a select for the ragged tail and, with
// dropout, its keep bit: one hash (two multiplies, six shifts and xors) per
// two scores in dQ and per score in dK/dV.  On this card those issue slots,
// not the tensor cores, set the pace, so the design keeps them few and
// interleaved.  In fp32 the same products at fp32 accuracy take three TF32
// tensor-core products each (3xTF32, hopper_common.cuh), so the bound is the
// lesser of FLOP / 67 TFLOP/s (the fp32 pipe) and 3 FLOP / 495 TFLOP/s
// (dense TF32): at B=8, S=512, N=12, H=64, #3's 10*B*N*S^2*H = 16.1 GFLOP
// take 0.0976 ms, dQ's 9.7 GFLOP 0.0586 and dK/dV's 12.9 GFLOP 0.0781.
//
// Design (bf16).  Three entry points, so each kernel is launched, counted
// and timed alone.  No atomics and no cross-block reduction: a dQ block owns
// its query rows and a dK/dV block its key rows, so results repeat bit for
// bit from run to run.  A block is two consumer warpgroups and a producer
// warpgroup, one warp of which loads (hopper_common.cuh has the pieces):
//   - each consumer warpgroup owns 64 rows (queries in dQ, keys in dK/dV),
//     so a block owns 128 and both warpgroups share every looped tile;
//   - the producer warp loads the block's own tiles once and the looped
//     tiles (k, v in dQ; q, g in dK/dV) into a three-stage ring by TMA,
//     with their per-row statistics (the key bias; lse hi/lo, delta *
//     keep_p and the row's hash key) written beside them; `mbarrier`s
//     track each stage full (TMA bytes and the warp's 32 arrivals) and
//     empty (one arrival per consumer warp); `setmaxnreg` moves its
//     warpgroup's registers to the consumers (24 against 240 a thread);
//   - every product is a `wgmma` (m64nNk16, fp32 accumulate): the scores
//     and g v^T read both operands from shared memory, K-major; ds and
//     keep * p_r go from the accumulators straight into register A
//     operands, and their products read q, k or g through `wgmma`'s
//     transpose, so no tile is stored twice;
//   - the per-score work has no branch: every score is computed and the
//     ragged tail and dropped scores selected away, so a thread's 32 scores
//     interleave (branches around each score had kept them in sequence and
//     cost 3x), exp2 is the special-function unit's alone (exp2_ftz), and
//     a kernel without dropout is built without the hash;
//   - a warpgroup waits for each batch of products before it goes on; the
//     two warpgroups interleave, so one's elementwise work runs under the
//     other's products.  (Starting the next tile's scores before waiting
//     for the last products made ptxas serialise the wgmmas and lost.)
// dK/dV scores keys as rows (transposed), so keep * p_r and ds are the A
// operands of dv and dk as they stand; it holds dk, dv and the two score
// tiles (4 x 32 fp32 registers a thread at H = 64), and at H = 128 loops
// over 32-query tiles to stay in registers.
//
// Design (fp32: flash_dq_f32 and flash_dkv_f32, the fp32 route of #3's
// contract and #5/#6 in fp32).  What held the earlier fp32 kernels (scalar
// FMAs on 32 x 32 tiles, both operands read from shared memory, synchronous
// loads, no tensor cores, a float64 subtraction per score) at 5x SDPA and
// 13.7x the fp32-pipe bound was the FMA pipe fed from shared memory.  Now:
//   - every product runs on the tensor cores as mma.sync m16n8k8 TF32 with
//     fp32 accumulate, three per fp32 product (small*big, big*small,
//     big*big, as CUTLASS's OpMultiplyAddFastF32 orders them), which keeps
//     fp32 accuracy to the dropped small*small term (2^-22 relative);
//     g v^T sums each 8-deep step in a fresh accumulator and adds it in
//     fp32 (mma_3xtf32_rn): held in the tensor cores' truncating
//     accumulator through 3 H / 8 mma, dp drifted far enough that a
//     one-hot row's ds = p (dp - delta) missed chip_smoke.py's fp32 limit
//     of 1e-4;
//   - a block is four warps and owns 64 rows (16 a warp: queries in dQ,
//     keys in dK/dV); it loops over 32-row tiles (keys in dQ, queries in
//     dK/dV), double-buffered by 16-byte cp.async (4-byte copies where a
//     view's alignment or strides do not allow 16), with the next tile's
//     statistics loaded into registers under the current tile's work; at
//     H = 128 dK/dV makes two passes over the query tiles, dv then dk, as
//     both accumulators at once (128 registers a thread) spilled;
//   - each looped tile is split into TF32 big and small halves once, in
//     shared memory, for all four warps; the block's own rows are split as
//     each warp loads them (once per 8-deep step and tile);
//   - the tiles keep a row pitch of H + 4 floats, so that a warp's fragment
//     loads (row g, column t; or rows 2t, 2t + 1, column g) hit 32 banks;
//   - ds and keep * p_r feed the next products from the accumulators with
//     no lane exchange: the contraction takes logical k = t, t + 4 to be
//     columns 2t, 2t + 1, which lane 4g + t holds (acc_a_split), and the B
//     operand's lane loads rows 2t, 2t + 1 of its 8-row group;
//   - the per-score work is the bf16 kernels': float-float x - lse,
//     exp2_ftz, branch-free selects of the ragged tail and dropped scores,
//     no hash without dropout; a fully masked row keeps its uniform 1/S.
// 87-88 KB of shared memory a block at H = 64 (two blocks an SM), 169-170
// KB at H = 128 (one).  Looped tiles of 64 rows spilled registers and ran
// slower, and so did splitting the looped tiles in each warp instead of
// once a block.  Three TF32 mma.sync per product, the shared-memory loads
// of their operands and the split set the pace now; wgmma would double the
// tensor rate but wants K-major copies of k, q and g for the contractions
// over rows.

#include <cmath>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace ia;

constexpr int WG_ROWS = 64;                 // rows a consumer warpgroup owns (bf16)
constexpr int CONSUMERS = 2;                // consumer warpgroups a block
constexpr int BOWN = CONSUMERS * WG_ROWS;   // rows a bf16 block owns
constexpr int WS_THREADS = (CONSUMERS + 1) * 128;  // and a producer warpgroup
constexpr int PRODUCER = CONSUMERS * 4;     // the warp of the producer warpgroup that loads
constexpr int STAGES = 3;                   // the looped tiles' ring
// ptxas gives each thread 65536 / WS_THREADS = 168 registers at entry; the
// producer warpgroup hands 144 of its 168 to the consumers (128 x 24 +
// 256 x 240 = 384 x 168)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// rows of a looped tile: keys in dQ; queries in dK/dV, fewer at H = 128
constexpr int DQ_LOOP = 64;
template <int HD>
constexpr int DKV_LOOP = HD == 128 ? 32 : 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* bias;    // [B, S] key bias rows (stride bias_sb), or nullptr
  const double* lse;    // [B, N, S]
  const float* delta;   // [B, N, S]
  void* dq;
  void* dk;
  void* dv;
  int S, N;
  long long q_sb, q_ss, q_sn;
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long g_sb, g_ss, g_sn;
  long long o_sb, o_ss, o_sn;  // dq, dk and dv share one layout
  long long bias_sb;
  float scale;
  uint32_t seed, threshold;
  float keep_p;
  uint32_t bn_stride, bn_base;  // the keep bits' (b, n) index (head_key)
};

// TMA maps of the four inputs: the block's own pair and the looped pair
// (dQ: q, g, then k, v; dK/dV: k, v, then q, g)
struct TmaMaps {
  CUtensorMap own0, own1, loop0, loop1;
};

// Shared memory of a bf16 block, from a 1024-byte boundary: the own pair
// (own0 of both warpgroups, then own1), the ring (loop0 and loop1 of each
// stage), STAT_WORDS 4-byte words of statistics per looped row and stage,
// then the barriers (full and empty per stage, and one for the own tiles).
template <int HD, int BLOOP, int STAT_WORDS>
struct Ring {
  static constexpr int OWN_TILE = WG_ROWS * HD;  // elements
  static constexpr int LOOP_TILE = BLOOP * HD;
  static constexpr uint32_t OWN_TX = 2 * CONSUMERS * OWN_TILE * 2;  // bytes
  static constexpr uint32_t LOOP_TX = 2 * LOOP_TILE * 2;
  static constexpr int STAT = STAT_WORDS * BLOOP;
  static constexpr int STAT_OFF = OWN_TX + STAGES * LOOP_TX;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * STAT * 4;
  static constexpr int BYTES = BAR_OFF + (2 * STAGES + 1) * 8 + 1024;  // + alignment

  bf16* own;
  bf16* loop;
  uint32_t* stat;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_full;

  __device__ explicit Ring(unsigned char* raw) {
    unsigned char* sm = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    own = reinterpret_cast<bf16*>(sm);
    loop = reinterpret_cast<bf16*>(sm + OWN_TX);
    stat = reinterpret_cast<uint32_t*>(sm + STAT_OFF);
    full = reinterpret_cast<uint64_t*>(sm + BAR_OFF);
    empty = full + STAGES;
    own_full = empty + STAGES;
  }
  __device__ bf16* own0(int wg) const { return own + wg * OWN_TILE; }
  __device__ bf16* own1(int wg) const { return own + (CONSUMERS + wg) * OWN_TILE; }
  __device__ bf16* loop0(int s) const { return loop + 2 * s * LOOP_TILE; }
  __device__ bf16* loop1(int s) const { return loop + (2 * s + 1) * LOOP_TILE; }
  __device__ uint32_t* stats(int s) const { return stat + s * STAT; }

  // thread 0 sets up the barriers; every thread of the block calls this
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 32);            // the producer warp's lanes
        mbar_init(&empty[s], CONSUMERS * 4);  // one per consumer warp
      }
      mbar_init(own_full, 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // The producer warp: the own tiles of rows row0.. once, then each looped
  // tile into the ring once the consumers have released its stage, with
  // `stats(words, first row)` written by the warp's lanes beside it.
  template <typename Stats>
  __device__ void produce(const TmaMaps& maps, int row0, int h, int b, int n_tiles,
                          Stats write_stats) const {
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(own_full, OWN_TX);
      for (int c = 0; c < CONSUMERS; ++c) {
        tma_load_tile<WG_ROWS, HD>(own0(c), &maps.own0, own_full, row0 + c * WG_ROWS, h, b);
        tma_load_tile<WG_ROWS, HD>(own1(c), &maps.own1, own_full, row0 + c * WG_ROWS, h, b);
      }
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) + 1) & 1);
      write_stats(stats(s), it * BLOOP);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], LOOP_TX);
        tma_load_tile<BLOOP, HD>(loop0(s), &maps.loop0, &full[s], it * BLOOP, h, b);
        tma_load_tile<BLOOP, HD>(loop1(s), &maps.loop1, &full[s], it * BLOOP, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  }

  // a consumer warp is done with stage s (its products have completed)
  __device__ void release(int s) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }
};

template <int HD>
using DqRing = Ring<HD, DQ_LOOP, 1>;  // the key bias
template <int HD>
using DkvRing = Ring<HD, DKV_LOOP<HD>, 4>;  // lse hi, lse lo, delta * keep_p, row key

// DROP: dropout on (threshold > 0); without it no keep bit is hashed
template <int HD, bool DROP>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dq_bf16(const Params p, const __grid_constant__ TmaMaps maps) {
  constexpr int BLOOP = DQ_LOOP;
  using R = DqRing<HD>;
  using OwnT = TileDesc<WG_ROWS, HD>;
  using LoopT = TileDesc<BLOOP, HD>;
  extern __shared__ unsigned char smem[];
  const R ring(smem);
  ring.init();

  const int S = p.S;
  const int m0 = blockIdx.x * BOWN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (S + BLOOP - 1) / BLOOP;
  const int warp = threadIdx.x / 32;

  if (warp >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > PRODUCER) return;
    const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
    const int lane = threadIdx.x % 32;
    ring.produce(maps, m0, h, b, n_tiles, [&](uint32_t* words, int k0) {
      float* bs = reinterpret_cast<float*>(words);
      for (int r = lane; r < BLOOP; r += 32) bs[r] = (bias && k0 + r < S) ? bias[k0 + r] : 0.f;
    });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4;
    const int lane = threadIdx.x % 32;
    const int w0 = wg * WG_ROWS + (warp % 4) * 16;  // the warp's first row in the block
    const int g = lane >> 2;
    const int t = lane & 3;
    const double* lse = p.lse + ((long long)b * p.N + h) * S;
    const float* delta = p.delta + ((long long)b * p.N + h) * S;
    const uint32_t hk = head_key(p.seed, uint32_t(b) * p.bn_stride + uint32_t(h) + p.bn_base);
    const double log_keep = log(double(p.keep_p));
    float lse_hi[2], lse_lo[2], dkp[2];
    uint32_t rk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + w0 + g + 8 * r;
      const bool ok = i < S;
      split_lse(ok ? lse[i] + log_keep : 0.0, lse_hi[r], lse_lo[r]);
      dkp[r] = ok ? delta[i] * p.keep_p : 0.f;
      rk[r] = row_key(hk, uint32_t(i));
    }
    const uint32_t rk_mine = t & 1 ? rk[1] : rk[0];

    float dq[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dq[e] = 0.f;
    const bf16* Qs = ring.own0(wg);
    const bf16* Gs = ring.own1(wg);
    mbar_wait(ring.own_full, 0);

    float s[BLOOP / 2], dp[BLOOP / 2];
#pragma unroll
    for (int e = 0; e < BLOOP / 2; ++e) s[e] = dp[e] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int k0 = it * BLOOP;
      const bf16* Kt = ring.loop0(st);
      const bf16* Vt = ring.loop1(st);
      const float* bt = reinterpret_cast<const float*>(ring.stats(st));
      mbar_wait(&ring.full[st], (it / STAGES) & 1);

      // s = Q K^T and dp = G V^T: 64 queries of this warpgroup x 64 keys
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<BLOOP>::ss(s, OwnT::k_major(Qs, kk), LoopT::k_major(Kt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<BLOOP>::ss(dp, OwnT::k_major(Gs, kk), LoopT::k_major(Vt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // s <- ds, branch-free so that the 32 scores of a thread interleave;
      // cols 2t, 2t+1 of each 8-key group share one hashed word per row,
      // and lanes t, t ^ 1 the same two words: each hashes its row t & 1
      // and fetches the other.  Keys past S read zero rows and a zero bias:
      // finite or inf, then selected away.
#pragma unroll
      for (int jk = 0; jk < BLOOP / 8; ++jk) {
        const int cj = jk * 8 + 2 * t;
        const uint32_t col = k0 + cj;
        uint32_t words[2] = {0u, 0u};
        if constexpr (DROP) {
          const uint32_t mine = key_word(rk_mine, col);
          const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
          words[0] = t & 1 ? other : mine;
          words[1] = t & 1 ? mine : other;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t word = words[r];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * jk + 2 * r + c;
            const float x = fmaf(s[e], p.scale, bt[cj + c]);
            const float pe = exp2_ftz(((x - lse_hi[r]) - lse_lo[r]) * LOG2E);
            const float pr = int(col) + c < S ? pe : 0.f;
            const bool kp = !DROP || keep_bit(word, col + c, p.threshold);
            s[e] = pr * ((kp ? dp[e] : 0.f) - dkp[r]);
          }
        }
      }

      // dq += ds K over this tile's keys
      uint32_t da[BLOOP / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOOP / 16; ++kk) acc_to_a(da[kk], s + 8 * kk, s + 8 * kk + 4);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOOP / 16; ++kk) Wgmma<HD>::rs(dq, da[kk], LoopT::mn_major(Kt, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
      ring.release(st);
    }

    bf16* dqp = static_cast<bf16*>(p.dq) + b * p.o_sb + h * p.o_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = m0 + w0 + g + 8 * r;
      if (i >= S) continue;
      const long long off = (long long)i * p.o_ss + 2 * t;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        *reinterpret_cast<__nv_bfloat162*>(dqp + off + jd * 8) = __floats2bfloat162_rn(
            dq[4 * jd + 2 * r] * p.scale, dq[4 * jd + 2 * r + 1] * p.scale);
      }
    }
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_dkv_bf16(const Params p, const __grid_constant__ TmaMaps maps) {
  constexpr int BLOOP = DKV_LOOP<HD>;
  using R = DkvRing<HD>;
  using OwnT = TileDesc<WG_ROWS, HD>;
  using LoopT = TileDesc<BLOOP, HD>;
  extern __shared__ unsigned char smem[];
  const R ring(smem);
  ring.init();

  const int S = p.S;
  const int n0 = blockIdx.x * BOWN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (S + BLOOP - 1) / BLOOP;
  const int warp = threadIdx.x / 32;

  if (warp >= PRODUCER) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > PRODUCER) return;
    const int lane = threadIdx.x % 32;
    const double* lse = p.lse + ((long long)b * p.N + h) * S;
    const float* delta = p.delta + ((long long)b * p.N + h) * S;
    const uint32_t hk = head_key(p.seed, uint32_t(b) * p.bn_stride + uint32_t(h) + p.bn_base);
    const double log_keep = log(double(p.keep_p));
    ring.produce(maps, n0, h, b, n_tiles, [&](uint32_t* words, int q0) {
      float* st = reinterpret_cast<float*>(words);
      for (int r = lane; r < BLOOP; r += 32) {
        const int i = q0 + r;
        const bool ok = i < S;
        split_lse(ok ? lse[i] + log_keep : 0.0, st[r], st[BLOOP + r]);
        st[2 * BLOOP + r] = ok ? delta[i] * p.keep_p : 0.f;
        words[3 * BLOOP + r] = row_key(hk, uint32_t(i));
      }
    });
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4;
    const int lane = threadIdx.x % 32;
    const int w0 = wg * WG_ROWS + (warp % 4) * 16;  // the warp's first row in the block
    const int g = lane >> 2;
    const int t = lane & 3;
    const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
    float kb[2];  // key bias of this thread's two key rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = n0 + w0 + g + 8 * r;
      kb[r] = (bias && j < S) ? bias[j] : 0.f;
    }

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) dk[e] = dv[e] = 0.f;
    const bf16* Ks = ring.own0(wg);
    const bf16* Vs = ring.own1(wg);
    mbar_wait(ring.own_full, 0);

    float s[BLOOP / 2], dp[BLOOP / 2];
#pragma unroll
    for (int e = 0; e < BLOOP / 2; ++e) s[e] = dp[e] = 0.f;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES;
      const int q0 = it * BLOOP;
      const bf16* Qt = ring.loop0(st);
      const bf16* Gt = ring.loop1(st);
      const float* s4 = reinterpret_cast<const float*>(ring.stats(st));
      const uint32_t* rk_s = ring.stats(st) + 3 * BLOOP;
      mbar_wait(&ring.full[st], (it / STAGES) & 1);

      // s = K Q^T and dp = V G^T: 64 keys of this warpgroup x BLOOP queries
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<BLOOP>::ss(s, OwnT::k_major(Ks, kk), LoopT::k_major(Qt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<BLOOP>::ss(dp, OwnT::k_major(Vs, kk), LoopT::k_major(Gt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // The hashed words: lanes 4g + t with one g >> 2 and one t hold the
      // same queries and the same four keys' word (each its own byte), so
      // lane g & 3 hashes the words of query groups jq = g & 3 + 4u and
      // the four lanes share them by shuffle.
      uint32_t mine[DROP ? BLOOP / 32 : 1][4];
      if constexpr (DROP) {
#pragma unroll
        for (int u = 0; u < BLOOP / 32; ++u)
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4)
            mine[u][e4] = key_word(rk_s[8 * ((g & 3) + 4 * u) + 2 * t + (e4 & 1)],
                                   n0 + w0 + g + 8 * (e4 >> 1));
      }

      // s <- keep * p_r, dp <- ds, branch-free as in dQ (queries past S
      // read zero rows and zero statistics)
#pragma unroll
      for (int jq = 0; jq < BLOOP / 8; ++jq) {
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const int e = 4 * jq + e4;
          const int ci = jq * 8 + 2 * t + (e4 & 1);
          const uint32_t j = n0 + w0 + g + 8 * (e4 >> 1);
          const float x = fmaf(s[e], p.scale, kb[e4 >> 1]);
          const float pe = exp2_ftz(((x - s4[ci]) - s4[BLOOP + ci]) * LOG2E);
          const float pr = q0 + ci < S ? pe : 0.f;
          bool kp = true;
          if constexpr (DROP) {
            const int owner = (lane & ~12) | ((jq & 3) << 2);
            kp = keep_bit(__shfl_sync(0xffffffffu, mine[jq / 4][e4], owner), j, p.threshold);
          }
          dp[e] = pr * ((kp ? dp[e] : 0.f) - s4[2 * BLOOP + ci]);
          s[e] = kp ? pr : 0.f;
        }
      }

      // dv += (keep * p_r) G, dk += ds Q over this tile's queries
      uint32_t pa[BLOOP / 16][4], da[BLOOP / 16][4];
#pragma unroll
      for (int kk = 0; kk < BLOOP / 16; ++kk) {
        acc_to_a(pa[kk], s + 8 * kk, s + 8 * kk + 4);
        acc_to_a(da[kk], dp + 8 * kk, dp + 8 * kk + 4);
      }
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BLOOP / 16; ++kk) {
        Wgmma<HD>::rs(dv, pa[kk], LoopT::mn_major(Gt, kk), 1);
        Wgmma<HD>::rs(dk, da[kk], LoopT::mn_major(Qt, kk), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk);
      fence_regs(dv);
      ring.release(st);
    }

    bf16* dkp = static_cast<bf16*>(p.dk) + b * p.o_sb + h * p.o_sn;
    bf16* dvp = static_cast<bf16*>(p.dv) + b * p.o_sb + h * p.o_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = n0 + w0 + g + 8 * r;
      if (j >= S) continue;
      const long long off = (long long)j * p.o_ss + 2 * t;
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        const int e = 4 * jd + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(dkp + off + jd * 8) =
            __floats2bfloat162_rn(dk[e] * p.scale, dk[e + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + off + jd * 8) =
            __floats2bfloat162_rn(dv[e], dv[e + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: 3xTF32 products on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

constexpr int F_ROWS = 64;  // rows an fp32 block owns: 4 warps x 16
constexpr int F_LOOP = 32;  // rows a looped tile: keys in dQ, queries in dK/dV
// what a pass of flash_dkv_f32 over the query tiles accumulates: both at
// H <= 64; at H = 128 dv, then dk, as dk and dv together (128 registers a
// thread) spilled
constexpr int F_DV = 1, F_DK = 2;

// Shared memory of an fp32 block: the own pair (F_ROWS rows each), two
// stages of the looped pair (LOOP rows each), all with a row pitch of HD + 4
// floats, so that the fragment loads of a warp (lane 4g + t at row g and
// column t, or at rows 2t, 2t + 1 and column g) hit 32 different banks; the
// looped pair's small halves (the stage being worked on holds the big ones
// in place of its fp32 values); then STAT_WORDS 4-byte words of statistics
// per looped row and stage.
template <int HD, int LOOP, int STAT_WORDS>
struct F32Tiles {
  static constexpr int LD = HD + 4;
  static constexpr int OWN = F_ROWS * LD;  // floats
  static constexpr int TILE = LOOP * LD;
  static constexpr int SMALL = 2 * TILE;
  static constexpr int STAT = STAT_WORDS * LOOP;
  static constexpr int BYTES = (2 * OWN + 4 * TILE + SMALL + 2 * STAT) * 4;

  float* own0;
  float* own1;
  float* loop;
  float* small;
  uint32_t* stat;

  __device__ explicit F32Tiles(unsigned char* smem) {
    own0 = reinterpret_cast<float*>(smem);
    own1 = own0 + OWN;
    loop = own1 + OWN;
    small = loop + 4 * TILE;
    stat = reinterpret_cast<uint32_t*>(small + SMALL);
  }
  __device__ float* loop0(int s) const { return loop + 2 * s * TILE; }
  __device__ float* loop1(int s) const { return loop + (2 * s + 1) * TILE; }
  __device__ const float* small0() const { return small; }
  __device__ const float* small1() const { return small + TILE; }
  __device__ uint32_t* stats(int s) const { return stat + s * STAT; }

  // a looped pair (rows row0..) into stage s, or the own pair
  __device__ void load_loop(int s, const float* src0, long long ss0, const float* src1,
                            long long ss1, int row0, int S, bool vec) const {
    f32_tile_async<LOOP, HD, LD, THREADS>(loop0(s), src0, ss0, row0, S, vec);
    f32_tile_async<LOOP, HD, LD, THREADS>(loop1(s), src1, ss1, row0, S, vec);
  }
  __device__ void load_own(const float* src0, long long ss0, const float* src1, long long ss1,
                           int row0, int S, bool vec) const {
    f32_tile_async<F_ROWS, HD, LD, THREADS>(own0, src0, ss0, row0, S, vec);
    f32_tile_async<F_ROWS, HD, LD, THREADS>(own1, src1, ss1, row0, S, vec);
  }

  // stage s's pair split once for every warp: big in place, small beside
  // (loop1(s) follows loop0(s) with the same pitch)
  __device__ void split_loop(int s) const {
    split_tile_tf32<2 * LOOP, HD, LD, THREADS>(loop0(s), small);
  }
};

// 16-byte copies need every input 16-byte aligned with its strides in
// multiples of 4 floats; other layouts take 4-byte copies
__device__ __forceinline__ bool f32_vec16(const Params& p) {
  const unsigned long long ptrs =
      reinterpret_cast<unsigned long long>(p.q) | reinterpret_cast<unsigned long long>(p.k) |
      reinterpret_cast<unsigned long long>(p.v) | reinterpret_cast<unsigned long long>(p.g);
  const long long st = p.q_sb | p.q_ss | p.q_sn | p.k_sb | p.k_ss | p.k_sn | p.v_sb | p.v_ss |
                       p.v_sn | p.g_sb | p.g_ss | p.g_sn;
  return (ptrs & 15) == 0 && (st & 3) == 0;
}

// s = own0 loop0^T, then (DP) dp = own1 loop1^T, over the head dim for the
// warp's 16 rows (from row w0) and the stage's LOOP rows; dp through fresh
// accumulators (mma_3xtf32_rn), as ds = p (dp - delta) cancels
template <typename T, int HD, int LOOP, bool DP>
__device__ __forceinline__ void f32_scores(const T& sh, const float* l0, const float* s0,
                                           const float* l1, const float* s1, int w0, int g,
                                           int t, float (&s)[LOOP / 8][4],
                                           float (&dp)[LOOP / 8][4]) {
  constexpr int LD = T::LD;
#pragma unroll
  for (int nt = 0; nt < LOOP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < HD / 8; ++kd) {
    uint32_t ab[4], as[4];
    a_split<LD>(sh.own0, w0 + g, kd * 8 + t, ab, as);
#pragma unroll
    for (int nt = 0; nt < LOOP / 8; ++nt) {
      uint32_t bb[2], bs[2];
      b_frag(l0, s0, (nt * 8 + g) * LD + kd * 8 + t, 4, bb, bs);
      mma_3xtf32(s[nt], ab, as, bb, bs);
    }
  }
  if constexpr (DP) {
#pragma unroll
    for (int kd = 0; kd < HD / 8; ++kd) {
      uint32_t ab[4], as[4];
      a_split<LD>(sh.own1, w0 + g, kd * 8 + t, ab, as);
#pragma unroll
      for (int nt = 0; nt < LOOP / 8; ++nt) {
        uint32_t bb[2], bs[2];
        b_frag(l1, s1, (nt * 8 + g) * LD + kd * 8 + t, 4, bb, bs);
        mma_3xtf32_rn(dp[nt], ab, as, bb, bs);
      }
    }
  }
}

// acc += a l over the stage's LOOP rows, a an accumulator of the warp's 16
// rows x LOOP (acc_a_split's order: the lane's rows 8 kk + 2t, 8 kk + 2t + 1
// of l, small halves in ls)
template <typename T, int HD, int LOOP>
__device__ __forceinline__ void f32_contract(float (&acc)[HD / 8][4], const float (&a)[LOOP / 8][4],
                                             const float* l, const float* ls, int g, int t) {
  constexpr int LD = T::LD;
#pragma unroll
  for (int kk = 0; kk < LOOP / 8; ++kk) {
    uint32_t ab[4], as[4];
    acc_a_split(a[kk], ab, as);
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      uint32_t bb[2], bs[2];
      b_frag(l, ls, (kk * 8 + 2 * t) * LD + nd * 8 + g, LD, bb, bs);
      mma_3xtf32(acc[nd], ab, as, bb, bs);
    }
  }
}

// The loop both fp32 kernels share: the own pair and looped tile 0 go in
// one cp.async group; each step issues the next tile into the other stage,
// lets `prefetch(row0)` start the loads of its statistics, waits for the
// current tile, splits it, runs `body(stage, row0)`, then `commit(stage,
// row0)` writes the prefetched statistics into the other stage.  Barriers:
// after the wait (the tile and its statistics are there), after the split,
// and after the body (the stage and the small halves are free again).
template <typename T, typename Prefetch, typename Commit, typename Body>
__device__ __forceinline__ void f32_loop(const T& sh, int n_tiles, int loop_rows,
                                         const float* l0, long long ss0, const float* l1,
                                         long long ss1, int S, bool vec, Prefetch prefetch,
                                         Commit commit, Body body) {
  for (int it = 0; it < n_tiles; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_tiles) {
      sh.load_loop(cur ^ 1, l0, ss0, l1, ss1, (it + 1) * loop_rows, S, vec);
      cp_async_commit();
      prefetch((it + 1) * loop_rows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    sh.split_loop(cur);
    __syncthreads();
    body(cur, it * loop_rows);
    if (it + 1 < n_tiles) commit(cur ^ 1, (it + 1) * loop_rows);
    __syncthreads();
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_dq_f32(const Params p) {
  constexpr int LOOP = F_LOOP;
  using T = F32Tiles<HD, LOOP, 1>;  // the key bias
  extern __shared__ __align__(128) unsigned char smem[];
  const T sh(smem);

  const int S = p.S;
  const int m0 = blockIdx.x * F_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w0 = (tid / 32) * 16;  // the warp's first row in the block
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec = f32_vec16(p);
  const float* ks = slice<float>(p.k, b, h, p.k_sb, p.k_sn);
  const float* vs = slice<float>(p.v, b, h, p.v_sb, p.v_sn);
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  sh.load_own(slice<float>(p.q, b, h, p.q_sb, p.q_sn), p.q_ss,
              slice<float>(p.g, b, h, p.g_sb, p.g_sn), p.g_ss, m0, S, vec);
  sh.load_loop(0, ks, p.k_ss, vs, p.v_ss, 0, S, vec);
  cp_async_commit();
  const auto key_bias = [&](int k0) {
    return tid < LOOP && bias && k0 + tid < S ? bias[k0 + tid] : 0.f;
  };
  if (tid < LOOP) reinterpret_cast<float*>(sh.stats(0))[tid] = key_bias(0);

  const double* lse = p.lse + ((long long)b * p.N + h) * S;
  const float* delta = p.delta + ((long long)b * p.N + h) * S;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * p.bn_stride + uint32_t(h) + p.bn_base);
  const double log_keep = log(double(p.keep_p));
  float lse_hi[2], lse_lo[2], dkp[2];
  uint32_t rk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = m0 + w0 + g + 8 * r;
    const bool ok = i < S;
    split_lse(ok ? lse[i] + log_keep : 0.0, lse_hi[r], lse_lo[r]);
    dkp[r] = ok ? delta[i] * p.keep_p : 0.f;
    rk[r] = row_key(hk, uint32_t(i));
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
  float kb_next = 0.f;

  f32_loop(
      sh, (S + LOOP - 1) / LOOP, LOOP, ks, p.k_ss, vs, p.v_ss, S, vec,
      [&](int k0) { kb_next = key_bias(k0); },
      [&](int st, int) {
        if (tid < LOOP) reinterpret_cast<float*>(sh.stats(st))[tid] = kb_next;
      },
      [&](int st, int k0) {
        const float* Kt = sh.loop0(st);
        const float* Vt = sh.loop1(st);
        const float* Ks = sh.small0();
        const float* Vs = sh.small1();
        const float* bt = reinterpret_cast<const float*>(sh.stats(st));

        // s = Q K^T and dp = G V^T: the warp's 16 queries x LOOP keys
        float s[LOOP / 8][4], dp[LOOP / 8][4];
        f32_scores<T, HD, LOOP, true>(sh, Kt, Ks, Vt, Vs, w0, g, t, s, dp);

        // s <- ds, branch-free; keys 2t, 2t + 1 of a group of 8 share one
        // hashed word per row.  Keys past S read zero rows and a zero bias
        // (finite or inf, then selected away).
#pragma unroll
        for (int nt = 0; nt < LOOP / 8; ++nt) {
          const int cj = nt * 8 + 2 * t;
          const uint32_t col = k0 + cj;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t word = DROP ? key_word(rk[r], col) : 0u;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int e = 2 * r + c;
              const float x = fmaf(s[nt][e], p.scale, bt[cj + c]);
              const float pe = exp2_ftz(((x - lse_hi[r]) - lse_lo[r]) * LOG2E);
              const float pr = int(col) + c < S ? pe : 0.f;
              const bool kp = !DROP || keep_bit(word, col + c, p.threshold);
              s[nt][e] = pr * ((kp ? dp[nt][e] : 0.f) - dkp[r]);
            }
          }
        }

        // dq += ds K over the tile's keys
        f32_contract<T, HD, LOOP>(dq, s, Kt, Ks, g, t);
      });

  float* dqp = static_cast<float*>(p.dq) + b * p.o_sb + h * p.o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = m0 + w0 + g + 8 * r;
    if (i >= S) continue;
    float* row = dqp + (long long)i * p.o_ss + 2 * t;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(row + nd * 8) =
          make_float2(dq[nd][2 * r] * p.scale, dq[nd][2 * r + 1] * p.scale);
  }
}

template <int HD, bool DROP>
__global__ void __launch_bounds__(THREADS) flash_dkv_f32(const Params p) {
  constexpr int LOOP = F_LOOP;
  using T = F32Tiles<HD, LOOP, 4>;  // lse hi, lse lo, delta * keep_p, row key
  extern __shared__ __align__(128) unsigned char smem[];
  const T sh(smem);

  const int S = p.S;
  const int n0 = blockIdx.x * F_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w0 = (tid / 32) * 16;  // the warp's first row in the block
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool vec = f32_vec16(p);
  const float* qs = slice<float>(p.q, b, h, p.q_sb, p.q_sn);
  const float* gs = slice<float>(p.g, b, h, p.g_sb, p.g_sn);

  // the statistics of query q0 + tid (threads tid < LOOP)
  const double* lse = p.lse + ((long long)b * p.N + h) * S;
  const float* delta = p.delta + ((long long)b * p.N + h) * S;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * p.bn_stride + uint32_t(h) + p.bn_base);
  const double log_keep = log(double(p.keep_p));
  double lse_next = 0.0;
  float dkp_next = 0.f;
  const auto prefetch = [&](int q0) {
    const int i = q0 + tid;
    const bool ok = tid < LOOP && i < S;
    lse_next = ok ? lse[i] + log_keep : 0.0;
    dkp_next = ok ? delta[i] * p.keep_p : 0.f;
  };
  const auto commit = [&](int st, int q0) {
    if (tid >= LOOP) return;
    uint32_t* words = sh.stats(st);
    float* f = reinterpret_cast<float*>(words);
    split_lse(lse_next, f[tid], f[LOOP + tid]);
    f[2 * LOOP + tid] = dkp_next;
    words[3 * LOOP + tid] = row_key(hk, uint32_t(q0 + tid));
  };

  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  float kb[2];  // key bias of the thread's two key rows
  uint32_t j[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    j[r] = n0 + w0 + g + 8 * r;
    kb[r] = (bias && int(j[r]) < S) ? bias[j[r]] : 0.f;
  }

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.f;

  // one pass over the query tiles, accumulating what WHAT names
  const auto pass = [&](auto what) {
    constexpr int WHAT = decltype(what)::value;
    sh.load_loop(0, qs, p.q_ss, gs, p.g_ss, 0, S, vec);
    cp_async_commit();
    prefetch(0);
    commit(0, 0);
    f32_loop(
        sh, (S + LOOP - 1) / LOOP, LOOP, qs, p.q_ss, gs, p.g_ss, S, vec, prefetch, commit,
        [&](int st, int q0) {
          const float* Qt = sh.loop0(st);
          const float* Gt = sh.loop1(st);
          const float* Qs = sh.small0();
          const float* Gs = sh.small1();
          const float* st_f = reinterpret_cast<const float*>(sh.stats(st));
          const uint32_t* st_rk = sh.stats(st) + 3 * LOOP;

          // s = K Q^T and dp = V G^T: the warp's 16 keys x LOOP queries
          float s[LOOP / 8][4], dp[LOOP / 8][4];
          f32_scores<T, HD, LOOP, (WHAT & F_DK) != 0>(sh, Qt, Qs, Gt, Gs, w0, g, t, s, dp);

          // s <- keep * p_r, dp <- ds, branch-free (queries past S read zero
          // rows and zero statistics, then are selected away)
#pragma unroll
          for (int nt = 0; nt < LOOP / 8; ++nt) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int ci = nt * 8 + 2 * t + c;
              const float hi = st_f[ci], lo = st_f[LOOP + ci], dkq = st_f[2 * LOOP + ci];
              const bool valid = q0 + ci < S;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int e = 2 * r + c;
                const float x = fmaf(s[nt][e], p.scale, kb[r]);
                const float pe = exp2_ftz(((x - hi) - lo) * LOG2E);
                const float pr = valid ? pe : 0.f;
                const bool kp = !DROP || keep_bit(key_word(st_rk[ci], j[r]), j[r], p.threshold);
                dp[nt][e] = pr * ((kp ? dp[nt][e] : 0.f) - dkq);
                s[nt][e] = kp ? pr : 0.f;
              }
            }
          }

          // dv += (keep * p_r) G, dk += ds Q over the tile's queries, one
          // after the other (in one pass a 4-byte spill appeared)
          if constexpr ((WHAT & F_DV) != 0) f32_contract<T, HD, LOOP>(dv, s, Gt, Gs, g, t);
          if constexpr ((WHAT & F_DK) != 0) f32_contract<T, HD, LOOP>(dk, dp, Qt, Qs, g, t);
        });
  };
  // rows j of the thread, times `scale`, into out
  const auto store = [&](void* out, const float (&acc)[HD / 8][4], float scale) {
    float* base = static_cast<float*>(out) + b * p.o_sb + h * p.o_sn;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (int(j[r]) >= S) continue;
      float* row = base + (long long)j[r] * p.o_ss + 2 * t;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<float2*>(row + nd * 8) =
            make_float2(acc[nd][2 * r] * scale, acc[nd][2 * r + 1] * scale);
    }
  };

  sh.load_own(slice<float>(p.k, b, h, p.k_sb, p.k_sn), p.k_ss,
              slice<float>(p.v, b, h, p.v_sb, p.v_sn), p.v_ss, n0, S, vec);
  if constexpr (HD == 128) {
    pass(std::integral_constant<int, F_DV>{});
    store(p.dv, dv, 1.f);
    pass(std::integral_constant<int, F_DK>{});
    store(p.dk, dk, p.scale);
  } else {
    pass(std::integral_constant<int, F_DV | F_DK>{});
    store(p.dv, dv, 1.f);
    store(p.dk, dk, p.scale);
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p, int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + F_ROWS - 1) / F_ROWS, p.N, B);
  kernel<<<grid, THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// the tensor maps of (own0, own1, loop0, loop1) with their tiles' rows, and
// a launch of one bf16 kernel over blocks of BOWN rows
template <int HD, typename Kernel>
cudaError_t launch_ws(Kernel kernel, int smem, int loop_rows, const void* const (&src)[4],
                      const long long (&strides)[4][3], const Params& p, int B,
                      cudaStream_t st) {
  TmaMaps maps;
  CUtensorMap* map[4] = {&maps.own0, &maps.own1, &maps.loop0, &maps.loop1};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = make_tile_map(map[i], src[i], B, p.S, p.N, HD, i < 2 ? WG_ROWS : loop_rows,
                                          strides[i][0], strides[i][1], strides[i][2]);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BOWN - 1) / BOWN, p.N, B);
  kernel<<<grid, WS_THREADS, smem, st>>>(p, maps);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 1) {
    const void* const src[4] = {p.q, p.g, p.k, p.v};
    const long long strides[4][3] = {{p.q_sb, p.q_ss, p.q_sn}, {p.g_sb, p.g_ss, p.g_sn},
                                     {p.k_sb, p.k_ss, p.k_sn}, {p.v_sb, p.v_ss, p.v_sn}};
    return launch_ws<HD>(p.threshold ? flash_dq_bf16<HD, true> : flash_dq_bf16<HD, false>,
                         DqRing<HD>::BYTES, DQ_LOOP, src, strides, p, B, st);
  }
  return launch(p.threshold ? flash_dq_f32<HD, true> : flash_dq_f32<HD, false>,
                F32Tiles<HD, F_LOOP, 1>::BYTES, p, B, st);
}

template <int HD>
cudaError_t launch_dkv(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 1) {
    const void* const src[4] = {p.k, p.v, p.q, p.g};
    const long long strides[4][3] = {{p.k_sb, p.k_ss, p.k_sn}, {p.v_sb, p.v_ss, p.v_sn},
                                     {p.q_sb, p.q_ss, p.q_sn}, {p.g_sb, p.g_ss, p.g_sn}};
    return launch_ws<HD>(p.threshold ? flash_dkv_bf16<HD, true> : flash_dkv_bf16<HD, false>,
                         DkvRing<HD>::BYTES, DKV_LOOP<HD>, src, strides, p, B, st);
  }
  return launch(p.threshold ? flash_dkv_f32<HD, true> : flash_dkv_f32<HD, false>,
                F32Tiles<HD, F_LOOP, 4>::BYTES, p, B, st);
}

template <int HD>
cudaError_t launch_delta_hd(int dtype, const DeltaParams& p, int B, cudaStream_t st) {
  if (dtype == 1) return launch_delta<bf16, HD>(p, B, st);
  return launch_delta<float, HD>(p, B, st);
}

bool bad_args(int dtype, int B, int S, int N, unsigned int threshold) {
  return B <= 0 || S <= 0 || N <= 0 || (dtype != 0 && dtype != 1) || threshold > 255;
}

}  // namespace

// The argument list of ia_flash_dq and ia_flash_dkv up to the outputs.
// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64 or 128.  q, k, v, g
// (the gradient of out) and the outputs are [B, S, N, H] with strides in
// elements and a contiguous head dimension (bfloat16: 16-byte aligned, other
// strides multiples of 8, and positive where the size is above 1, as TMA
// wants them); the outputs share one layout (o_*).  `bias`
// may be null; `lse` (float64, from the forward) and `delta` (float32, from
// ia_flash_delta) are contiguous [B, N, S].  threshold and keep_p as for
// ia_flash_fwd, and so are bn_stride and bn_base.  Any S >= 1.  Each
// returns the cudaError_t of its launch.
#define IA_FLASH_BWD_INPUTS                                                                     \
  int dtype, int head_dim, const void *q, const void *k, const void *v,                         \
      const void *g, const void *bias, const void *lse, const void *delta
#define IA_FLASH_BWD_TAIL                                                                       \
  int B, int S, int N, long long q_sb, long long q_ss, long long q_sn, long long k_sb,          \
      long long k_ss, long long k_sn, long long v_sb, long long v_ss, long long v_sn,           \
      long long g_sb, long long g_ss, long long g_sn, long long o_sb, long long o_ss,           \
      long long o_sn, long long bias_sb, float scale, unsigned int seed,                        \
      unsigned int threshold, float keep_p, unsigned int bn_stride, unsigned int bn_base,       \
      void *stream
#define IA_FLASH_BWD_PARAMS(DQ, DK, DV)                                                         \
  Params{q,    k,    v,    g,    static_cast<const float*>(bias), static_cast<const double*>(lse), \
         static_cast<const float*>(delta), DQ, DK, DV, S, N,                                    \
         q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn, g_sb, g_ss, g_sn,                \
         o_sb, o_ss, o_sn, bias_sb, scale, seed, threshold, keep_p, bn_stride, bn_base}

extern "C" {

int ia_flash_dq(IA_FLASH_BWD_INPUTS, void* dq, IA_FLASH_BWD_TAIL) {
  if (bad_args(dtype, B, S, N, threshold)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = IA_FLASH_BWD_PARAMS(dq, nullptr, nullptr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_dq<32>(dtype, p, B, st);
  if (head_dim == 64) return launch_dq<64>(dtype, p, B, st);
  if (head_dim == 128) return launch_dq<128>(dtype, p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int ia_flash_dkv(IA_FLASH_BWD_INPUTS, void* dk, void* dv, IA_FLASH_BWD_TAIL) {
  if (bad_args(dtype, B, S, N, threshold)) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = IA_FLASH_BWD_PARAMS(nullptr, dk, dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_dkv<32>(dtype, p, B, st);
  if (head_dim == 64) return launch_dkv<64>(dtype, p, B, st);
  if (head_dim == 128) return launch_dkv<128>(dtype, p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta[b, n, i] = sum over h of g * out (float32, contiguous [B, N, S]), the
// row term both kernels read; g and out are [B, S, N, H] as above.
int ia_flash_delta(int dtype, int head_dim, const void* g, const void* out, void* delta, int B,
                   int S, int N, long long g_sb, long long g_ss, long long g_sn,
                   long long out_sb, long long out_ss, long long out_sn, void* stream) {
  if (bad_args(dtype, B, S, N, 0)) return static_cast<int>(cudaErrorInvalidValue);
  const DeltaParams p{g, out, static_cast<float*>(delta), S, N, g_sb, g_ss, g_sn,
                      out_sb, out_ss, out_sn};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_delta_hd<32>(dtype, p, B, st);
  if (head_dim == 64) return launch_delta_hd<64>(dtype, p, B, st);
  if (head_dim == 128) return launch_delta_hd<128>(dtype, p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bytes of dynamic shared memory a block takes at this head dim: the bf16
// dQ (kernel 0) or dK/dV (1) kernel, the fp32 dQ (2) or dK/dV (3) kernel;
// -1 for another kernel or head dim
int ia_flash_bwd_smem_bytes(int kernel, int head_dim) {
  const int bytes[4][3] = {
      {DqRing<32>::BYTES, DqRing<64>::BYTES, DqRing<128>::BYTES},
      {DkvRing<32>::BYTES, DkvRing<64>::BYTES, DkvRing<128>::BYTES},
      {F32Tiles<32, F_LOOP, 1>::BYTES, F32Tiles<64, F_LOOP, 1>::BYTES,
       F32Tiles<128, F_LOOP, 1>::BYTES},
      {F32Tiles<32, F_LOOP, 4>::BYTES, F32Tiles<64, F_LOOP, 4>::BYTES,
       F32Tiles<128, F_LOOP, 4>::BYTES}};
  const int i = head_dim == 32 ? 0 : head_dim == 64 ? 1 : head_dim == 128 ? 2 : -1;
  if (i < 0 || kernel < 0 || kernel > 3) return -1;
  return bytes[kernel][i];
}

const char* ia_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
