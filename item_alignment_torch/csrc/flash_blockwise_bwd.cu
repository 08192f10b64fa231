// Blockwise attention backward for long sequences (S > 512): a dQ kernel and
// a dK/dV kernel with the forward's dropout mask regenerated, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// item_alignment_tpu/ops/pallas_attention.py (both launched by
// `_flash_blockwise_bwd_impl`, the backward of
// `fused_attention_blockwise_dropout`).  From the forward's float64 lse,
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
// x - lse keeps the float64 lse's precision (float-float in bf16, float64 in
// fp32), so a fully masked row gets the uniform 1/S back.  delta is computed
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
// interleaved.
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
// over 32-query tiles to stay in registers.  fp32 is a scalar-FMA
// correctness path on 32 x 32 tiles.

#include <cmath>

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
constexpr int FBLOCK = 32;  // fp32 tiles

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
    const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
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
    const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
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
// fp32: scalar FMAs on 32 x 32 tiles in shared memory (a correctness path)
// ---------------------------------------------------------------------------

template <int HD>
struct F32Layout {
  static constexpr int LDT = HD + 1;      // Q/K/V/G rows: odd pitch
  static constexpr int LDP = FBLOCK + 1;  // score tiles
  static constexpr int A_OFF = 0;         // the block's own rows (2 tiles)
  static constexpr int B_OFF = A_OFF + 2 * FBLOCK * LDT;  // the looped rows (2 tiles)
  static constexpr int P_OFF = B_OFF + 2 * FBLOCK * LDT;  // keep * p_r and ds
  static constexpr int ACC_OFF = P_OFF + 2 * FBLOCK * LDP;  // 2 accumulators
  static constexpr int F_STAT_OFF = ACC_OFF + 2 * FBLOCK * HD;  // dkp, bias, row key
  static constexpr int BYTES = (F_STAT_OFF + 3 * FBLOCK) * 4 + FBLOCK * 8;  // + double lse
};

// what both fp32 kernels carve out of shared memory
template <int HD>
struct F32Smem {
  using L = F32Layout<HD>;
  float *own0, *own1, *loop0, *loop1, *Ps, *Ds, *acc0, *acc1, *dkp_s, *kb_s;
  uint32_t* rk_s;
  double* lse_s;
  __device__ explicit F32Smem(unsigned char* smem) {
    float* sm = reinterpret_cast<float*>(smem);
    own0 = sm + L::A_OFF;
    own1 = own0 + FBLOCK * L::LDT;
    loop0 = sm + L::B_OFF;
    loop1 = loop0 + FBLOCK * L::LDT;
    Ps = sm + L::P_OFF;
    Ds = Ps + FBLOCK * L::LDP;
    acc0 = sm + L::ACC_OFF;
    acc1 = acc0 + FBLOCK * HD;
    dkp_s = sm + L::F_STAT_OFF;
    kb_s = dkp_s + FBLOCK;
    rk_s = reinterpret_cast<uint32_t*>(kb_s + FBLOCK);
    lse_s = reinterpret_cast<double*>(rk_s + FBLOCK);
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_dq_f32(Params p) {
  using L = F32Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem<HD> sh(smem);
  float *Qs = sh.own0, *Gs = sh.own1, *Ks = sh.loop0, *Vs = sh.loop1, *Ds = sh.Ds, *dQ = sh.acc0;

  const int S = p.S;
  const int m0 = blockIdx.x * FBLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const double* lse = p.lse + ((long long)b * p.N + h) * S;
  const float* delta = p.delta + ((long long)b * p.N + h) * S;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
  const double log_keep = log(double(p.keep_p));

  load_tile_f32<FBLOCK, HD, L::LDT>(Qs, slice<float>(p.q, b, h, p.q_sb, p.q_sn), p.q_ss, m0, S);
  load_tile_f32<FBLOCK, HD, L::LDT>(Gs, slice<float>(p.g, b, h, p.g_sb, p.g_sn), p.g_ss, m0, S);
  for (int c = tid; c < FBLOCK * HD; c += THREADS) dQ[c] = 0.f;
  if (tid < FBLOCK) {
    const int i = m0 + tid;
    const bool ok = i < S;
    sh.lse_s[tid] = ok ? lse[i] + log_keep : 0.0;
    sh.dkp_s[tid] = ok ? delta[i] * p.keep_p : 0.f;
    sh.rk_s[tid] = row_key(hk, uint32_t(i));
  }

  for (int k0 = 0; k0 < S; k0 += FBLOCK) {
    __syncthreads();
    load_tile_f32<FBLOCK, HD, L::LDT>(Ks, slice<float>(p.k, b, h, p.k_sb, p.k_sn), p.k_ss, k0, S);
    load_tile_f32<FBLOCK, HD, L::LDT>(Vs, slice<float>(p.v, b, h, p.v_sb, p.v_sn), p.v_ss, k0, S);
    if (tid < FBLOCK) sh.kb_s[tid] = (bias && k0 + tid < S) ? bias[k0 + tid] : 0.f;
    __syncthreads();
    for (int c = tid; c < FBLOCK * FBLOCK; c += THREADS) {
      const int il = c / FBLOCK;  // query
      const int jl = c - il * FBLOCK;  // key
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < HD; ++d) {
        s = fmaf(Qs[il * L::LDT + d], Ks[jl * L::LDT + d], s);
        dp = fmaf(Gs[il * L::LDT + d], Vs[jl * L::LDT + d], dp);
      }
      const uint32_t j = k0 + jl;
      float pr = 0.f;
      if (int(j) < S)
        pr = exp2f(float(double(fmaf(s, p.scale, sh.kb_s[jl])) - sh.lse_s[il]) * LOG2E);
      const bool kp = !p.threshold || keep_bit(key_word(sh.rk_s[il], j), j, p.threshold);
      Ds[il * L::LDP + jl] = pr * ((kp ? dp : 0.f) - sh.dkp_s[il]);
    }
    __syncthreads();
    for (int c = tid; c < FBLOCK * HD; c += THREADS) {
      const int il = c / HD;
      const int d = c - il * HD;
      float acc = dQ[c];
      for (int jl = 0; jl < FBLOCK; ++jl) acc = fmaf(Ds[il * L::LDP + jl], Ks[jl * L::LDT + d], acc);
      dQ[c] = acc;
    }
  }
  __syncthreads();
  float* dqp = static_cast<float*>(p.dq) + b * p.o_sb + h * p.o_sn;
  for (int c = tid; c < FBLOCK * HD; c += THREADS) {
    const int il = c / HD;
    const int d = c - il * HD;
    if (m0 + il < S) dqp[(long long)(m0 + il) * p.o_ss + d] = dQ[c] * p.scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_dkv_f32(Params p) {
  using L = F32Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem<HD> sh(smem);
  float *Ks = sh.own0, *Vs = sh.own1, *Qs = sh.loop0, *Gs = sh.loop1, *Ps = sh.Ps, *Ds = sh.Ds;
  float *dK = sh.acc0, *dV = sh.acc1;

  const int S = p.S;
  const int n0 = blockIdx.x * FBLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const double* lse = p.lse + ((long long)b * p.N + h) * S;
  const float* delta = p.delta + ((long long)b * p.N + h) * S;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
  const double log_keep = log(double(p.keep_p));

  load_tile_f32<FBLOCK, HD, L::LDT>(Ks, slice<float>(p.k, b, h, p.k_sb, p.k_sn), p.k_ss, n0, S);
  load_tile_f32<FBLOCK, HD, L::LDT>(Vs, slice<float>(p.v, b, h, p.v_sb, p.v_sn), p.v_ss, n0, S);
  for (int c = tid; c < 2 * FBLOCK * HD; c += THREADS) dK[c] = 0.f;  // dK and dV
  if (tid < FBLOCK) sh.kb_s[tid] = (bias && n0 + tid < S) ? bias[n0 + tid] : 0.f;

  for (int q0 = 0; q0 < S; q0 += FBLOCK) {
    __syncthreads();
    load_tile_f32<FBLOCK, HD, L::LDT>(Qs, slice<float>(p.q, b, h, p.q_sb, p.q_sn), p.q_ss, q0, S);
    load_tile_f32<FBLOCK, HD, L::LDT>(Gs, slice<float>(p.g, b, h, p.g_sb, p.g_sn), p.g_ss, q0, S);
    if (tid < FBLOCK) {
      const int i = q0 + tid;
      const bool ok = i < S;
      sh.lse_s[tid] = ok ? lse[i] + log_keep : 0.0;
      sh.dkp_s[tid] = ok ? delta[i] * p.keep_p : 0.f;
      sh.rk_s[tid] = row_key(hk, uint32_t(i));
    }
    __syncthreads();
    for (int c = tid; c < FBLOCK * FBLOCK; c += THREADS) {
      const int jl = c / FBLOCK;  // key
      const int il = c - jl * FBLOCK;  // query
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < HD; ++d) {
        s = fmaf(Ks[jl * L::LDT + d], Qs[il * L::LDT + d], s);
        dp = fmaf(Vs[jl * L::LDT + d], Gs[il * L::LDT + d], dp);
      }
      const uint32_t j = n0 + jl;
      float pr = 0.f;
      if (q0 + il < S)
        pr = exp2f(float(double(fmaf(s, p.scale, sh.kb_s[jl])) - sh.lse_s[il]) * LOG2E);
      const bool kp = !p.threshold || keep_bit(key_word(sh.rk_s[il], j), j, p.threshold);
      Ps[jl * L::LDP + il] = kp ? pr : 0.f;
      Ds[jl * L::LDP + il] = pr * ((kp ? dp : 0.f) - sh.dkp_s[il]);
    }
    __syncthreads();
    for (int c = tid; c < FBLOCK * HD; c += THREADS) {
      const int jl = c / HD;
      const int d = c - jl * HD;
      float av = dV[c], ak = dK[c];
      for (int il = 0; il < FBLOCK; ++il) {
        av = fmaf(Ps[jl * L::LDP + il], Gs[il * L::LDT + d], av);
        ak = fmaf(Ds[jl * L::LDP + il], Qs[il * L::LDT + d], ak);
      }
      dV[c] = av;
      dK[c] = ak;
    }
  }
  __syncthreads();
  float* dkp = static_cast<float*>(p.dk) + b * p.o_sb + h * p.o_sn;
  float* dvp = static_cast<float*>(p.dv) + b * p.o_sb + h * p.o_sn;
  for (int c = tid; c < FBLOCK * HD; c += THREADS) {
    const int jl = c / HD;
    const int d = c - jl * HD;
    if (n0 + jl >= S) continue;
    const long long off = (long long)(n0 + jl) * p.o_ss + d;
    dkp[off] = dK[c] * p.scale;
    dvp[off] = dV[c];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, int block, const Params& p, int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + block - 1) / block, p.N, B);
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
  return launch(flash_dq_f32<HD>, F32Layout<HD>::BYTES, FBLOCK, p, B, st);
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
  return launch(flash_dkv_f32<HD>, F32Layout<HD>::BYTES, FBLOCK, p, B, st);
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
// ia_flash_fwd.  Any S >= 1.  Each returns the cudaError_t of its launch.
#define IA_FLASH_BWD_INPUTS                                                                     \
  int dtype, int head_dim, const void *q, const void *k, const void *v,                         \
      const void *g, const void *bias, const void *lse, const void *delta
#define IA_FLASH_BWD_TAIL                                                                       \
  int B, int S, int N, long long q_sb, long long q_ss, long long q_sn, long long k_sb,          \
      long long k_ss, long long k_sn, long long v_sb, long long v_ss, long long v_sn,           \
      long long g_sb, long long g_ss, long long g_sn, long long o_sb, long long o_ss,           \
      long long o_sn, long long bias_sb, float scale, unsigned int seed,                        \
      unsigned int threshold, float keep_p, void *stream
#define IA_FLASH_BWD_PARAMS(DQ, DK, DV)                                                         \
  Params{q,    k,    v,    g,    static_cast<const float*>(bias), static_cast<const double*>(lse), \
         static_cast<const float*>(delta), DQ, DK, DV, S, N,                                    \
         q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn, g_sb, g_ss, g_sn,                \
         o_sb, o_ss, o_sn, bias_sb, scale, seed, threshold, keep_p}

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

// bytes of dynamic shared memory a block of the bf16 dQ (kernel 0) or dK/dV
// (kernel 1) kernel takes at this head dim; -1 for another kernel or head dim
int ia_flash_bwd_smem_bytes(int kernel, int head_dim) {
  const int dq[3] = {DqRing<32>::BYTES, DqRing<64>::BYTES, DqRing<128>::BYTES};
  const int dkv[3] = {DkvRing<32>::BYTES, DkvRing<64>::BYTES, DkvRing<128>::BYTES};
  const int i = head_dim == 32 ? 0 : head_dim == 64 ? 1 : head_dim == 128 ? 2 : -1;
  if (i < 0 || (kernel != 0 && kernel != 1)) return -1;
  return kernel == 0 ? dq[i] : dkv[i];
}

const char* ia_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
