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
// Design.  Three entry points, so each kernel is launched, counted and timed
// alone.  No atomics: a dQ block owns its query rows and a dK/dV block its
// key rows, as the TPU split does, so results repeat run to run.
//   - dQ: one block per (64-query tile, head, batch row), 4 warps of 16
//     queries each, looping over 64-key tiles.
//   - dK/dV: one block per (64-key tile, head, batch row), 4 warps of 16
//     keys each, looping over 64-query tiles.  Scores are computed
//     transposed (keys as rows), so keep * p_r and ds are the A operands of
//     dv and dk straight from the accumulators.  It holds two accumulators
//     (dk and dv) besides the two score tiles: registers are its scarce
//     resource.
// The looped tiles come through a two-stage cp.async pipeline; the products
// run on the tensor cores in bf16 (mma.sync m16n8k16, fp32 accumulate; A
// fragments and the B fragments of two products each come through one
// ldmatrix.x4).  fp32 is a scalar-FMA correctness path on 32 x 32 tiles.
// At S >= 1024 a 64-row tile re-reads the looped operands (K and V, or Q and
// g) of its head 16 times or more from L2, and a 128-row tile on 8 warps
// would halve that.  It was built and measured on an H100 at B=16, S=1024
// and lost for both kernels (dQ 1.62 against 1.10 ms, dK/dV 1.81 against
// 1.72 ms; PERF.md has the run): at 164-180 registers a thread an SM holds
// more warps in 4-warp blocks than in one 8-warp block.  So the owned tile
// is fixed at 64 rows.
//
// Bound on this card (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s), counting
// the products in each body (the TPU CostEstimate attaches 12*B*N*S^2*H to
// both calls): dQ has three (q k^T, g v^T, ds k), 6*B*N*S^2*H FLOP, and
// reads q, k, v, g and writes dq; dK/dV has four (k q^T, v g^T, p^T g,
// ds^T q), 8*B*N*S^2*H FLOP, and reads the same four and writes dk and dv.
// At B=16, S=1024, N=16, H=64 in bf16: dQ 103.1 GFLOP -> 0.104 ms against
// 172 MB -> 0.051 ms; dK/dV 137.4 GFLOP -> 0.139 ms against 206 MB -> 0.061
// ms.  Both are bound by operations.  mma.sync instead of wgmma, B fragments
// read from shared memory per warp and the mask hash keep these versions
// above it.

#include <cmath>

#include "attention_common.cuh"

namespace {

using namespace ia;

constexpr int BOWN = 64;   // rows a block owns (bf16): queries in dQ, keys in dK/dV
constexpr int BLOOP = 64;  // rows of a looped tile (bf16)
constexpr int ROWS_PER_WARP = 16;
constexpr int FBLOCK = 32;  // fp32 tiles

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

// the block's own pair of tiles (BOWN rows each), then two stages of the
// looped pair (BLOOP rows each), then two stages of per-row statistics (4
// floats or words a looped row)
template <int HD>
struct Bf16Layout {
  static constexpr int LD = HD + 8;
  static constexpr int OWN_TILE = BOWN * LD;
  static constexpr int LOOP_TILE = BLOOP * LD;
  static constexpr int STAT_OFF = (2 * OWN_TILE + 4 * LOOP_TILE) * 2;
  static constexpr int STAT = 4 * BLOOP;  // 4-byte words per stage
  static constexpr int BYTES = STAT_OFF + 2 * STAT * 4;
};

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_dq_bf16(Params p) {
  using L = Bf16Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + L::OWN_TILE;
  bf16* KVs = Gs + L::OWN_TILE;  // stage sg: K at 2 sg, V at 2 sg + 1
  float* bias_s = reinterpret_cast<float*>(smem + L::STAT_OFF);  // BLOOP per stage

  const int S = p.S;
  const int m0 = blockIdx.x * BOWN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w0 = (tid / 32) * ROWS_PER_WARP;
  const int g = lane >> 2;
  const int t = lane & 3;

  const bf16* q = slice<bf16>(p.q, b, h, p.q_sb, p.q_sn);
  const bf16* k = slice<bf16>(p.k, b, h, p.k_sb, p.k_sn);
  const bf16* v = slice<bf16>(p.v, b, h, p.v_sb, p.v_sn);
  const bf16* gr = slice<bf16>(p.g, b, h, p.g_sb, p.g_sn);
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const double* lse = p.lse + ((long long)b * p.N + h) * S;
  const float* delta = p.delta + ((long long)b * p.N + h) * S;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
  const double log_keep = log(double(p.keep_p));

  // stage `sg` <- key tile starting at k0 (tiles async, bias by hand)
  auto load_stage = [&](int sg, int k0) {
    load_tile_bf16<BLOOP, HD, L::LD>(KVs + 2 * sg * L::LOOP_TILE, k, p.k_ss, k0, S);
    load_tile_bf16<BLOOP, HD, L::LD>(KVs + (2 * sg + 1) * L::LOOP_TILE, v, p.v_ss, k0, S);
    cp_async_commit();
    if (tid < BLOOP) bias_s[sg * BLOOP + tid] = (bias && k0 + tid < S) ? bias[k0 + tid] : 0.f;
  };

  load_tile_bf16<BOWN, HD, L::LD>(Qs, q, p.q_ss, m0, S);
  load_tile_bf16<BOWN, HD, L::LD>(Gs, gr, p.g_ss, m0, S);
  load_stage(0, 0);
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
  for (int d = 0; d < HD / 8; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;

  const int n_tiles = (S + BLOOP - 1) / BLOOP;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BLOOP;
    if (it + 1 < n_tiles) {  // prefetch the next key tile
      load_stage((it + 1) & 1, k0 + BLOOP);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const bf16* Kt = KVs + 2 * (it & 1) * L::LOOP_TILE;
    const bf16* Vt = Kt + L::LOOP_TILE;
    const float* bt = bias_s + (it & 1) * BLOOP;

    // s = Q K^T and dp = G V^T for this warp's 16 queries x 64 keys
    float s[BLOOP / 8][4], dp[BLOOP / 8][4];
#pragma unroll
    for (int jk = 0; jk < BLOOP / 8; ++jk)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jk][e] = dp[jk][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ag[4];
      load_a_frag_x4(aq, Qs + w0 * L::LD + kk * 16, L::LD, lane);
      load_a_frag_x4(ag, Gs + w0 * L::LD + kk * 16, L::LD, lane);
#pragma unroll
      for (int jk = 0; jk < BLOOP / 8; jk += 2) {
        uint32_t bk0[2], bk1[2], bv0[2], bv1[2];  // keys jk*8.. and (jk+1)*8..
        load_b_frag_nk_x2(bk0, bk1, Kt + jk * 8 * L::LD + kk * 16, L::LD, lane);
        load_b_frag_nk_x2(bv0, bv1, Vt + jk * 8 * L::LD + kk * 16, L::LD, lane);
        mma_bf16(s[jk], aq, bk0);
        mma_bf16(s[jk + 1], aq, bk1);
        mma_bf16(dp[jk], ag, bv0);
        mma_bf16(dp[jk + 1], ag, bv1);
      }
    }

    // s <- ds; cols 2t, 2t+1 of each 8-key group share one hashed word
#pragma unroll
    for (int jk = 0; jk < BLOOP / 8; ++jk) {
      const int cj = jk * 8 + 2 * t;
      const uint32_t col = k0 + cj;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t word = p.threshold ? key_word(rk[r], col) : 0u;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          float pr = 0.f;
          if (int(col) + c < S) {
            const float x = fmaf(s[jk][e], p.scale, bt[cj + c]);
            pr = exp2f(((x - lse_hi[r]) - lse_lo[r]) * LOG2E);
          }
          const bool kp = !p.threshold || keep_bit(word, col + c, p.threshold);
          s[jk][e] = pr * ((kp ? dp[jk][e] : 0.f) - dkp[r]);
        }
      }
    }

    // dq += ds K over this tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < BLOOP / 16; ++kk) {
      uint32_t da[4];
      acc_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        uint32_t bk[2];
        load_b_frag_kn(bk, Kt + kk * 16 * L::LD + jd * 8, L::LD, lane);
        mma_bf16(dq[jd], da, bk);
      }
    }
    __syncthreads();  // this stage is free for the prefetch two tiles on
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
          dq[jd][2 * r] * p.scale, dq[jd][2 * r + 1] * p.scale);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) flash_dkv_bf16(Params p) {
  using L = Bf16Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::OWN_TILE;
  bf16* QGs = Vs + L::OWN_TILE;  // stage sg: Q at 2 sg, g at 2 sg + 1
  // per stage: lse hi, lse lo, delta * keep_p, row key
  float* st = reinterpret_cast<float*>(smem + L::STAT_OFF);

  const int S = p.S;
  const int n0 = blockIdx.x * BOWN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w0 = (tid / 32) * ROWS_PER_WARP;
  const int g = lane >> 2;
  const int t = lane & 3;

  const bf16* q = slice<bf16>(p.q, b, h, p.q_sb, p.q_sn);
  const bf16* k = slice<bf16>(p.k, b, h, p.k_sb, p.k_sn);
  const bf16* v = slice<bf16>(p.v, b, h, p.v_sb, p.v_sn);
  const bf16* gr = slice<bf16>(p.g, b, h, p.g_sb, p.g_sn);
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const double* lse = p.lse + ((long long)b * p.N + h) * S;
  const float* delta = p.delta + ((long long)b * p.N + h) * S;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
  const double log_keep = log(double(p.keep_p));

  // stage `sg` <- query tile starting at q0 (tiles async, stats by hand)
  auto load_stage = [&](int sg, int q0) {
    load_tile_bf16<BLOOP, HD, L::LD>(QGs + 2 * sg * L::LOOP_TILE, q, p.q_ss, q0, S);
    load_tile_bf16<BLOOP, HD, L::LD>(QGs + (2 * sg + 1) * L::LOOP_TILE, gr, p.g_ss, q0, S);
    cp_async_commit();
    if (tid < BLOOP) {
      float* s4 = st + sg * L::STAT;
      const int i = q0 + tid;
      const bool ok = i < S;
      split_lse(ok ? lse[i] + log_keep : 0.0, s4[tid], s4[BLOOP + tid]);
      s4[2 * BLOOP + tid] = ok ? delta[i] * p.keep_p : 0.f;
      reinterpret_cast<uint32_t*>(s4)[3 * BLOOP + tid] = row_key(hk, uint32_t(i));
    }
  };

  load_tile_bf16<BOWN, HD, L::LD>(Ks, k, p.k_ss, n0, S);
  load_tile_bf16<BOWN, HD, L::LD>(Vs, v, p.v_ss, n0, S);
  load_stage(0, 0);
  float kb[2];  // key bias of this thread's two key rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = n0 + w0 + g + 8 * r;
    kb[r] = (bias && j < S) ? bias[j] : 0.f;
  }

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  const int n_tiles = (S + BLOOP - 1) / BLOOP;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * BLOOP;
    if (it + 1 < n_tiles) {  // prefetch the next query tile
      load_stage((it + 1) & 1, q0 + BLOOP);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const bf16* Qt = QGs + 2 * (it & 1) * L::LOOP_TILE;
    const bf16* Gt = Qt + L::LOOP_TILE;
    const float* s4 = st + (it & 1) * L::STAT;
    const uint32_t* rk_s = reinterpret_cast<const uint32_t*>(s4) + 3 * BLOOP;

    // s = K Q^T and dp = V G^T for this warp's 16 keys x 64 queries
    float s[BLOOP / 8][4], dp[BLOOP / 8][4];
#pragma unroll
    for (int jq = 0; jq < BLOOP / 8; ++jq)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jq][e] = dp[jq][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      load_a_frag_x4(ak, Ks + w0 * L::LD + kk * 16, L::LD, lane);
      load_a_frag_x4(av, Vs + w0 * L::LD + kk * 16, L::LD, lane);
#pragma unroll
      for (int jq = 0; jq < BLOOP / 8; jq += 2) {
        uint32_t bq0[2], bq1[2], bg0[2], bg1[2];  // queries jq*8.. and (jq+1)*8..
        load_b_frag_nk_x2(bq0, bq1, Qt + jq * 8 * L::LD + kk * 16, L::LD, lane);
        load_b_frag_nk_x2(bg0, bg1, Gt + jq * 8 * L::LD + kk * 16, L::LD, lane);
        mma_bf16(s[jq], ak, bq0);
        mma_bf16(s[jq + 1], ak, bq1);
        mma_bf16(dp[jq], av, bg0);
        mma_bf16(dp[jq + 1], av, bg1);
      }
    }

    // s <- keep * p_r, dp <- ds
#pragma unroll
    for (int jq = 0; jq < BLOOP / 8; ++jq) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = jq * 8 + 2 * t + (e & 1);
        const uint32_t j = n0 + w0 + g + 8 * (e >> 1);
        float pr = 0.f;
        if (q0 + ci < S) {
          const float x = fmaf(s[jq][e], p.scale, kb[e >> 1]);
          pr = exp2f(((x - s4[ci]) - s4[BLOOP + ci]) * LOG2E);
        }
        const bool kp = !p.threshold || keep_bit(key_word(rk_s[ci], j), j, p.threshold);
        dp[jq][e] = pr * ((kp ? dp[jq][e] : 0.f) - s4[2 * BLOOP + ci]);
        s[jq][e] = kp ? pr : 0.f;
      }
    }

    // dv += (keep * p_r) G, dk += ds Q over this tile's 64 queries
#pragma unroll
    for (int kk = 0; kk < BLOOP / 16; ++kk) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
      acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int jd = 0; jd < HD / 8; ++jd) {
        uint32_t bg[2], bq[2];
        load_b_frag_kn(bg, Gt + kk * 16 * L::LD + jd * 8, L::LD, lane);
        load_b_frag_kn(bq, Qt + kk * 16 * L::LD + jd * 8, L::LD, lane);
        mma_bf16(dv[jd], pa, bg);
        mma_bf16(dk[jd], da, bq);
      }
    }
    __syncthreads();  // this stage is free for the prefetch two tiles on
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
      *reinterpret_cast<__nv_bfloat162*>(dkp + off + jd * 8) = __floats2bfloat162_rn(
          dk[jd][2 * r] * p.scale, dk[jd][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + off + jd * 8) =
          __floats2bfloat162_rn(dv[jd][2 * r], dv[jd][2 * r + 1]);
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

template <int HD>
cudaError_t launch_dq(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 1) return launch(flash_dq_bf16<HD>, Bf16Layout<HD>::BYTES, BOWN, p, B, st);
  return launch(flash_dq_f32<HD>, F32Layout<HD>::BYTES, FBLOCK, p, B, st);
}

template <int HD>
cudaError_t launch_dkv(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 1) return launch(flash_dkv_bf16<HD>, Bf16Layout<HD>::BYTES, BOWN, p, B, st);
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
// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64 or 128.  q, k, v, g (the gradient of out) and the outputs are [B, S, N, H] with strides
// in elements and a contiguous head dimension (bfloat16: 16-byte aligned,
// other strides multiples of 8); the outputs share one layout (o_*).  `bias`
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

const char* ia_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
