// Fused attention forward with in-kernel dropout and row statistics, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_dropout_kernel` in
// item_alignment_tpu/ops/pallas_attention.py (launched by
// `_fused_attention_dropout_impl`, public functions `fused_attention_dropout`
// and, at rate 0, the forward of `fused_attention`'s VJP):
//
//   p   = exp(Q K^T / sqrt(H) + key_bias - m)       (m = exact row max)
//   l   = rowsum(p)                                  (undropped mass)
//   out = (keep * p) V / (max(l, 1e-37) * keep_p)    (inverted dropout)
//   lse = m + log(max(l, 1e-37))                     ([B, N, S], float64)
//
// keep is the hashed keep bit of attention_common.cuh (keep iff its byte >=
// round(rate * 256)), keep_p = 1 - round(rate * 256) / 256, and at rate 0
// every key is kept.  Q, K, V and out use the JAX layout [B, S, N, H],
// addressed through strides.
//
// lse is stored in float64.  A fully masked row has scores of exactly -1e9
// (the mask bias swallows q.k in fp32), so its fp32 lse, -1e9 + log(S),
// rounds back to -1e9 and the backward's exp(s - lse) would give 1 instead
// of the uniform 1/S.  In float64 it keeps log(S), and the backward keeps
// that precision in s - lse before the exponential.  The statistics are in natural
// units (exp2f of (x - m) * log2(e)) for the same reason: the backward
// recomputes x = fmaf(q.k, scale, bias) bit for bit.
//
// Design.  As in fused_attention.cu: the TPU kernel's whole [S, S] fp32
// tile (1 MiB at S = 512) cannot sit in shared memory, so one block of 4
// warps takes 64 queries of one (batch row, head), each warp 16 rows, and
// loops over 64-key tiles with an online softmax from the finite -1e30
// start.  Keys past S are left out of the max and the sum.  bf16 runs on
// the tensor cores (mma.sync m16n8k16, fp32 accumulate; the K fragments of
// two products per ldmatrix.x4) with Q, the score tile, P and the output in
// registers and a two-stage cp.async pipeline for K and V; each thread
// hashes one 32-bit word per two of its scores.  fp32 is a scalar-FMA
// correctness path.
//
// Bound on this card (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s).  Work
// is 4*B*N*S^2*H FLOP (as the TPU kernel's CostEstimate counts it) and
// 4*B*S*N*H*2 bytes plus the statistics.  At the train shape B=40, S=510,
// N=16, H=64 in bf16: 42.6 GFLOP -> 0.043 ms and 167 MB -> 0.050 ms, so the
// call is bound by bytes.  This version re-reads K and V once per 64-query
// tile (mostly from L2), hashes the mask on the integer pipes, and uses
// mma.sync rather than wgmma/TMA, so it sits above that bound.

#include <cmath>

#include "attention_common.cuh"

namespace {

using namespace ia;

constexpr int BLOCK = 64;  // queries per block, keys per tile
constexpr int ROWS_PER_WARP = 16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, S] key bias rows (stride bias_sb), or nullptr
  void* o;
  double* lse;  // [B, N, S]
  int S, N;
  long long q_sb, q_ss, q_sn;
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn;
  long long bias_sb;
  float scale;
  uint32_t seed, threshold;
  float keep_p;
};

template <int HD>
struct Bf16Layout {
  static constexpr int LD = HD + 8;  // 16-byte rows, no bank conflicts
  static constexpr int TILE = BLOCK * LD;
  static constexpr int BIAS_OFF = 5 * TILE * 2;  // Q, two stages of K and V
  static constexpr int BYTES = BIAS_OFF + 2 * BLOCK * 4;
};

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_dropout_fwd_bf16(Params p) {
  using L = Bf16Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::TILE;
  bf16* Vs = Ks + 2 * L::TILE;
  float* Bs = reinterpret_cast<float*>(smem + L::BIAS_OFF);

  const int S = p.S;
  const int m0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * ROWS_PER_WARP;
  const int g = lane >> 2;
  const int t = lane & 3;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sn;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sn;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sn;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_tile_bf16<BLOCK, HD, L::LD>(Qs, q, p.q_ss, m0, S);
  load_tile_bf16<BLOCK, HD, L::LD>(Ks, k, p.k_ss, 0, S);
  load_tile_bf16<BLOCK, HD, L::LD>(Vs, v, p.v_ss, 0, S);
  cp_async_commit();
  if (tid < BLOCK) Bs[tid] = (bias && tid < S) ? bias[tid] : 0.f;

  // keys of this thread's two rows for the dropout hash
  uint32_t rk[2] = {0u, 0u};
  if (p.threshold) {
    const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));
    rk[0] = row_key(hk, uint32_t(m0 + r0 + g));
    rk[1] = row_key(hk, uint32_t(m0 + r0 + g + 8));
  }

  uint32_t qf[HD / 16][4];
  float o_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_row[2] = {INIT_MAX, INIT_MAX};
  float l_row[2] = {0.f, 0.f};

  const int n_tiles = (S + BLOCK - 1) / BLOCK;
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * BLOCK;
    const bf16* Kt = Ks + (it & 1) * L::TILE;
    const bf16* Vt = Vs + (it & 1) * L::TILE;
    const float* Bt = Bs + (it & 1) * BLOCK;
    const bool full = kv0 + BLOCK <= S;
    float bias_next = 0.f;
    if (bias && tid < BLOCK && kv0 + BLOCK + tid < S) bias_next = bias[kv0 + BLOCK + tid];
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile_bf16<BLOCK, HD, L::LD>(Ks + ((it + 1) & 1) * L::TILE, k, p.k_ss, kv0 + BLOCK, S);
      load_tile_bf16<BLOCK, HD, L::LD>(Vs + ((it + 1) & 1) * L::TILE, v, p.v_ss, kv0 + BLOCK, S);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) load_a_frag_x4(qf[kk], Qs + r0 * L::LD + kk * 16, L::LD, lane);
    }

    float s[BLOCK / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK / 8; j += 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb0[2], kb1[2];  // keys j*8.. and (j+1)*8..
        load_b_frag_nk_x2(kb0, kb1, Kt + j * 8 * L::LD + kk * 16, L::LD, lane);
        mma_bf16(s[j], qf[kk], kb0);
        mma_bf16(s[j + 1], qf[kk], kb1);
      }
    }

    // x = q.k * scale + bias in natural units; keys past S become -inf
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(Bt + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const float x = (full || col < S) ? fmaf(s[j][e], p.scale, (e & 1) ? bb.y : bb.x) : -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
        s[j][e] = x;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_row[r], quad_max(tile_max[r]));
      alpha[r] = exp2f((m_row[r] - m_new) * LOG2E);
      m_row[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BLOCK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f((s[j][e] - m_row[e >> 1]) * LOG2E);
        psum[e >> 1] += pv;  // l sums the undropped mass
        s[j][e] = pv;
      }
    }
    if (p.threshold) {
      // cols 2t, 2t+1 of each 8-key group share one 4-byte word
#pragma unroll
      for (int j = 0; j < BLOCK / 8; ++j) {
        const uint32_t col = kv0 + j * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t word = key_word(rk[r], col);
          if (!keep_bit(word, col, p.threshold)) s[j][2 * r] = 0.f;
          if (!keep_bit(word, col + 1, p.threshold)) s[j][2 * r + 1] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_row[r] = l_row[r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // O += (keep * P) V with P rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t pf[4];
      acc_to_a(pf, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        uint32_t vb[2];
        load_b_frag_kn(vb, Vt + kk * 16 * L::LD + j * 8, L::LD, lane);
        mma_bf16(o_acc[j], pf, vb);
      }
    }
    if (tid < BLOCK) Bs[((it + 1) & 1) * BLOCK + tid] = bias_next;
    __syncthreads();
  }

  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sn;
  double* lse = p.lse + ((long long)b * p.N + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l_row[r], MIN_DENOM);
    if (t == 0) lse[row] = double(m_row[r]) + log(double(denom));
    const float div = denom * p.keep_p;
    bf16* orow = o + (long long)row * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o_acc[j][2 * r] / div, o_acc[j][2 * r + 1] / div);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs, shared memory (a correctness path)
// ---------------------------------------------------------------------------

template <int HD>
struct F32Layout {
  static constexpr int LDT = HD + 1;     // Q/K/V rows: odd pitch
  static constexpr int LDP = BLOCK + 1;  // P rows
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BLOCK * LDT;
  static constexpr int V_OFF = K_OFF + BLOCK * LDT;
  static constexpr int P_OFF = V_OFF + BLOCK * LDT;
  static constexpr int O_OFF = P_OFF + BLOCK * LDP;
  static constexpr int STAT_OFF = O_OFF + BLOCK * HD;
  static constexpr int BYTES = (STAT_OFF + 3 * BLOCK) * 4;  // + m, l, alpha
};

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_dropout_fwd_f32(Params p) {
  using L = F32Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* Qs = sm + L::Q_OFF;
  float* Ks = sm + L::K_OFF;
  float* Vs = sm + L::V_OFF;
  float* Ps = sm + L::P_OFF;
  float* Os = sm + L::O_OFF;
  float* m_s = sm + L::STAT_OFF;
  float* l_s = m_s + BLOCK;
  float* a_s = l_s + BLOCK;

  const int S = p.S;
  const int m0 = blockIdx.x * BLOCK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * ROWS_PER_WARP;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sn;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sn;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sn;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;
  const uint32_t hk = head_key(p.seed, uint32_t(b) * uint32_t(p.N) + uint32_t(h));

  load_tile_f32<BLOCK, HD, L::LDT>(Qs, q, p.q_ss, m0, S);
  for (int i = threadIdx.x; i < BLOCK * HD; i += THREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
    m_s[i] = INIT_MAX;
    l_s[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += BLOCK) {
    __syncthreads();
    load_tile_f32<BLOCK, HD, L::LDT>(Ks, k, p.k_ss, kv0, S);
    load_tile_f32<BLOCK, HD, L::LDT>(Vs, v, p.v_ss, kv0, S);
    __syncthreads();

    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const int row = r0 + r;
      // each lane owns keys `lane` and `lane + 32` of the tile
      float s[2] = {0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float qd = Qs[row * L::LDT + d];
        s[0] = fmaf(qd, Ks[lane * L::LDT + d], s[0]);
        s[1] = fmaf(qd, Ks[(lane + 32) * L::LDT + d], s[1]);
      }
      float tile_max = -INFINITY;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = kv0 + lane + 32 * half;
        float x = -INFINITY;
        if (j < S) {
          x = fmaf(s[half], p.scale, bias ? bias[j] : 0.f);
          tile_max = fmaxf(tile_max, x);
        }
        s[half] = x;
      }
      tile_max = warp_max(tile_max);
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, tile_max);
      const float alpha = exp2f((m_old - m_new) * LOG2E);
      const uint32_t rkey = row_key(hk, uint32_t(m0 + row));
      float psum = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const uint32_t j = kv0 + c;
        float pv = (int(j) < S) ? exp2f((s[half] - m_new) * LOG2E) : 0.f;
        psum += pv;
        if (p.threshold && !keep_bit(key_word(rkey, j), j, p.threshold)) pv = 0.f;
        Ps[row * L::LDP + c] = pv;
      }
      psum = warp_sum(psum);
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + psum;
        a_s[row] = alpha;
      }
    }
    __syncwarp();

    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const float alpha = a_s[r0 + r];
      const float* prow = Ps + (r0 + r) * L::LDP;
      float* orow = Os + (r0 + r) * HD;
      for (int d = lane; d < HD; d += 32) {
        float acc = orow[d] * alpha;
#pragma unroll 8
        for (int j = 0; j < BLOCK; ++j) acc = fmaf(prow[j], Vs[j * L::LDT + d], acc);
        orow[d] = acc;
      }
    }
  }
  __syncwarp();

  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sn;
  double* lse = p.lse + ((long long)b * p.N + h) * S;
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = m0 + r0 + r;
    if (row >= S) break;
    const float denom = fmaxf(l_s[r0 + r], MIN_DENOM);
    if (lane == 0) lse[row] = double(m_s[r0 + r]) + log(double(denom));
    const float div = denom * p.keep_p;
    for (int d = lane; d < HD; d += 32) o[(long long)row * p.o_ss + d] = Os[(r0 + r) * HD + d] / div;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BLOCK - 1) / BLOCK, p.N, B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 1) return launch(attn_dropout_fwd_bf16<HD>, Bf16Layout<HD>::BYTES, p, B, st);
  return launch(attn_dropout_fwd_f32<HD>, F32Layout<HD>::BYTES, p, B, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64 or 128.  Strides are
// in elements; the head dimension must be contiguous, and for bfloat16 the
// pointers must be 16-byte aligned and the other strides multiples of 8.
// `bias` may be null; `lse` is a contiguous float64 [B, N, S].  threshold =
// round(rate * 256) (0: no dropout), keep_p = 1 - threshold / 256.  Returns
// the cudaError_t of the launch (0 on success).
int ia_attention_dropout_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                             const void* bias, void* o, void* lse, int B, int S, int N,
                             long long q_sb, long long q_ss, long long q_sn, long long k_sb,
                             long long k_ss, long long k_sn, long long v_sb, long long v_ss,
                             long long v_sn, long long o_sb, long long o_ss, long long o_sn,
                             long long bias_sb, float scale, unsigned int seed,
                             unsigned int threshold, float keep_p, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0 || (dtype != 0 && dtype != 1) || threshold > 255)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,    k,    v,    static_cast<const float*>(bias),
                 o,    static_cast<double*>(lse),
                 S,    N,    q_sb, q_ss, q_sn, k_sb, k_ss, k_sn, v_sb, v_ss, v_sn,
                 o_sb, o_ss, o_sn, bias_sb, scale, seed, threshold, keep_p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return launch_hd<32>(dtype, p, B, st);
  if (head_dim == 64) return launch_hd<64>(dtype, p, B, st);
  if (head_dim == 128) return launch_hd<128>(dtype, p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ia_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
