// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attn_kernel` in
// item_alignment_tpu/ops/pallas_attention.py (launched by
// `_fused_attention_impl`, public function `fused_attention`):
//
//   out = softmax(Q K^T / sqrt(H) + key_bias) V
//
// with fp32 scores and softmax statistics, the unnormalised probabilities
// rounded to V's dtype before the P.V product, and a final divide by
// max(rowsum, 1e-37).  Q, K, V and the output use the JAX layout
// [B, S, N, H] and are addressed through strides, so no transpose is needed.
//
// Design.  The TPU kernel holds a whole [S, S] fp32 score tile per head in
// VMEM.  At S = 512 that tile is 1 MiB, far beyond the 227 KB of shared
// memory an H100 block can use, so this kernel is blocked instead: one block
// of 4 warps per (64-query tile, head, batch row), each warp owning 16 query
// rows, and a loop over 64-key tiles with an online softmax whose running
// max is the exact row max seen so far (never an upper bound: see the note
// on large-norm rows in pallas_attention.py).  The running max starts at the
// finite -1e30, not -inf, so a row whose keys all carry the -1e9 mask bias
// gives the uniform mean of V as the TPU path does instead of NaN.  Keys
// past S are left out of the max and the sum entirely (p = 0), not treated
// as masked keys.
//
// bf16 (the serving dtype) runs on the tensor cores with mma.sync
// m16n8k16 (fp32 accumulate).  Q, the score tile, P and the output
// accumulator stay in registers: the score accumulator fragment is exactly
// the A fragment of the P.V product, V's B fragments come from ldmatrix.trans
// and K's from 32-bit shared loads.  K/V tiles arrive through a two-stage
// cp.async pipeline of 16-byte copies, the key bias through a register
// prefetch into shared memory, and the exponentials are exp2f of scores
// scaled by log2(e).  fp32 keeps full fp32 products with
// scalar FMAs from shared memory (a correctness path; serving uses bf16).
//
// Bound on this card (H100 SXM datasheet: 989 TFLOP/s dense bf16, 67 TFLOP/s
// fp32 without tensor cores, 3.35 TB/s HBM).  Work is 4*B*N*S^2*H FLOP and
// about 4*B*S*N*H*itemsize bytes (Q, K, V read once, O written once).  At
// B=64, S=510, N=16, H=64 in bf16: 68.2 GFLOP -> 0.069 ms and 267 MB ->
// 0.080 ms, so the call is bound by bytes at about 0.08 ms.  This version
// re-reads K and V once per 64-query tile (from L2 for the most part) and
// uses mma.sync rather than wgmma/TMA, so it sits above that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BLOCK_M = 64;  // query rows per block
constexpr int BLOCK_N = 64;  // keys per KV tile
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = BLOCK_M / WARPS;  // 16
constexpr int THREADS = WARPS * 32;
constexpr float INIT_MAX = -1e30f;
constexpr float MIN_DENOM = 1e-37f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, S] key bias rows (stride bias_sb), or nullptr
  void* o;
  int S;
  long long q_sb, q_ss, q_sn;
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn;
  long long bias_sb;
  float scale;
};

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

// ---------------------------------------------------------------------------
// bf16: tensor cores, registers
// ---------------------------------------------------------------------------

template <int HD>
struct Bf16Layout {
  static constexpr int LD = HD + 8;  // row pitch in bf16: 16-byte rows, no bank conflicts
  static constexpr int TILE = BLOCK_N * LD;
  static constexpr int BIAS_OFF = 5 * TILE * 2;  // after Q and two stages of K and V
  static constexpr int BYTES = BIAS_OFF + 2 * BLOCK_N * 4;  // + two stages of key bias
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with `valid` false the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + 64) of one (batch, head) slice -> shared, zero past S
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long s_stride,
                                                int row0, int S) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BLOCK_N * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i - r * CHUNKS) * 8;
    const int row = row0 + r;
    const bool valid = row < S;
    cp_async16(dst + r * Bf16Layout<HD>::LD + c, valid ? src + (long long)row * s_stride + c : src,
               valid);
  }
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragment (16 keys x 8 dims) of a row-major [key][dim] V tile
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t b[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr(p)));
}

// Fragment ownership (m16n8k16): lane = 4*g + t.  An accumulator holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in c[2..3].
template <int HD>
__global__ void __launch_bounds__(THREADS) attn_fwd_bf16(Params p) {
  using L = Bf16Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + L::TILE;      // stages at Ks, Ks + TILE
  bf16* Vs = Ks + 2 * L::TILE;  // stages at Vs, Vs + TILE
  float* Bs = reinterpret_cast<float*>(smem + L::BIAS_OFF);  // stages at Bs, Bs + BLOCK_N

  const int S = p.S;
  const int m0 = blockIdx.x * BLOCK_M;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * ROWS_PER_WARP;
  const int g = lane >> 2;
  const int t = lane & 3;
  // scores go to the log2 domain so that exp2f does the exponentials
  const float scale_log2 = p.scale * LOG2E;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sn;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sn;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sn;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_tile_async<HD>(Qs, q, p.q_ss, m0, S);
  load_tile_async<HD>(Ks, k, p.k_ss, 0, S);
  load_tile_async<HD>(Vs, v, p.v_ss, 0, S);
  cp_async_commit();
  // key bias rows are not 16-byte aligned (S = 510), so they go through
  // registers: 64 threads load one key each
  if (tid < BLOCK_N) Bs[tid] = (bias && tid < S) ? bias[tid] : 0.f;

  uint32_t qf[HD / 16][4];
  float o_acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_row[2] = {INIT_MAX, INIT_MAX};
  float l_row[2] = {0.f, 0.f};

  const int n_tiles = (S + BLOCK_N - 1) / BLOCK_N;
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * BLOCK_N;
    const bf16* Kt = Ks + (it & 1) * L::TILE;
    const bf16* Vt = Vs + (it & 1) * L::TILE;
    const float* Bt = Bs + (it & 1) * BLOCK_N;
    const bool full = kv0 + BLOCK_N <= S;  // only the last tile has a ragged tail
    float bias_next = 0.f;  // stored to shared at the end of this tile
    if (bias && tid < BLOCK_N && kv0 + BLOCK_N + tid < S) bias_next = bias[kv0 + BLOCK_N + tid];
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile_async<HD>(Ks + ((it + 1) & 1) * L::TILE, k, p.k_ss, kv0 + BLOCK_N, S);
      load_tile_async<HD>(Vs + ((it + 1) & 1) * L::TILE, v, p.v_ss, kv0 + BLOCK_N, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const bf16* base = Qs + (r0 + g) * L::LD + kk * 16 + 2 * t;
        qf[kk][0] = ld_u32(base);
        qf[kk][1] = ld_u32(base + 8 * L::LD);
        qf[kk][2] = ld_u32(base + 8);
        qf[kk][3] = ld_u32(base + 8 * L::LD + 8);
      }
    }

    // scores for this warp's 16 rows x 64 keys, as 8 accumulators of 16x8
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const bf16* kp = Kt + (j * 8 + g) * L::LD + kk * 16 + 2 * t;
        const uint32_t kb[2] = {ld_u32(kp), ld_u32(kp + 8)};
        mma_bf16(s[j], qf[kk], kb);
      }
    }

    // scale + bias (log2 domain); keys past S become -inf, so they drop
    // out of the max and give p = exp2(-inf) = 0; exact running row max
    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(Bt + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        const float x = (full || col < S)
                            ? fmaf(s[j][e], scale_log2, ((e & 1) ? bb.y : bb.x) * LOG2E)
                            : -INFINITY;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
        s[j][e] = x;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = tile_max[r];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[r], mx);
      alpha[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[j][e] - m_row[e >> 1]);
        psum[e >> 1] += pv;
        s[j][e] = pv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = psum[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_row[r] = l_row[r] * alpha[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // O += P V, with P rounded to bf16: two score accumulators (16 keys)
    // form one A fragment
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, Vt + (kk * 16 + (lane & 15)) * L::LD + j * 8);
        mma_bf16(o_acc[j], pf, vb);
      }
    }
    if (tid < BLOCK_N) Bs[((it + 1) & 1) * BLOCK_N + tid] = bias_next;
    __syncthreads();  // this stage is free for the prefetch two tiles on
  }

  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sn;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l_row[r], MIN_DENOM);
    bf16* orow = o + (long long)row * p.o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o_acc[j][2 * r] / denom, o_acc[j][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs, shared memory
// ---------------------------------------------------------------------------

template <int HD>
struct F32Layout {
  static constexpr int LDT = HD + 1;       // Q/K/V rows: odd pitch, no bank conflicts
  static constexpr int LDP = BLOCK_N + 1;  // P rows
  static constexpr int LDO = HD;           // O accumulator rows
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BLOCK_M * LDT;
  static constexpr int V_OFF = K_OFF + BLOCK_N * LDT;
  static constexpr int P_OFF = V_OFF + BLOCK_N * LDT;
  static constexpr int O_OFF = P_OFF + BLOCK_M * LDP;
  static constexpr int STAT_OFF = O_OFF + BLOCK_M * LDO;
  static constexpr int BYTES = (STAT_OFF + 3 * BLOCK_M) * 4;  // + m, l, alpha
};

template <int HD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long s_stride,
                                              int row0, int S) {
  for (int i = threadIdx.x; i < BLOCK_N * HD; i += THREADS) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int row = row0 + r;
    dst[r * F32Layout<HD>::LDT + d] = row < S ? src[(long long)row * s_stride + d] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS) attn_fwd_f32(Params p) {
  using L = F32Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  float* Qs = sm + L::Q_OFF;
  float* Ks = sm + L::K_OFF;
  float* Vs = sm + L::V_OFF;
  float* Ps = sm + L::P_OFF;
  float* Os = sm + L::O_OFF;
  float* m_s = sm + L::STAT_OFF;
  float* l_s = m_s + BLOCK_M;
  float* a_s = l_s + BLOCK_M;

  const int S = p.S;
  const int m0 = blockIdx.x * BLOCK_M;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * ROWS_PER_WARP;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sn;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sn;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sn;
  const float* bias = p.bias ? p.bias + b * p.bias_sb : nullptr;

  load_tile_f32<HD>(Qs, q, p.q_ss, m0, S);
  for (int i = threadIdx.x; i < BLOCK_M * L::LDO; i += THREADS) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BLOCK_M; i += THREADS) {
    m_s[i] = INIT_MAX;
    l_s[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += BLOCK_N) {
    __syncthreads();  // Q/O initialised, or the previous K/V tile consumed
    load_tile_f32<HD>(Ks, k, p.k_ss, kv0, S);
    load_tile_f32<HD>(Vs, v, p.v_ss, kv0, S);
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
          x = s[half] * p.scale;
          if (bias) x += bias[j];
          tile_max = fmaxf(tile_max, x);
        }
        s[half] = x;
      }
      tile_max = warp_max(tile_max);
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, tile_max);
      const float alpha = expf(m_old - m_new);
      float psum = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const float pv = (kv0 + c < S) ? expf(s[half] - m_new) : 0.f;
        psum += pv;
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
      float* orow = Os + (r0 + r) * L::LDO;
      for (int d = lane; d < HD; d += 32) {
        float acc = orow[d] * alpha;
#pragma unroll 8
        for (int j = 0; j < BLOCK_N; ++j) acc = fmaf(prow[j], Vs[j * L::LDT + d], acc);
        orow[d] = acc;
      }
    }
  }
  __syncwarp();

  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sn;
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int row = m0 + r0 + r;
    if (row >= S) break;
    const float denom = fmaxf(l_s[r0 + r], MIN_DENOM);
    for (int d = lane; d < HD; d += 32) o[(long long)row * p.o_ss + d] = Os[(r0 + r) * L::LDO + d] / denom;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p, int B, int N, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + BLOCK_M - 1) / BLOCK_M, N, B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Params& p, int B, int N, cudaStream_t st) {
  return launch(attn_fwd_bf16<HD>, Bf16Layout<HD>::BYTES, p, B, N, st);
}

template <int HD>
cudaError_t launch_f32(const Params& p, int B, int N, cudaStream_t st) {
  return launch(attn_fwd_f32<HD>, F32Layout<HD>::BYTES, p, B, N, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  head_dim: 32, 64 or 128.  Strides are
// in elements; the head dimension must be contiguous, and for bfloat16 the
// pointers must be 16-byte aligned and the other strides multiples of 8.
// `bias` may be null.  Returns the cudaError_t of the launch (0 on success).
int ia_fused_attention_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                           const void* bias, void* o, int B, int S, int N, long long q_sb,
                           long long q_ss, long long q_sn, long long k_sb, long long k_ss,
                           long long k_sn, long long v_sb, long long v_ss, long long v_sn,
                           long long o_sb, long long o_ss, long long o_sn, long long bias_sb,
                           float scale, void* stream) {
  const Params p{q,    k,    v,    static_cast<const float*>(bias),
                 o,    S,    q_sb, q_ss,
                 q_sn, k_sb, k_ss, k_sn,
                 v_sb, v_ss, v_sn, o_sb,
                 o_ss, o_sn, bias_sb, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (head_dim == 32) return launch_bf16<32>(p, B, N, st);
    if (head_dim == 64) return launch_bf16<64>(p, B, N, st);
    if (head_dim == 128) return launch_bf16<128>(p, B, N, st);
  } else if (dtype == 0) {
    if (head_dim == 32) return launch_f32<32>(p, B, N, st);
    if (head_dim == 64) return launch_f32<64>(p, B, N, st);
    if (head_dim == 128) return launch_f32<128>(p, B, N, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ia_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
