// LayerNorm forward and backward for Hopper (sm_90a), with the arithmetic
// of models/layers.py:LayerNorm (Flax's LayerNorm):
//
//   mean = E[x],  var = E[x^2] - mean^2   (fp32, var clamped at 0 after)
//   y    = (x - mean) * (rsqrt(max(var, 0) + eps) * w) (+ b)
//
// in the output type.  The kernels compute each product and difference of
// that formula rounded as the plain PyTorch version rounds it (no FMA
// contraction); only the order of the sums inside a row, and over rows for
// the parameter gradients, differs.
//
// Replaces no TPU kernel: the JAX package computes LayerNorm with
// flax.linen.LayerNorm and leaves it to XLA's fusion.  The port's plain
// chain ran about fourteen fp32 kernels a forward and twenty in autograd's
// backward, each over the whole [rows, H] tensor, and took 40-49% of the
// device's busy time in each of the benchmark's cells on an H100.
//
// Bound on this card (H100 SXM: 3.35 TB/s).  The forward reads x and writes
// y (4 bytes an element in bf16, 8 in fp32); the backward reads x and dy and
// writes dx (6 bytes an element in bf16).  At 40 x 510 rows of 1024 in bf16:
// 84 MB -> 25 us forward, 125 MB -> 37 us backward.  No arithmetic comes
// near the card's rates, so the design is about bytes:
//   - a row is held in registers by one warp (32 columns a lane, in 16-byte
//     loads where H and the pointers allow: 8 bf16 or 4 fp32), or by up to
//     eight warps of one block for H above 1024, whose sums meet in shared
//     memory.  x is read once; the row's sums are warp shuffles
//     (butterflies, so every lane holds the same bits);
//   - the forward writes y, and the row's mean and unclamped variance (fp32)
//     for the backward when it is asked to;
//   - the backward re-reads x and dy and computes, with g = dy * w and
//     xhat = (x - mean) * rstd,
//       dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
//     leaving out the last term on rows whose unclamped variance was below
//     0, as autograd does through the clamp;
//   - the parameter gradients: each block of the backward covers a fixed
//     range of rows and keeps sum(dy * xhat) and sum(dy) for its lanes'
//     columns in registers, its row groups added in group order through
//     shared memory, and writes them as one row of a [2, blocks, H] fp32
//     scratch; ia_ln_bwd_params then sums that scratch over the blocks in a
//     fixed order.  No atomics: the same inputs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kWarp = 32;
constexpr int kLaneCols = 32;  // columns a lane holds
constexpr int kWarpCols = kWarp * kLaneCols;
constexpr int kMaxRowWarps = 8;  // warps a row is split over, at most
constexpr int kMaxWidth = kMaxRowWarps * kWarpCols;
constexpr int kBlockWarps = 4;  // warps of a block when a row takes fewer
// the backward's staged partials, (G - 1) x 2 x H floats: at most 3 x 2 x
// 1024 (rows of one warp, G = 4) and 1 x 2 x 2048 (two warps, G = 2)
constexpr int kStage = 3 * 2 * kWarpCols;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N values of T loaded or stored as one access (two for 32 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const Pack<T, N>& v) {
  *reinterpret_cast<Pack<T, N>*>(p) = v;
}

// The first column of vector j of a lane: warp k of a row holds columns
// [k * 1024, (k + 1) * 1024), in vectors of VEC that neighbouring lanes
// hold side by side.
template <int VEC>
__device__ __forceinline__ int column(int j) {
  constexpr int NV = kLaneCols / VEC;
  return ((threadIdx.y * NV + j) * kWarp + threadIdx.x) * VEC;
}

// (a, b) summed over the warp, then over the row's K warps (blockDim.y) in
// warp order through red[K]; every thread of the row gets the same bits.
// Every thread of the block calls it, so the barriers are uniform.
__device__ __forceinline__ float2 row_sum(float a, float b, float2* red) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  const int K = blockDim.y;
  if (K == 1) return make_float2(a, b);
  if (threadIdx.x == 0) red[threadIdx.y] = make_float2(a, b);
  __syncthreads();
  float2 s = red[0];
  for (int k = 1; k < K; ++k) {
    s.x += red[k].x;
    s.y += red[k].y;
  }
  __syncthreads();
  return s;
}

__device__ __forceinline__ float rstd_of(float var, float eps) {
  return rsqrtf(fmaxf(var, 0.f) + eps);
}

struct FwdArgs {
  const void* x;   // [rows, H] in
  const float* w;  // [H]
  const float* b;  // [H] or null
  void* y;         // [rows, H] out
  float* mean;     // [rows] or null (then var is null too)
  float* var;      // [rows], unclamped
  long long rows;
  int H;
  float eps;
};

// A block is blockDim.z row groups of blockDim.y warps, one row a group.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(256) ia_ln_fwd_kernel(const FwdArgs a) {
  constexpr int NV = kLaneCols / VEC;
  __shared__ float2 red[kMaxRowWarps];
  const long long row = static_cast<long long>(blockIdx.x) * blockDim.z + threadIdx.z;
  const bool live = row < a.rows;
  const int H = a.H;
  const Tin* x = static_cast<const Tin*>(a.x) + (live ? row : 0) * H;
  float v[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = column<VEC>(j);
    if (live && c < H) {
      const Pack<Tin, VEC> p = load<Tin, VEC>(x + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = to_float(p.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[j][i] = 0.f;
    }
  }
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s += v[j][i];
      ss = __fadd_rn(ss, __fmul_rn(v[j][i], v[j][i]));
    }
  const float2 t = row_sum(s, ss, red + threadIdx.z * blockDim.y);
  const float mean = t.x / H;
  const float var = __fsub_rn(t.y / H, __fmul_rn(mean, mean));
  const float rstd = rstd_of(var, a.eps);
  if (!live) return;
  Tout* y = static_cast<Tout*>(a.y) + row * H;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = column<VEC>(j);
    if (c >= H) continue;
    const Pack<float, VEC> w = load<float, VEC>(a.w + c);
    Pack<float, VEC> b;
    if (a.b) b = load<float, VEC>(a.b + c);
    Pack<Tout, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float r = __fmul_rn(__fsub_rn(v[j][i], mean), __fmul_rn(rstd, w.v[i]));
      if (a.b) r = __fadd_rn(r, b.v[i]);
      o.v[i] = from_float<Tout>(r);
    }
    store<Tout, VEC>(y + c, o);
  }
  if (a.mean && threadIdx.x == 0 && threadIdx.y == 0) {
    a.mean[row] = mean;
    a.var[row] = var;
  }
}

struct BwdArgs {
  const void* x;      // [rows, H] in
  const float* w;     // [H]
  const float* mean;  // [rows]
  const float* var;   // [rows], unclamped
  const void* dy;     // [rows, H] out
  void* dx;           // [rows, H] in
  float* part;        // [2, blocks, H]: sum(dy * xhat), sum(dy) by block
  long long rows;
  int H;
  int rows_per_block;
  int blocks;
  float eps;
};

// A block covers rows [blockIdx.x * rows_per_block, + rows_per_block); its
// blockDim.z row groups (of blockDim.y warps) take every blockDim.z-th row.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(256) ia_ln_bwd_kernel(const BwdArgs a) {
  constexpr int NV = kLaneCols / VEC;
  __shared__ float2 red[kMaxRowWarps];
  __shared__ __align__(16) float stage[kStage];
  const int H = a.H, g = threadIdx.z, G = blockDim.z;
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  const long long r1 = min(r0 + a.rows_per_block, a.rows);
  float dw[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) dw[j][i] = db[j][i] = 0.f;

  // the same number of passes for every group, so the barriers of row_sum
  // are reached by all
  for (long long base = r0; base < r0 + a.rows_per_block; base += G) {
    const long long row = base + g;
    const bool live = row < r1;
    const long long off = (live ? row : 0) * H;
    const Tin* x = static_cast<const Tin*>(a.x) + off;
    const Tout* dy = static_cast<const Tout*>(a.dy) + off;
    Pack<Tin, VEC> xs[NV];
    Pack<Tout, VEC> ds[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = column<VEC>(j);
      if (live && c < H) {
        xs[j] = load<Tin, VEC>(x + c);
        ds[j] = load<Tout, VEC>(dy + c);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          xs[j].v[i] = from_float<Tin>(0.f);
          ds[j].v[i] = from_float<Tout>(0.f);
        }
      }
    }
    float mean = 0.f, rstd = 0.f;
    bool clamped = false;
    if (live) {
      mean = a.mean[row];
      const float var = a.var[row];
      rstd = rstd_of(var, a.eps);
      clamped = var < 0.f;
    }
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = column<VEC>(j);
      if (c >= H) continue;
      const Pack<float, VEC> w = load<float, VEC>(a.w + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(to_float(xs[j].v[i]), mean), rstd);
        const float d = to_float(ds[j].v[i]);
        const float gv = __fmul_rn(d, w.v[i]);
        sg += gv;
        sgx += gv * xhat;
        dw[j][i] += d * xhat;
        db[j][i] += d;
      }
    }
    const float2 t = row_sum(sg, sgx, red + g * blockDim.y);
    if (!live) continue;
    const float mg = t.x / H;
    const float mgx = clamped ? 0.f : t.y / H;
    Tin* dx = static_cast<Tin*>(a.dx) + off;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = column<VEC>(j);
      if (c >= H) continue;
      const Pack<float, VEC> w = load<float, VEC>(a.w + c);
      Pack<Tin, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(to_float(xs[j].v[i]), mean), rstd);
        const float gv = __fmul_rn(to_float(ds[j].v[i]), w.v[i]);
        o.v[i] = from_float<Tin>(rstd * (gv - mg - xhat * mgx));
      }
      store<Tin, VEC>(dx + c, o);
    }
  }

  // groups 1..G-1 stage their partials; group 0 adds them in group order
  if (G > 1) {
    if (g > 0) {
      float* st = stage + (g - 1) * 2 * H;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = column<VEC>(j);
        if (c >= H) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          st[c + i] = dw[j][i];
          st[H + c + i] = db[j][i];
        }
      }
    }
    __syncthreads();
    if (g > 0) return;
    for (int k = 1; k < G; ++k) {
      const float* st = stage + (k - 1) * 2 * H;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = column<VEC>(j);
        if (c >= H) continue;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          dw[j][i] += st[c + i];
          db[j][i] += st[H + c + i];
        }
      }
    }
  }
  float* pw = a.part + static_cast<long long>(blockIdx.x) * H;
  float* pb = a.part + (static_cast<long long>(a.blocks) + blockIdx.x) * H;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = column<VEC>(j);
    if (c >= H) continue;
    Pack<float, VEC> ow, ob;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ow.v[i] = dw[j][i];
      ob.v[i] = db[j][i];
    }
    store<float, VEC>(pw + c, ow);
    store<float, VEC>(pb + c, ob);
  }
}

// dw[c] (and db[c]) = the sum over blocks of part[0 (1), block, c]: each of
// the block's 32 slices (threadIdx.y) adds every 32nd block, then slice 0
// adds the slices in order.
__global__ void __launch_bounds__(1024)
    ia_ln_params_kernel(const float* part, float* dw, float* db, int blocks, int H) {
  __shared__ float acc[2][kWarp][kWarp + 1];
  const int c = blockIdx.x * kWarp + threadIdx.x, t = threadIdx.y;
  float sw = 0.f, sb = 0.f;
  if (c < H) {
    for (int b = t; b < blocks; b += kWarp) {
      sw += part[static_cast<long long>(b) * H + c];
      sb += part[(static_cast<long long>(blocks) + b) * H + c];
    }
  }
  acc[0][t][threadIdx.x] = sw;
  acc[1][t][threadIdx.x] = sb;
  __syncthreads();
  if (t != 0 || c >= H) return;
  for (int s = 1; s < kWarp; ++s) {
    sw += acc[0][s][threadIdx.x];
    sb += acc[1][s][threadIdx.x];
  }
  dw[c] = sw;
  if (db) db[c] = sb;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return false;
  return true;
}

// (warps a row, row groups a block) for width H
dim3 block_of(int H) {
  const int K = (H + kWarpCols - 1) / kWarpCols;
  const int G = K >= kBlockWarps ? 1 : kBlockWarps / K;
  return dim3(kWarp, K, G);
}

template <typename Tin, typename Tout>
int fwd_typed(const FwdArgs& a, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(Tin);
  const dim3 block = block_of(a.H);
  const long long grid = (a.rows + block.z - 1) / block.z;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (a.H % VEC == 0 && aligned16({a.x, a.w, a.b, a.y}))
    ia_ln_fwd_kernel<Tin, Tout, VEC><<<static_cast<unsigned>(grid), block, 0, st>>>(a);
  else
    ia_ln_fwd_kernel<Tin, Tout, 1><<<static_cast<unsigned>(grid), block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename Tout>
int bwd_typed(const BwdArgs& a, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(Tin);
  const dim3 block = block_of(a.H);
  if (a.H % VEC == 0 && aligned16({a.x, a.w, a.dy, a.dx, a.part}))
    ia_ln_bwd_kernel<Tin, Tout, VEC><<<a.blocks, block, 0, st>>>(a);
  else
    ia_ln_bwd_kernel<Tin, Tout, 1><<<a.blocks, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dtype codes: 0 float32, 1 bfloat16
template <typename A, int (*F00)(const A&, cudaStream_t), int (*F01)(const A&, cudaStream_t),
          int (*F10)(const A&, cudaStream_t), int (*F11)(const A&, cudaStream_t)>
int dispatch(int in_dtype, int out_dtype, const A& a, cudaStream_t st) {
  if (in_dtype == 0 && out_dtype == 0) return F00(a, st);
  if (in_dtype == 0 && out_dtype == 1) return F01(a, st);
  if (in_dtype == 1 && out_dtype == 0) return F10(a, st);
  if (in_dtype == 1 && out_dtype == 1) return F11(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(long long rows, int H) { return rows < 1 || H < 1 || H > kMaxWidth; }

}  // namespace

extern "C" {

// y = LayerNorm(x) for contiguous [rows, H] x and y, fp32 w and b (b may be
// null), H up to 8192; with mean and var (both or neither) also each row's
// fp32 mean and unclamped variance.  Returns the cudaError_t of the launch.
int ia_ln_fwd(int in_dtype, int out_dtype, const void* x, const void* w, const void* b, void* y,
              void* mean, void* var, long long rows, int H, float eps, void* stream) {
  if (bad_shape(rows, H) || (mean == nullptr) != (var == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x,    static_cast<const float*>(w), static_cast<const float*>(b),
                  y,    static_cast<float*>(mean),    static_cast<float*>(var),
                  rows, H,                            eps};
  return dispatch<FwdArgs, fwd_typed<float, float>, fwd_typed<float, __nv_bfloat16>,
                  fwd_typed<__nv_bfloat16, float>, fwd_typed<__nv_bfloat16, __nv_bfloat16>>(
      in_dtype, out_dtype, a, static_cast<cudaStream_t>(stream));
}

// dx (x's type) and the [2, blocks, H] fp32 partials of dw and db from the
// forward's x, mean and var and dy (the output's type), all contiguous;
// blocks * rows_per_block must cover rows.
int ia_ln_bwd(int in_dtype, int out_dtype, const void* x, const void* w, const void* mean,
              const void* var, const void* dy, void* dx, void* part, long long rows, int H,
              int rows_per_block, int blocks, float eps, void* stream) {
  if (bad_shape(rows, H) || rows_per_block < 1 || blocks < 1 ||
      static_cast<long long>(rows_per_block) * blocks < rows ||
      static_cast<long long>(rows_per_block) * (blocks - 1) >= rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x,
                  static_cast<const float*>(w),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(var),
                  dy,
                  dx,
                  static_cast<float*>(part),
                  rows,
                  H,
                  rows_per_block,
                  blocks,
                  eps};
  return dispatch<BwdArgs, bwd_typed<float, float>, bwd_typed<float, __nv_bfloat16>,
                  bwd_typed<__nv_bfloat16, float>, bwd_typed<__nv_bfloat16, __nv_bfloat16>>(
      in_dtype, out_dtype, a, static_cast<cudaStream_t>(stream));
}

// dw (and db, unless null) [H] fp32: the backward's partials summed over
// its blocks in a fixed order.
int ia_ln_bwd_params(const void* part, void* dw, void* db, int blocks, int H, void* stream) {
  if (blocks < 1 || H < 1 || H > kMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  ia_ln_params_kernel<<<(H + kWarp - 1) / kWarp, dim3(kWarp, kWarp), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), static_cast<float*>(db), blocks, H);
  return static_cast<int>(cudaGetLastError());
}

const char* ia_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
