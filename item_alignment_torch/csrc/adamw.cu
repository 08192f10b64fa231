// AdamW's update for Hopper (sm_90a): every tensor of an optimizer step in
// one pass, in place, with the arithmetic of ops/adamw.py:adamw_reference
// (the plain chain of torch._foreach_* calls):
//
//   m' = b1 * m + (1 - b1) * g            v' = b2 * v + (1 - b2) * g * g
//   u  = (m' / c1) / (sqrt(v' / c2) + eps) (+ wd * p where decayed)
//   p' = p + u * -lr                       (only where trained)
//
// in fp32 from the fp32 m' and v', which are stored rounded to the moments'
// type.  The moment updates and the decay are one multiply-add each, as the
// chain's add-with-alpha and addcmul compute them; every other product,
// quotient and sum is rounded on its own, as the chain's separate passes
// round it (the intrinsics keep nvcc from contracting them).
//
// Replaces no TPU kernel: the JAX package leaves its optax chain to XLA's
// fusion.  The port's chain made about fifteen passes over fp32 copies of
// every tensor and some 800 launches a step, 19.4 ms of a RoBERTa-large
// train step on an H100.
//
// Bound on this card (H100 SXM: 3.35 TB/s).  Nothing but bytes: p and g are
// read, the moments read and written, p written where trained: 20 bytes a
// parameter with fp32 p and g and bf16 moments, 6.51 GB over RoBERTa-large's
// 325.5 M parameters, 1.94 ms.  So:
//   - one launch takes a table of up to kMaxTensors tensors (pointers,
//     lengths, flags) in its arguments (a __grid_constant__ struct of about
//     23 KB; CUDA 12.1 and sm_70 or later take up to 32 KB), so the host
//     writes nothing to the device and never waits;
//   - each tensor is cut into chunks of kChunk elements, counted across the
//     table; block c finds its tensor by a binary search over the chunks'
//     running ends, so a 1024-element bias and a 21.6 M-element word table
//     share one grid;
//   - a thread loads kVec elements of each array at once (16 bytes of an
//     fp32 array, 8 of a bf16 one) kUnroll times before it computes, where
//     all four pointers are aligned to that; the ragged tail, and a tensor
//     that is not aligned, go element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxTensors = 512;  // ops/adamw.py:MAX_TENSORS
constexpr int kChunk = 16384;     // ops/adamw.py:CHUNK
constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kUnroll = 2;
constexpr unsigned char kTrained = 1, kDecay = 2;  // ops/adamw.py:TRAINED, DECAY

struct Table {
  void* ptr[4][kMaxTensors];  // p, g, m, v
  long long n[kMaxTensors];   // elements
  int chunk_end[kMaxTensors];  // chunks of tensors 0..i
  unsigned char flags[kMaxTensors];
  int count;
};

struct Hyper {
  float lr, b1, om1, b2, om2, c1, c2, eps, wd;  // om: 1 - b, rounded once
};

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

template <typename T>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T>
__device__ __forceinline__ bool aligned(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % sizeof(Pack<T>) == 0;
}

// One element: p, m and v updated in place (p only when trained).
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Hyper& h,
                                       bool decay) {
  m = fmaf(h.om1, g, __fmul_rn(m, h.b1));
  v = fmaf(h.om2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  float u = __fdiv_rn(__fdiv_rn(m, h.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.c2)), h.eps));
  if (decay) u = fmaf(h.wd, p, u);
  p = __fadd_rn(p, __fmul_rn(u, -h.lr));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
    ia_adamw_kernel(const __grid_constant__ Table t, const Hyper h) {
  const int c = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the first tensor whose chunks end past c
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.chunk_end[mid] <= c)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int i = lo;
  const long long first = static_cast<long long>(c - (i ? t.chunk_end[i - 1] : 0)) * kChunk;
  const int len = static_cast<int>(min(static_cast<long long>(kChunk), t.n[i] - first));
  P* __restrict__ p = static_cast<P*>(t.ptr[0][i]) + first;
  const G* __restrict__ g = static_cast<const G*>(t.ptr[1][i]) + first;
  M* __restrict__ m = static_cast<M*>(t.ptr[2][i]) + first;
  M* __restrict__ v = static_cast<M*>(t.ptr[3][i]) + first;
  const bool trained = t.flags[i] & kTrained, decay = t.flags[i] & kDecay;

  const int nvec = aligned(p) && aligned(g) && aligned(m) && aligned(v) ? len / kVec : 0;
  for (int base = threadIdx.x; base < nvec; base += kThreads * kUnroll) {
    Pack<P> pp[kUnroll];
    Pack<G> gg[kUnroll];
    Pack<M> mm[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      if (j < nvec) {
        pp[u] = reinterpret_cast<const Pack<P>*>(p)[j];
        gg[u] = reinterpret_cast<const Pack<G>*>(g)[j];
        mm[u] = reinterpret_cast<const Pack<M>*>(m)[j];
        vv[u] = reinterpret_cast<const Pack<M>*>(v)[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kThreads;
      if (j < nvec) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          float pf = to_float(pp[u].v[k]), mf = to_float(mm[u].v[k]), vf = to_float(vv[u].v[k]);
          update(pf, to_float(gg[u].v[k]), mf, vf, h, decay);
          pp[u].v[k] = from_float<P>(pf);
          mm[u].v[k] = from_float<M>(mf);
          vv[u].v[k] = from_float<M>(vf);
        }
        if (trained) reinterpret_cast<Pack<P>*>(p)[j] = pp[u];
        reinterpret_cast<Pack<M>*>(m)[j] = mm[u];
        reinterpret_cast<Pack<M>*>(v)[j] = vv[u];
      }
    }
  }
  // the ragged tail, or the whole chunk of a tensor that is not aligned
  for (int e = nvec * kVec + threadIdx.x; e < len; e += kThreads) {
    float pf = to_float(p[e]), mf = to_float(m[e]), vf = to_float(v[e]);
    update(pf, to_float(g[e]), mf, vf, h, decay);
    if (trained) p[e] = from_float<P>(pf);
    m[e] = from_float<M>(mf);
    v[e] = from_float<M>(vf);
  }
}

template <typename P, typename G, typename M>
int launch(const Table& t, const Hyper& h, cudaStream_t st) {
  ia_adamw_kernel<P, G, M><<<t.chunk_end[t.count - 1], kThreads, 0, st>>>(t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int by_moment(int m_dtype, const Table& t, const Hyper& h, cudaStream_t st) {
  if (m_dtype == 0) return launch<P, G, float>(t, h, st);
  if (m_dtype == 1) return launch<P, G, __nv_bfloat16>(t, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename P>
int by_grad(int g_dtype, int m_dtype, const Table& t, const Hyper& h, cudaStream_t st) {
  if (g_dtype == 0) return by_moment<P, float>(m_dtype, t, h, st);
  if (g_dtype == 1) return by_moment<P, __nv_bfloat16>(m_dtype, t, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One AdamW step over `count` tensors (1 to 512) of one type triple (0
// float32, 1 bfloat16: parameter, gradient, moments), in place, on
// `stream`.  ptrs: [4][count] pointers to the contiguous p, g, m and v of
// each tensor; n: each tensor's elements (at least 1); chunk_end: the running
// sum of ceil(n / 16384); flags: 1 trained, 2 decayed.  The table is checked
// against these rules before anything is launched.  Returns the cudaError_t
// of the launch.
int ia_adamw(int p_dtype, int g_dtype, int m_dtype, int count, const void* const* ptrs,
             const long long* n, const int* chunk_end, const unsigned char* flags, float lr,
             float b1, float om1, float b2, float om2, float c1, float c2, float eps, float wd,
             void* stream) {
  if (count < 1 || count > kMaxTensors) return static_cast<int>(cudaErrorInvalidValue);
  Table t;  // 23 KB, copied into the launch's arguments
  long long end = 0;
  for (int i = 0; i < count; ++i) {
    end += (n[i] + kChunk - 1) / kChunk;
    if (n[i] < 1 || chunk_end[i] != end || end > 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int k = 0; k < 4; ++k) t.ptr[k][i] = const_cast<void*>(ptrs[k * count + i]);
  }
  std::memcpy(t.n, n, sizeof(long long) * count);
  std::memcpy(t.chunk_end, chunk_end, sizeof(int) * count);
  std::memcpy(t.flags, flags, count);
  t.count = count;
  const Hyper h{lr, b1, om1, b2, om2, c1, c2, eps, wd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0) return by_grad<float>(g_dtype, m_dtype, t, h, st);
  if (p_dtype == 1) return by_grad<__nv_bfloat16>(g_dtype, m_dtype, t, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ia_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
