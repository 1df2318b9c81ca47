// Fused per-sample GroupNorm (+ optional ReLU) over contiguous NCHW, for
// Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// pdac_pathological_image_segmentation_tpu/ops/pallas/group_norm.py:
//   _gn_relu_kernel      (blocks whose 4*H*W*C*itemsize fits 15 MiB VMEM)
//   _gn_relu_dma_kernel  (larger blocks, streamed through a 2-slot DMA ring)
// Both compute the same function; on the card neither size regime fits in
// one SM's shared memory, so one design covers both.
//
// What bounds it: memory traffic.  About 8 flops per element against the
// card's ~295 operations per byte of bf16 before compute becomes the limit,
// so the least time is the bytes moved over 3.35 TB/s.
//
// Design (right and simple first):
//   1. gn_stats: grid (N*G, S).  In contiguous NCHW each (n, g) is one
//      contiguous span of cg*H*W elements.  Each block reads its share of
//      the span with 16-byte vector loads and keeps a Chan (count, mean, M2)
//      in f32 (one vector at a time, merged into the thread's running
//      triple), merges across the warp with shuffles and across warps
//      through shared memory, and writes one partial per block.  The
//      variance is the centred one, as the JAX package's plain
//      xla_group_norm_relu, not the Pallas kernels' one-pass E[x^2]-mean^2.
//   2. gn_apply: same grid.  Each block merges the S partials of its (n, g)
//      in a fixed order, then writes y = x*(gamma_c*rstd) +
//      (beta_c - mean*gamma_c*rstd), ReLU, in x's dtype.
// No atomics: the result is the same from run to run.  x is read twice and
// y written once (the Pallas kernels read once); a one-read design is later
// work (a bf16 span of 128^2 x 4 channels is 128 KiB and fits one block's
// shared memory; f32 spans need a cluster/DSMEM design).
//
// Plain C interface, loaded with ctypes.  The kernels run on the caller's
// stream and allocate nothing: the wrapper passes the partials buffer
// (N*G*S*3 floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Stat {
  float n;
  float mean;
  float m2;
};

// Chan et al.'s parallel merge of two (count, mean, M2) triples.  An empty
// side (n == 0, mean == 0, m2 == 0) leaves the other unchanged.
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float wb = b.n / n;
  const float delta = b.mean - a.mean;
  Stat r;
  r.n = n;
  r.mean = a.mean + delta * wb;
  r.m2 = a.m2 + b.m2 + delta * delta * a.n * wb;
  return r;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements: one 16-byte access when VEC * sizeof(T) == 16, else scalar.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_float(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_float(p[k]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_float<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_float<T>(v[k]);
  }
}

// Block (ng, s) covers elements [s*chunk, min((s+1)*chunk, span)) of span ng.
// chunk and span are multiples of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                int span, int chunk) {
  const int ng = blockIdx.x;
  const int s = blockIdx.y;
  const int begin = s * chunk;
  const int end = min(begin + chunk, span);
  const T* base = x + static_cast<int64_t>(ng) * span;

  Stat acc{0.f, 0.f, 0.f};
  for (int i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    float v[VEC];
    load_vec<T, VEC>(base + i, v);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum += v[k];
    const float mean = sum * (1.f / VEC);
    float m2 = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = v[k] - mean;
      m2 = fmaf(d, d, m2);
    }
    acc = merge(acc, Stat{static_cast<float>(VEC), mean, m2});
  }

  // warp tree (lane i absorbs lane i+off), then the warps' results in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Stat o;
    o.n = __shfl_down_sync(0xffffffffu, acc.n, off);
    o.mean = __shfl_down_sync(0xffffffffu, acc.mean, off);
    o.m2 = __shfl_down_sync(0xffffffffu, acc.m2, off);
    acc = merge(acc, o);
  }
  __shared__ Stat warp_stat[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_stat[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat r = warp_stat[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) r = merge(r, warp_stat[w]);
    float* out = partials + (static_cast<int64_t>(ng) * gridDim.y + s) * 3;
    out[0] = r.n;
    out[1] = r.mean;
    out[2] = r.m2;
  }
}

// hw is a multiple of VEC, so one vector never straddles two channels.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const float* __restrict__ partials, T* __restrict__ y,
                int span, int chunk, int hw, int cg, int groups, float eps,
                int relu) {
  const int ng = blockIdx.x;
  const int s = blockIdx.y;
  const int splits = gridDim.y;

  // every thread merges the same partials in the same order
  const float* p = partials + static_cast<int64_t>(ng) * splits * 3;
  Stat acc{0.f, 0.f, 0.f};
  for (int k = 0; k < splits; ++k) {
    acc = merge(acc, Stat{p[3 * k], p[3 * k + 1], p[3 * k + 2]});
  }
  const float mean = acc.mean;
  const float rstd = rsqrtf(acc.m2 / acc.n + eps);

  extern __shared__ float coef[];  // [scale(cg) | shift(cg)]
  const int c0 = (ng % groups) * cg;
  for (int c = threadIdx.x; c < cg; c += kThreads) {
    const float sc = gamma[c0 + c] * rstd;
    coef[c] = sc;
    coef[cg + c] = beta[c0 + c] - mean * sc;
  }
  __syncthreads();

  const int begin = s * chunk;
  const int end = min(begin + chunk, span);
  const int64_t off = static_cast<int64_t>(ng) * span;
  const T* xb = x + off;
  T* yb = y + off;
  for (int i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    const int c = i / hw;
    const float sc = coef[c];
    const float sh = coef[cg + c];
    float v[VEC];
    load_vec<T, VEC>(xb + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float t = fmaf(v[k], sc, sh);
      v[k] = relu ? fmaxf(t, 0.f) : t;
    }
    store_vec<T, VEC>(yb + i, v);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, void* partials, int n, int c, int hw, int groups,
                   int splits, int chunk, float eps, int relu,
                   cudaStream_t stream) {
  const int cg = c / groups;
  const int span = cg * hw;
  const dim3 grid(static_cast<unsigned>(n * groups),
                  static_cast<unsigned>(splits));
  gn_stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partials), span, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T, VEC><<<grid, kThreads, 2 * cg * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(partials),
      static_cast<T*>(y), span, chunk, hw, cg, groups, eps, relu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per access, either
// 16 / itemsize (16-byte aligned tensors, hw a multiple of it) or 1.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int pdac_group_norm_relu(const void* x, const void* gamma,
                                    const void* beta, void* y,
                                    void* partials, int n, int c, int hw,
                                    int groups, int splits, int chunk,
                                    float eps, int relu, int dtype, int vec,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec == 4)
      return launch<float, 4>(x, gamma, beta, y, partials, n, c, hw, groups,
                              splits, chunk, eps, relu, st);
    if (vec == 1)
      return launch<float, 1>(x, gamma, beta, y, partials, n, c, hw, groups,
                              splits, chunk, eps, relu, st);
  } else if (dtype == 1) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, gamma, beta, y, partials, n, c, hw,
                                      groups, splits, chunk, eps, relu, st);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(x, gamma, beta, y, partials, n, c, hw,
                                      groups, splits, chunk, eps, relu, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
