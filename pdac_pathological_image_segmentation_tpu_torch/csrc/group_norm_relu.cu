// Fused per-sample GroupNorm (+ optional ReLU) over contiguous NCHW, for
// Hopper (sm_90a): the forward and its backward.
//
// Replaces the Pallas TPU kernels of
// pdac_pathological_image_segmentation_tpu/ops/pallas/group_norm.py:
//   _gn_relu_kernel      (blocks whose 4*H*W*C*itemsize fits 15 MiB VMEM)
//   _gn_relu_dma_kernel  (larger blocks, streamed through a 2-slot DMA ring)
//   _gn_trainable_bwd    (the backward of the group_norm_relu_trainable
//                         custom VJP, which was XLA ops around the kernel)
// The two forward kernels compute the same function; on the card neither
// size regime fits in one SM's shared memory, so one design covers both.
//
// What bounds them: memory traffic.  About 8 flops per element against the
// card's ~295 operations per byte of bf16 before compute becomes the limit,
// so the least time is the bytes moved over 3.35 TB/s.
//
// Forward (right and simple first):
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
//      (beta_c - mean*gamma_c*rstd), ReLU, in x's dtype.  When the caller
//      passes a stats buffer, block (ng, 0) also writes (mean, rstd) of its
//      span there: 8 bytes per (n, g), kept for the backward so that it
//      need not read x once more to recompute them.
// x is read twice and y written once (the Pallas kernels read once); a
// one-read design is later work (a bf16 span of 128^2 x 4 channels is
// 128 KiB and fits one block's shared memory; f32 spans need a
// cluster/DSMEM design).
//
// Backward (the math of _gn_trainable_bwd, with dy masked by out > 0 when
// the forward had ReLU, xhat = (x - mean) * rstd):
//   3. gn_bwd_reduce: grid (N*C).  One block per (n, c) plane writes
//      sum(dy) and sum(dy*xhat) over the plane.  The per-(n, group) sums the
//      backward needs follow from these, since gamma is per channel:
//      sum(dy*gamma) = sum_c gamma_c*sum(dy)_c, and likewise with xhat.
//   4. gn_bwd_apply: grid (N*G, S) as in the forward.  Each block merges the
//      cg per-channel sums of its (n, g) in a fixed order into
//      m1 = mean(dy*gamma) and m2 = mean(dy*gamma*xhat), and writes
//      dx = (dy*gamma - m1 - xhat*m2) * rstd in x's dtype.  Blocks (g, 0)
//      of sample 0 also reduce the per-(n, c) sums over n, in order, into
//      dgamma = sum(dy*xhat) and dbeta = sum(dy) (float32).
//   The backward reads x, out and dy twice and writes dx once: 7 passes
//   against the 4 of its bound.  A one-read design is later work.
// No atomics anywhere: results are the same from run to run.
//
// Plain C interface, loaded with ctypes.  The kernels run on the caller's
// stream and allocate nothing: the wrapper passes every buffer.

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
                float* __restrict__ stats, int span, int chunk, int hw,
                int cg, int groups, float eps, int relu) {
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
  if (stats != nullptr && s == 0 && threadIdx.x == 0) {
    stats[2 * ng] = mean;
    stats[2 * ng + 1] = rstd;
  }

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
                   void* y, void* partials, void* stats, int n, int c, int hw,
                   int groups, int splits, int chunk, float eps, int relu,
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
      static_cast<T*>(y), static_cast<float*>(stats), span, chunk, hw, cg,
      groups, eps, relu);
  return cudaGetLastError();
}

// Sum of one float over the block, in a fixed order (warp trees, then the
// warps in order); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.f;
  if (threadIdx.x == 0) {
    r = scratch[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) r += scratch[w];
  }
  return r;
}

// One block per (n, c) plane of hw elements (hw a multiple of VEC).
// sums[2*nc] = sum(dy), sums[2*nc+1] = sum(dy*xhat), dy masked by out > 0
// when relu is set.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                     const T* __restrict__ out,
                     const float* __restrict__ stats,
                     float* __restrict__ sums, int c, int hw, int cg,
                     int relu) {
  const int nc = blockIdx.x;
  const int ng = (nc / c) * (c / cg) + (nc % c) / cg;
  const float mean = stats[2 * ng];
  const float rstd = stats[2 * ng + 1];
  const int64_t off = static_cast<int64_t>(nc) * hw;
  float s_dy = 0.f, s_dyx = 0.f;
  for (int i = threadIdx.x * VEC; i < hw; i += kThreads * VEC) {
    float g[VEC], v[VEC], o[VEC];
    load_vec<T, VEC>(dy + off + i, g);
    load_vec<T, VEC>(x + off + i, v);
    if (relu) load_vec<T, VEC>(out + off + i, o);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = (relu && !(o[k] > 0.f)) ? 0.f : g[k];
      s_dy += d;
      s_dyx = fmaf(d, (v[k] - mean) * rstd, s_dyx);
    }
  }
  __shared__ float scratch[kThreads / 32];
  const float t_dy = block_sum(s_dy, scratch);
  __syncthreads();
  const float t_dyx = block_sum(s_dyx, scratch);
  if (threadIdx.x == 0) {
    sums[2 * nc] = t_dy;
    sums[2 * nc + 1] = t_dyx;
  }
}

// Grid (N*G, S) over the spans, as gn_apply.  hw is a multiple of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gn_bwd_apply_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                    const T* __restrict__ out, const float* __restrict__ gamma,
                    const float* __restrict__ stats,
                    const float* __restrict__ sums, T* __restrict__ dx,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    int n, int span, int chunk, int hw, int cg, int groups,
                    int relu) {
  const int ng = blockIdx.x;
  const int s = blockIdx.y;
  const int g = ng % groups;
  const int c0 = g * cg;
  const int c = cg * groups;
  const float mean = stats[2 * ng];
  const float rstd = stats[2 * ng + 1];

  // every thread merges the same cg sums in the same order
  const float* p = sums + 2 * (static_cast<int64_t>(ng / groups) * c + c0);
  float a1 = 0.f, a2 = 0.f;
  for (int k = 0; k < cg; ++k) {
    const float gk = gamma[c0 + k];
    a1 = fmaf(gk, p[2 * k], a1);
    a2 = fmaf(gk, p[2 * k + 1], a2);
  }
  const float m1 = a1 / static_cast<float>(span);
  const float m2 = a2 / static_cast<float>(span);

  if (ng < groups && s == 0) {
    // dgamma, dbeta of this group's channels: sums over n, in order
    for (int k = threadIdx.x; k < cg; k += kThreads) {
      float sg = 0.f, sb = 0.f;
      for (int i = 0; i < n; ++i) {
        const float* q = sums + 2 * (static_cast<int64_t>(i) * c + c0 + k);
        sb += q[0];
        sg += q[1];
      }
      dgamma[c0 + k] = sg;
      dbeta[c0 + k] = sb;
    }
  }

  const int begin = s * chunk;
  const int end = min(begin + chunk, span);
  const int64_t off = static_cast<int64_t>(ng) * span;
  for (int i = begin + threadIdx.x * VEC; i < end; i += kThreads * VEC) {
    const float gc = gamma[c0 + i / hw];
    float d[VEC], v[VEC], o[VEC];
    load_vec<T, VEC>(dy + off + i, d);
    load_vec<T, VEC>(x + off + i, v);
    if (relu) load_vec<T, VEC>(out + off + i, o);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float dk = (relu && !(o[k] > 0.f)) ? 0.f : d[k];
      const float xhat = (v[k] - mean) * rstd;
      v[k] = (dk * gc - m1 - xhat * m2) * rstd;
    }
    store_vec<T, VEC>(dx + off + i, v);
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* dy, const void* x, const void* out,
                       const void* gamma, const void* stats, void* sums,
                       void* dx, void* dgamma, void* dbeta, int n, int c,
                       int hw, int groups, int splits, int chunk, int relu,
                       cudaStream_t stream) {
  const int cg = c / groups;
  gn_bwd_reduce_kernel<T, VEC><<<static_cast<unsigned>(n * c), kThreads, 0,
                                  stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(out), static_cast<const float*>(stats),
      static_cast<float*>(sums), c, hw, cg, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(n * groups),
                  static_cast<unsigned>(splits));
  gn_bwd_apply_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(out), static_cast<const float*>(gamma),
      static_cast<const float*>(stats), static_cast<const float*>(sums),
      static_cast<T*>(dx), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), n, cg * hw, chunk, hw, cg, groups, relu);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: elements per access, either
// 16 / itemsize (16-byte aligned tensors, hw a multiple of it) or 1.
// stats: null, or N*G*2 floats that receive each span's (mean, rstd).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int pdac_group_norm_relu(const void* x, const void* gamma,
                                    const void* beta, void* y,
                                    void* partials, void* stats, int n, int c,
                                    int hw, int groups, int splits, int chunk,
                                    float eps, int relu, int dtype, int vec,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PDAC_GN_FWD(T, V)                                                  \
  return launch<T, V>(x, gamma, beta, y, partials, stats, n, c, hw, groups, \
                      splits, chunk, eps, relu, st)
  if (dtype == 0) {
    if (vec == 4) PDAC_GN_FWD(float, 4);
    if (vec == 1) PDAC_GN_FWD(float, 1);
  } else if (dtype == 1) {
    if (vec == 8) PDAC_GN_FWD(__nv_bfloat16, 8);
    if (vec == 1) PDAC_GN_FWD(__nv_bfloat16, 1);
  }
#undef PDAC_GN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

// The backward.  dy, x, out and dx share x's dtype and layout; gamma,
// dgamma, dbeta are (C,) float32; stats is the forward's (mean, rstd) per
// (n, g); sums is scratch of N*C*2 floats.  splits/chunk come from the
// forward's launch plan.
extern "C" int pdac_group_norm_relu_bwd(const void* dy, const void* x,
                                        const void* out, const void* gamma,
                                        const void* stats, void* sums,
                                        void* dx, void* dgamma, void* dbeta,
                                        int n, int c, int hw, int groups,
                                        int splits, int chunk, int relu,
                                        int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PDAC_GN_BWD(T, V)                                                  \
  return launch_bwd<T, V>(dy, x, out, gamma, stats, sums, dx, dgamma,     \
                          dbeta, n, c, hw, groups, splits, chunk, relu, st)
  if (dtype == 0) {
    if (vec == 4) PDAC_GN_BWD(float, 4);
    if (vec == 1) PDAC_GN_BWD(float, 1);
  } else if (dtype == 1) {
    if (vec == 8) PDAC_GN_BWD(__nv_bfloat16, 8);
    if (vec == 1) PDAC_GN_BWD(__nv_bfloat16, 1);
  }
#undef PDAC_GN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
