// Fused per-sample GroupNorm (+ optional ReLU) over contiguous NCHW, for
// Hopper (sm_90a): the forward and its backward, each in two designs.
//
// Replaces the Pallas TPU kernels of
// pdac_pathological_image_segmentation_tpu/ops/pallas/group_norm.py:
//   _gn_relu_kernel      (blocks whose 4*H*W*C*itemsize fits 15 MiB VMEM)
//   _gn_relu_dma_kernel  (larger blocks, streamed through a 2-slot DMA ring)
//   _gn_trainable_bwd    (the backward of the group_norm_relu_trainable
//                         custom VJP, which was XLA ops around the kernel)
// The two Pallas forwards compute the same function and differ only in
// how a TPU block reaches VMEM; here the launch plan (ops/group_norm.py)
// picks one of the designs below by shape alone, for either of them.
//
// What bounds them: memory traffic.  About 8 (forward) and 14 (backward)
// f32 operations per element against the card's ~20 per byte of f32 at
// 67 TFLOP/s and 3.35 TB/s, so the least time is the bytes that must move:
// x read and y written (forward); dy, x and out read and dx written
// (backward).  In contiguous NCHW each (n, g) is one contiguous span of
// cg*H*W elements, and every statistic is per span.
//
// Cluster design (the plan's choice wherever it fits):
//   A thread-block cluster of K blocks (K in 1, 2, 4, 8, a launch attribute)
//   owns one span.  Each block bulk-copies its contiguous share (span/K
//   elements) from device memory into shared memory with cp.async.bulk, in
//   16 KiB chunks that each complete on their own mbarrier, so the first
//   pass starts on chunk 0 while the rest arrive.  Nothing is read twice
//   from device memory and there is one launch.
//   1. gn_fwd_cluster: each block sums its share; the K sums are exchanged
//      through distributed shared memory and every block adds them in rank
//      order into the mean.  Then the centred sum of squares, exchanged and
//      added the same way, gives M2: the exact two-pass centred variance of
//      the JAX package's xla_group_norm_relu, in f32, in a fixed order.
//      Each block then writes y = x*(gamma_c*rstd) + (beta_c -
//      mean*gamma_c*rstd), ReLU, from shared memory with 16-byte stores;
//      rank 0 writes (mean, rstd) into stats when the backward needs them.
//   2. gn_bwd_cluster: each block copies its shares of dy and x, reads out
//      once (16-byte loads) to mask dy where out <= 0 (with ReLU), and keeps
//      masked dy and x.  Per channel it sums dy and dy*xhat (xhat = (x -
//      mean)*rstd from the forward's stats); where K > cg a channel's plane
//      spans several blocks, and the per-channel partials of the K blocks
//      are added in rank order.  From them m1 = mean(dy*gamma) and m2 =
//      mean(dy*gamma*xhat) over the span, and dx = (dy*gamma - m1 -
//      xhat*m2)*rstd is written from shared memory: the math of
//      _gn_trainable_bwd.  Rank 0 writes the span's per-(n, c) sums.
//   3. gn_bwd_param: a tiny second launch, one warp per channel, reduces
//      those sums over n (lanes over n in order, then a fixed shuffle tree)
//      into dgamma = sum(dy*xhat) and dbeta = sum(dy), float32.
//   A block's last act is a cluster barrier, so that no block exits while
//   another may still read its shared memory.
//
// Streaming design (the plan's choice where a share would not fit its
// shared-memory budget even at K = 8, where a channel plane is not a whole
// number of 16-byte vectors, such as 7x7, or where a tensor is not 16-byte
// aligned; it also takes scalar accesses):
//   4. gn_stats + gn_apply: grid (N*G, S).  gn_stats reads its part of the
//      span and writes a Chan (count, mean, M2) partial; gn_apply merges
//      the S partials in a fixed order and writes y (and stats).  x is read
//      twice: two launches and a partials buffer.
//   5. gn_bwd_reduce + gn_bwd_apply: one block per (n, c) plane writes
//      sum(dy) and sum(dy*xhat); the apply pass merges the cg channel sums
//      of its span in a fixed order and writes dx, and sample 0's blocks
//      reduce dgamma, dbeta over n.  x, out and dy are read twice.
// No atomics anywhere: two launches give bitwise equal results.
//
// Plain C interface, loaded with ctypes.  The kernels run on the caller's
// stream and allocate nothing: the wrapper passes every buffer.  A launch
// the card refuses (too much shared memory, a cluster that cannot be
// scheduled) returns its cudaError; nothing is retried another way.

#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coop = cooperative_groups;

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
cudaError_t launch_streaming(const void* x, const void* gamma,
                             const void* beta, void* y, void* partials,
                             void* stats, int n, int c, int hw, int groups,
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
cudaError_t launch_bwd_streaming(const void* dy, const void* x,
                                 const void* out, const void* gamma,
                                 const void* stats, void* sums, void* dx,
                                 void* dgamma, void* dbeta, int n, int c,
                                 int hw, int groups, int splits, int chunk,
                                 int relu, cudaStream_t stream) {
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

// -- the cluster design -------------------------------------------------------

constexpr int kMaxThreads = 256;
constexpr int kChunkBytes = 16384;  // one bulk copy, one mbarrier
constexpr int kChunkVecs = kChunkBytes / 16;
constexpr int kMaxChunks = 8;
constexpr int kOutBatch = 4;  // the backward's loads of out in flight

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 initialises one mbarrier per chunk (one arrival, its own, plus
// the chunk's bytes) and starts the bulk copies: NT tensors, share_bytes of
// each from src[t], land back to back at dst.  The block's threads meet
// after the initialisation, before any of them waits on a barrier.
template <int NT>
__device__ __forceinline__ void start_bulk_loads(
    uint64_t* bars, unsigned char* dst, const unsigned char* const (&src)[NT],
    int share_bytes, int nchunks) {
  if (threadIdx.x == 0) {
    for (int j = 0; j < nchunks; ++j)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&bars[j])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < nchunks; ++j) {
      const int b0 = j * kChunkBytes;
      const int nb = min(kChunkBytes, share_bytes - b0);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(smem_u32(&bars[j])), "r"(NT * nb) : "memory");
#pragma unroll
      for (int t = 0; t < NT; ++t)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];"
            :: "r"(smem_u32(dst + t * share_bytes + b0)),
               "l"(reinterpret_cast<uint64_t>(src[t] + b0)), "r"(nb),
               "r"(smem_u32(&bars[j]))
            : "memory");
    }
  }
  __syncthreads();
}

// Each barrier completes once (phase 0).
__device__ __forceinline__ void wait_chunk(uint64_t* bar) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(0u) : "memory");
  } while (!done);
}

// A cluster barrier in two halves: arrive once this block reads no other
// block's shared memory any more, wait just before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Sum of one float over the block in a fixed order (warp trees, then the
// warps in order), returned to every thread.  part: blockDim.x/32 floats.
__device__ __forceinline__ float block_total(float v, float* part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) r += part[w];
  __syncthreads();
  return r;
}

// *local of every block of the cluster, added in rank order.
__device__ __forceinline__ float cluster_total(coop::cluster_group& cluster,
                                               float* local) {
  float r = 0.f;
  const int k = static_cast<int>(cluster.num_blocks());
  for (int q = 0; q < k; ++q) r += *cluster.map_shared_rank(local, q);
  return r;
}

// Grid N*G*K, clusters of K: cluster ng owns span ng, block rank r its
// share [r*share, (r+1)*share).  Dynamic shared memory: the share of x,
// then scale and shift of the share's channels.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_fwd_cluster_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ stats, int span, int share, int hw,
                      int cg, int groups, float eps, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ float part[kMaxThreads / 32];
  __shared__ float block_sums[2];  // sum, then M2 of the share: cluster-read

  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ng = blockIdx.x / cluster.num_blocks();
  const int begin = rank * share;
  const int64_t off = static_cast<int64_t>(ng) * span + begin;
  const int share_bytes = share * static_cast<int>(sizeof(T));
  const int nchunks = (share_bytes + kChunkBytes - 1) / kChunkBytes;
  const int nvec = share / VEC;
  const T* buf = reinterpret_cast<const T*>(smem);
  float* coef = reinterpret_cast<float*>(smem + share_bytes);

  const unsigned char* src[1] = {
      reinterpret_cast<const unsigned char*>(x + off)};
  start_bulk_loads<1>(bars, smem, src, share_bytes, nchunks);

  // pass 1 (chunk by chunk, as they arrive): the mean
  float s = 0.f;
  for (int j = 0; j < nchunks; ++j) {
    wait_chunk(&bars[j]);
    const int vend = min(nvec, (j + 1) * kChunkVecs);
    for (int v = j * kChunkVecs + threadIdx.x; v < vend; v += blockDim.x) {
      float e[VEC];
      load_vec<T, VEC>(buf + v * VEC, e);
#pragma unroll
      for (int k = 0; k < VEC; ++k) s += e[k];
    }
  }
  const float bsum = block_total(s, part);
  if (threadIdx.x == 0) block_sums[0] = bsum;
  cluster.sync();
  const float mean =
      cluster_total(cluster, &block_sums[0]) / static_cast<float>(span);

  // pass 2: the centred sum of squares
  float m2 = 0.f;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float e[VEC];
    load_vec<T, VEC>(buf + v * VEC, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = e[k] - mean;
      m2 = fmaf(d, d, m2);
    }
  }
  const float bm2 = block_total(m2, part);
  if (threadIdx.x == 0) block_sums[1] = bm2;
  cluster.sync();
  const float rstd = rsqrtf(
      cluster_total(cluster, &block_sums[1]) / static_cast<float>(span) + eps);
  cluster_arrive();

  // pass 3: y from shared memory
  const int c_first = begin / hw;
  const int nch = (begin + share - 1) / hw - c_first + 1;
  const int c0 = (ng % groups) * cg + c_first;
  for (int c = threadIdx.x; c < nch; c += blockDim.x) {
    const float sc = gamma[c0 + c] * rstd;
    coef[c] = sc;
    coef[nch + c] = beta[c0 + c] - mean * sc;
  }
  __syncthreads();
  if (stats != nullptr && rank == 0 && threadIdx.x == 0) {
    stats[2 * ng] = mean;
    stats[2 * ng + 1] = rstd;
  }
  T* yb = y + off;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int c = (begin + v * VEC) / hw - c_first;
    const float sc = coef[c];
    const float sh = coef[nch + c];
    float e[VEC];
    load_vec<T, VEC>(buf + v * VEC, e);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float t = fmaf(e[k], sc, sh);
      e[k] = relu ? fmaxf(t, 0.f) : t;
    }
    store_vec<T, VEC>(yb + v * VEC, e);
  }
  cluster_wait();
}

// Grid and clusters as the forward.  Dynamic shared memory: the shares of
// dy (masked in place) and x, then per-thread channel partials
// [cg][blockDim.x], this block's per-channel sums [cg] (cluster-read) and
// the span's [cg], each (sum dy, sum dy*xhat).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gn_bwd_cluster_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const T* __restrict__ out,
                      const float* __restrict__ gamma,
                      const float* __restrict__ stats,
                      float* __restrict__ sums, T* __restrict__ dx, int span,
                      int share, int hw, int cg, int groups, int relu) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];

  coop::cluster_group cluster = coop::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ng = blockIdx.x / k;
  const int c0 = (ng % groups) * cg;
  const int begin = rank * share;
  const int64_t off = static_cast<int64_t>(ng) * span + begin;
  const int share_bytes = share * static_cast<int>(sizeof(T));
  const int nchunks = (share_bytes + kChunkBytes - 1) / kChunkBytes;
  const int nvec = share / VEC;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  T* sdy = reinterpret_cast<T*>(smem);
  const T* sx = reinterpret_cast<const T*>(smem + share_bytes);
  float2* part = reinterpret_cast<float2*>(smem + 2 * share_bytes);
  float2* csum = part + cg * nt;
  float2* chan = csum + cg;
  const float mean = stats[2 * ng];
  const float rstd = stats[2 * ng + 1];

  for (int c = 0; c < cg; ++c) part[c * nt + tid] = make_float2(0.f, 0.f);
  for (int c = tid; c < cg; c += nt) csum[c] = make_float2(0.f, 0.f);
  const unsigned char* src[2] = {
      reinterpret_cast<const unsigned char*>(dy + off),
      reinterpret_cast<const unsigned char*>(x + off)};
  start_bulk_loads<2>(bars, smem, src, share_bytes, nchunks);

  // pass 1 (chunk by chunk): mask dy by out > 0, keep it, and sum dy and
  // dy*xhat per channel.  out comes from device memory, kOutBatch vectors
  // a thread in flight at once.  A thread's vectors rise, so its channel
  // never falls: it keeps one running pair and files it when the channel
  // changes.
  const int c_first = begin / hw;
  const int nch = (begin + share - 1) / hw - c_first + 1;
  const uint4* ob = reinterpret_cast<const uint4*>(out + off);
  int cur = 0;
  float a = 0.f, b = 0.f;
  for (int j = 0; j < nchunks; ++j) {
    wait_chunk(&bars[j]);
    const int vend = min(nvec, (j + 1) * kChunkVecs);
    for (int v0 = j * kChunkVecs + tid; v0 < vend; v0 += kOutBatch * nt) {
      uint4 oraw[kOutBatch];
#pragma unroll
      for (int u = 0; u < kOutBatch; ++u) {
        const int v = v0 + u * nt;
        if (relu && v < vend) oraw[u] = ob[v];
      }
#pragma unroll
      for (int u = 0; u < kOutBatch; ++u) {
        const int v = v0 + u * nt;
        if (v >= vend) break;
        const int c = (begin + v * VEC) / hw - c_first;
        if (c != cur) {
          part[cur * nt + tid] = make_float2(a, b);
          a = b = 0.f;
          cur = c;
        }
        float d[VEC], xv[VEC];
        load_vec<T, VEC>(sdy + v * VEC, d);
        load_vec<T, VEC>(sx + v * VEC, xv);
        if (relu) {
          float o[VEC];
          load_vec<T, VEC>(reinterpret_cast<const T*>(&oraw[u]), o);
#pragma unroll
          for (int q = 0; q < VEC; ++q) d[q] = o[q] > 0.f ? d[q] : 0.f;
          store_vec<T, VEC>(sdy + v * VEC, d);
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          a += d[q];
          b = fmaf(d[q], (xv[q] - mean) * rstd, b);
        }
      }
    }
  }
  part[cur * nt + tid] = make_float2(a, b);
  __syncthreads();

  // per channel of the share: warp w takes channels w, w + warps, ...;
  // lanes add the threads' partials in order, then a shuffle tree
  const int lane = tid & 31;
  for (int c = tid >> 5; c < nch; c += nt >> 5) {
    float sa = 0.f, sb = 0.f;
    for (int t = lane; t < nt; t += 32) {
      const float2 p = part[c * nt + t];
      sa += p.x;
      sb += p.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sa += __shfl_down_sync(0xffffffffu, sa, o);
      sb += __shfl_down_sync(0xffffffffu, sb, o);
    }
    if (lane == 0) csum[c_first + c] = make_float2(sa, sb);
  }
  cluster.sync();
  // the span's per-channel sums: the K blocks' in rank order
  for (int c = tid; c < cg; c += nt) {
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < k; ++q) {
      const float2 p = *cluster.map_shared_rank(&csum[c], q);
      sa += p.x;
      sb += p.y;
    }
    chan[c] = make_float2(sa, sb);
    if (rank == 0) {
      float* o = sums + 2 * (static_cast<int64_t>(ng / groups) * groups * cg
                             + c0 + c);
      o[0] = sa;
      o[1] = sb;
    }
  }
  cluster_arrive();
  __syncthreads();
  float a1 = 0.f, a2 = 0.f;
  for (int c = 0; c < cg; ++c) {
    const float gk = gamma[c0 + c];
    a1 = fmaf(gk, chan[c].x, a1);
    a2 = fmaf(gk, chan[c].y, a2);
  }
  const float m1 = a1 / static_cast<float>(span);
  const float m2 = a2 / static_cast<float>(span);

  // pass 2: dx from shared memory
  T* dxb = dx + off;
  for (int v = tid; v < nvec; v += nt) {
    const float gc = gamma[c0 + (begin + v * VEC) / hw];
    float d[VEC], xv[VEC];
    load_vec<T, VEC>(sdy + v * VEC, d);
    load_vec<T, VEC>(sx + v * VEC, xv);
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      const float xhat = (xv[q] - mean) * rstd;
      d[q] = (d[q] * gc - m1 - xhat * m2) * rstd;
    }
    store_vec<T, VEC>(dxb + v * VEC, d);
  }
  cluster_wait();
}

// dgamma, dbeta from the per-(n, c) sums: one warp per channel, lane l
// adds samples l, l+32, ... in order, then a fixed shuffle tree.
constexpr int kParamThreads = 256;

__global__ void __launch_bounds__(kParamThreads)
gn_bwd_param_kernel(const float2* __restrict__ sums,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    int n, int c) {
  const int ch = blockIdx.x * (kParamThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ch >= c) return;  // whole warps
  float sb = 0.f, sg = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float2 q = sums[static_cast<int64_t>(i) * c + ch];
    sb += q.x;
    sg += q.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sb += __shfl_down_sync(0xffffffffu, sb, o);
    sg += __shfl_down_sync(0xffffffffu, sg, o);
  }
  if (lane == 0) {
    dgamma[ch] = sg;
    dbeta[ch] = sb;
  }
}

// The share and dynamic shared memory of a cluster launch (mirrored by
// ops/group_norm.py::cluster_smem and cluster_plan), or false for a shape
// outside the cluster design.
bool cluster_shape(int c, int hw, int groups, int k, int threads,
                   int itemsize, bool bwd, int* share, int* smem) {
  if (groups <= 0 || c % groups != 0 || hw <= 0) return false;
  if (k != 1 && k != 2 && k != 4 && k != 8) return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return false;
  const int cg = c / groups;
  const int span = cg * hw;
  if (span % k != 0 || (hw * itemsize) % 16 != 0) return false;
  *share = span / k;
  const int share_bytes = *share * itemsize;
  if (share_bytes % 16 != 0 || share_bytes > kMaxChunks * kChunkBytes)
    return false;
  *smem = bwd ? 2 * share_bytes + 8 * cg * threads + 16 * cg
              : share_bytes + 8 * cg;
  return true;
}

cudaLaunchConfig_t cluster_config(int spans, int k, int threads, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(spans * k));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(k);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

cudaError_t after_launch(cudaError_t err) {
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_cluster(const void* x, const void* gamma,
                               const void* beta, void* y, void* stats, int n,
                               int c, int hw, int groups, int k, int threads,
                               float eps, int relu, cudaStream_t stream) {
  int share, smem;
  if (!cluster_shape(c, hw, groups, k, threads, sizeof(T), false, &share,
                     &smem))
    return cudaErrorInvalidValue;
  auto kernel = gn_fwd_cluster_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(n * groups, k, threads, smem, stream, attr);
  const int cg = c / groups;
  return after_launch(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y),
      static_cast<float*>(stats), cg * hw, share, hw, cg, groups, eps, relu));
}

template <typename T>
cudaError_t launch_bwd_cluster(const void* dy, const void* x, const void* out,
                               const void* gamma, const void* stats,
                               void* sums, void* dx, void* dgamma,
                               void* dbeta, int n, int c, int hw, int groups,
                               int k, int threads, int relu,
                               cudaStream_t stream) {
  int share, smem;
  if (!cluster_shape(c, hw, groups, k, threads, sizeof(T), true, &share,
                     &smem))
    return cudaErrorInvalidValue;
  auto kernel = gn_bwd_cluster_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(n * groups, k, threads, smem, stream, attr);
  const int cg = c / groups;
  err = after_launch(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<const T*>(out), static_cast<const float*>(gamma),
      static_cast<const float*>(stats), static_cast<float*>(sums),
      static_cast<T*>(dx), cg * hw, share, hw, cg, groups, relu));
  if (err != cudaSuccess) return err;
  const int per_block = kParamThreads / 32;
  gn_bwd_param_kernel<<<(c + per_block - 1) / per_block, kParamThreads, 0,
                        stream>>>(static_cast<const float2*>(sums),
                                  static_cast<float*>(dgamma),
                                  static_cast<float*>(dbeta), n, c);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int n, int groups, int k, int threads,
                      int smem, int* clusters) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(n * groups, k, threads, smem, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace

// The streaming forward.  dtype: 0 = float32, 1 = bfloat16.  vec: elements
// per access, either 16 / itemsize (16-byte aligned tensors, hw a multiple
// of it) or 1.  stats: null, or N*G*2 floats that receive each span's
// (mean, rstd).
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int pdac_group_norm_relu(const void* x, const void* gamma,
                                    const void* beta, void* y,
                                    void* partials, void* stats, int n, int c,
                                    int hw, int groups, int splits, int chunk,
                                    float eps, int relu, int dtype, int vec,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PDAC_GN_FWD(T, V)                                                 \
  return launch_streaming<T, V>(x, gamma, beta, y, partials, stats, n, c, \
                                hw, groups, splits, chunk, eps, relu, st)
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

// The streaming backward.  dy, x, out and dx share x's dtype and layout;
// gamma, dgamma, dbeta are (C,) float32; stats is the forward's (mean,
// rstd) per (n, g); sums is scratch of N*C*2 floats.  splits/chunk come
// from the streaming launch plan.
extern "C" int pdac_group_norm_relu_bwd(const void* dy, const void* x,
                                        const void* out, const void* gamma,
                                        const void* stats, void* sums,
                                        void* dx, void* dgamma, void* dbeta,
                                        int n, int c, int hw, int groups,
                                        int splits, int chunk, int relu,
                                        int dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PDAC_GN_BWD(T, V)                                                 \
  return launch_bwd_streaming<T, V>(dy, x, out, gamma, stats, sums, dx,   \
                                    dgamma, dbeta, n, c, hw, groups,      \
                                    splits, chunk, relu, st)
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

// The cluster forward: clusters of `cluster` blocks of `threads` threads,
// one per (n, g) span; 16-byte aligned tensors with hw*itemsize a multiple
// of 16 (the launch plan checks).  Returns the launch's cudaError (0 on
// success).
extern "C" int pdac_gn_fwd_cluster(const void* x, const void* gamma,
                                   const void* beta, void* y, void* stats,
                                   int n, int c, int hw, int groups,
                                   int cluster, int threads, float eps,
                                   int relu, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_cluster<float>(x, gamma, beta, y, stats, n, c, hw,
                                     groups, cluster, threads, eps, relu, st);
  if (dtype == 1)
    return launch_fwd_cluster<__nv_bfloat16>(x, gamma, beta, y, stats, n, c,
                                             hw, groups, cluster, threads,
                                             eps, relu, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster backward and its dgamma/dbeta reduction: two launches.
// sums is scratch of N*C*2 floats.
extern "C" int pdac_gn_bwd_cluster(const void* dy, const void* x,
                                   const void* out, const void* gamma,
                                   const void* stats, void* sums, void* dx,
                                   void* dgamma, void* dbeta, int n, int c,
                                   int hw, int groups, int cluster,
                                   int threads, int relu, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_cluster<float>(dy, x, out, gamma, stats, sums, dx,
                                     dgamma, dbeta, n, c, hw, groups,
                                     cluster, threads, relu, st);
  if (dtype == 1)
    return launch_bwd_cluster<__nv_bfloat16>(dy, x, out, gamma, stats, sums,
                                             dx, dgamma, dbeta, n, c, hw,
                                             groups, cluster, threads, relu,
                                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaOccupancyMaxActiveClusters of a cluster launch (bwd: 0 forward, 1
// backward) into *clusters; returns its cudaError.
extern "C" int pdac_gn_cluster_occupancy(int bwd, int dtype, int n, int c,
                                         int hw, int groups, int cluster,
                                         int threads, int* clusters) {
  const int itemsize = dtype == 0 ? 4 : 2;
  int share, smem;
  if ((dtype != 0 && dtype != 1)
      || !cluster_shape(c, hw, groups, cluster, threads, itemsize, bwd != 0,
                        &share, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bwd) {
    if (dtype == 0)
      return occupancy(gn_bwd_cluster_kernel<float>, n, groups, cluster,
                       threads, smem, clusters);
    return occupancy(gn_bwd_cluster_kernel<__nv_bfloat16>, n, groups,
                     cluster, threads, smem, clusters);
  }
  if (dtype == 0)
    return occupancy(gn_fwd_cluster_kernel<float>, n, groups, cluster,
                     threads, smem, clusters);
  return occupancy(gn_fwd_cluster_kernel<__nv_bfloat16>, n, groups, cluster,
                   threads, smem, clusters);
}
