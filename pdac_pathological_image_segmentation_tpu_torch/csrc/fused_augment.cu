// Fused train-time augmentation for Hopper (sm_90a): uint8 NHWC patches ->
// slot-matrix ColorJitter -> ImageNet normalize -> OneOf{hflip, rot90,
// vflip}, written as NCHW bf16 images and float32 masks.
//
// Replaces the Pallas TPU kernel
// pdac_pathological_image_segmentation_tpu/ops/pallas/fused_augment.py::
// _augment_kernel (driven by fused_augment_planar).  Per sample i it
// computes, in this order:
//   1. x = bf16(u8 / 255);
//   2. if ints[i, 4] (j_apply): four slots of
//        x <- clip(bf16(A_s @ x + gamma_s * mean_gray(x)), 0, 1)
//      with f32 products and sums (no FMA contraction: __fmul_rn and
//      __fadd_rn, so the kernel rounds where XLA and the plain version
//      round), mean_gray the 0.299/0.587/0.114 mean of the whole current
//      slot input;
//   3. (x - bf16(mean)) / bf16(std) in bf16, one round after each op;
//   4. out = (exch@)^l T^t(x) (@exch)^r from geom[i] = (t, l, r), as a
//      pure index remap on the store (the TPU kernel's 0/1 MXU matmuls were
//      a Mosaic workaround); the mask rides through the same remap and is
//      written as the float32 of its uint8 value.
//
// What bounds it: memory traffic.  Per 512^2 sample 1 MiB in (image and
// mask) and 2.5 MiB out (bf16 image, f32 mask); the arithmetic is a few
// dozen flops a pixel.
//
// The whole-image means.  Each slot needs the mean of its own input, which
// is the previous slot's rounded and clipped output, and a 512^2 sample
// (1.5 MiB in bf16) does not fit one block's shared memory.  So the kernel
// runs in five passes over a grid of (blocks per sample, N):
//   pass k = 0..3: every block re-derives slots < k per pixel from the
//     uint8 input and the means already known, and writes its partial sums
//     of the slot-k input (3 floats) -- only for samples with j_apply set;
//     the others return at once;
//   pass 4: every block re-derives all four slots and writes the output.
// A block that needs the means of slots < k reduces those slots' partials
// itself, in a fixed order (one warp per (slot, channel): strided lane
// sums, then a fixed shuffle tree).  No atomics: runs repeat bit for bit.
// The extra passes read the uint8 image again (0.75 MiB per jittered
// sample each).  A cluster/DSMEM design that keeps a sample on chip is
// later work.
//
// Plain C interface, loaded with ctypes; runs on the caller's stream and
// allocates nothing (the wrapper passes the partials buffer of
// 4 * N * blocks * 3 floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 16;
constexpr int kPixelsPerBlock = kThreads * kPixelsPerThread;
constexpr int kSlots = 4;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct SampleParams {
  float a[kSlots][9];  // row-major 3x3 per slot
  float gm[kSlots];    // gamma_s * mean_gray of the slot input
};

// x (three bf16-valued floats) through slots [0, nslots).
__device__ __forceinline__ void apply_slots(const SampleParams& p, int nslots,
                                            float& x0, float& x1, float& x2) {
  for (int s = 0; s < nslots; ++s) {
    const float* a = p.a[s];
    float y[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float t = __fadd_rn(__fmul_rn(a[3 * c], x0), __fmul_rn(a[3 * c + 1], x1));
      t = __fadd_rn(t, __fmul_rn(a[3 * c + 2], x2));
      t = __fadd_rn(t, p.gm[s]);
      y[c] = fminf(fmaxf(bf16_round(t), 0.f), 1.f);
    }
    x0 = y[0];
    x1 = y[1];
    x2 = y[2];
  }
}

// Loads the sample's slot matrices and, for slots < nmeans, derives
// gamma_s * mean_gray from the partials of earlier passes.  Ends with a
// __syncthreads(); the result is in shared memory.
__device__ void load_params(SampleParams& sp, const float* __restrict__ a_mats,
                            const float* __restrict__ gammas,
                            const float* __restrict__ partials, int i, int n,
                            int blocks, int nmeans, float inv_hw) {
  __shared__ float totals[kSlots][3];
  const int tid = threadIdx.x;
  if (tid < kSlots * 9) sp.a[tid / 9][tid % 9] = a_mats[i * kSlots * 9 + tid];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int job = warp; job < nmeans * 3; job += kThreads / 32) {
    const int s = job / 3;
    const int c = job % 3;
    const float* p = partials + (static_cast<int64_t>(s) * n + i) * blocks * 3;
    float v = 0.f;
    for (int b = lane; b < blocks; b += 32) v += p[3 * b + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) totals[s][c] = v;
  }
  __syncthreads();
  if (tid < nmeans) {
    const float mu0 = __fmul_rn(totals[tid][0], inv_hw);
    const float mu1 = __fmul_rn(totals[tid][1], inv_hw);
    const float mu2 = __fmul_rn(totals[tid][2], inv_hw);
    float m = __fadd_rn(__fmul_rn(0.299f, mu0), __fmul_rn(0.587f, mu1));
    m = __fadd_rn(m, __fmul_rn(0.114f, mu2));
    sp.gm[tid] = __fmul_rn(gammas[i * kSlots + tid], m);
  }
  __syncthreads();
}

__device__ __forceinline__ float u8_to_unit(uint8_t v) {
  return bf16_round(__fdiv_rn(static_cast<float>(v), 255.f));
}

// pass < 4: partial sums of slot `pass`'s input; pass == 4: the output.
__global__ void __launch_bounds__(kThreads)
augment_kernel(const uint8_t* __restrict__ img, const uint8_t* __restrict__ mask,
               const float* __restrict__ a_mats,
               const float* __restrict__ gammas,
               const int32_t* __restrict__ ints,
               const int32_t* __restrict__ geom,
               __nv_bfloat16* __restrict__ out, float* __restrict__ mout,
               float* __restrict__ partials, int n, int size, int pass) {
  const int i = blockIdx.y;
  const int b = blockIdx.x;
  const int blocks = gridDim.x;
  const bool jitter = ints[i * 8 + 4] == 1;
  if (pass < kSlots && !jitter) return;

  __shared__ SampleParams sp;
  const int hw = size * size;
  const float inv_hw = __fdiv_rn(1.f, static_cast<float>(hw));
  const int nslots = jitter ? (pass < kSlots ? pass : kSlots) : 0;
  load_params(sp, a_mats, gammas, partials, i, n, blocks, nslots, inv_hw);

  const uint8_t* src = img + static_cast<int64_t>(i) * hw * 3;
  const int begin = b * kPixelsPerBlock;
  const int end = min(begin + kPixelsPerBlock, hw);

  if (pass < kSlots) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int p = begin + threadIdx.x; p < end; p += kThreads) {
      float x0 = u8_to_unit(src[3 * p]);
      float x1 = u8_to_unit(src[3 * p + 1]);
      float x2 = u8_to_unit(src[3 * p + 2]);
      apply_slots(sp, nslots, x0, x1, x2);
      s0 += x0;
      s1 += x1;
      s2 += x2;
    }
    // fixed-order block sums: warp trees, then the warps in order
    __shared__ float wsum[kThreads / 32][3];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 += __shfl_down_sync(0xffffffffu, s0, off);
      s1 += __shfl_down_sync(0xffffffffu, s1, off);
      s2 += __shfl_down_sync(0xffffffffu, s2, off);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
      wsum[warp][0] = s0;
      wsum[warp][1] = s1;
      wsum[warp][2] = s2;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t += wsum[w][threadIdx.x];
      partials[((static_cast<int64_t>(pass) * n + i) * blocks + b) * 3 +
               threadIdx.x] = t;
    }
    return;
  }

  const bool t = geom[i * 3] == 1;
  const bool l = geom[i * 3 + 1] == 1;
  const bool r = geom[i * 3 + 2] == 1;
  const float mean_bf[3] = {bf16_round(0.485f), bf16_round(0.456f),
                            bf16_round(0.406f)};
  const float std_bf[3] = {bf16_round(0.229f), bf16_round(0.224f),
                           bf16_round(0.225f)};
  __nv_bfloat16* dst = out + static_cast<int64_t>(i) * 3 * hw;
  float* mdst = mout + static_cast<int64_t>(i) * hw;
  const uint8_t* msrc = mask + static_cast<int64_t>(i) * hw;
  for (int p = begin + threadIdx.x; p < end; p += kThreads) {
    float x[3] = {u8_to_unit(src[3 * p]), u8_to_unit(src[3 * p + 1]),
                  u8_to_unit(src[3 * p + 2])};
    apply_slots(sp, nslots, x[0], x[1], x[2]);
    // source (row, col) -> output (oi, oj): Y = T^t(X), Z = exch^l Y,
    // O = Z exch^r
    const int row = p / size;
    const int col = p - row * size;
    const int yi = t ? col : row;
    const int yj = t ? row : col;
    const int oi = l ? size - 1 - yi : yi;
    const int oj = r ? size - 1 - yj : yj;
    const int64_t o = static_cast<int64_t>(oi) * size + oj;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = bf16_round(__fsub_rn(x[c], mean_bf[c]));
      dst[c * hw + o] = __float2bfloat16_rn(__fdiv_rn(v, std_bf[c]));
    }
    mdst[o] = static_cast<float>(msrc[p]);
  }
}

}  // namespace

// images (N, S, S, 3) uint8, masks (N, S, S) uint8, a_mats (N, 4, 3, 3) f32,
// gammas (N, 4) f32, ints (N, 8) i32, geom (N, 3) i32 -> out (N, 3, S, S)
// bf16, mout (N, S, S) f32; partials: 4 * N * blocks * 3 floats with
// blocks = ceil(S*S / 4096).  Returns cudaGetLastError() after the five
// launches (0 on success).
extern "C" int pdac_fused_augment(const void* images, const void* masks,
                                  const void* a_mats, const void* gammas,
                                  const void* ints, const void* geom,
                                  void* out, void* mout, void* partials,
                                  int n, int size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = size * size;
  const dim3 grid(static_cast<unsigned>((hw + kPixelsPerBlock - 1) /
                                        kPixelsPerBlock),
                  static_cast<unsigned>(n));
  for (int pass = 0; pass <= kSlots; ++pass) {
    augment_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(images), static_cast<const uint8_t*>(masks),
        static_cast<const float*>(a_mats), static_cast<const float*>(gammas),
        static_cast<const int32_t*>(ints), static_cast<const int32_t*>(geom),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(mout),
        static_cast<float*>(partials), n, size, pass);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
