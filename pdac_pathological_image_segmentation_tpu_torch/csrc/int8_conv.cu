// int8 convolution with int32 accumulation and a dequantizing epilogue, for
// Hopper (sm_90a), NHWC.
//
// Replaces no TPU kernel: the JAX package leaves its int8 convolutions to
// XLA (`infer/quantized.py::_Ctx.conv`, `conv_general_dilated(...,
// preferred_element_type=int32)` with the dequantize and what follows fused
// into the convolution's epilogue).  PyTorch has no int8 convolution on
// CUDA, so the port's int8 serving path (`infer/quantized.py`) runs every
// quantized site through this kernel.
//
// What it computes, per output element (n, oh, ow, f):
//   acc = sum_{kh, kw, c} x[n, oh*s - p + kh*d, ow*s - p + kw*d, c] * w[f, kh, kw, c]
//         (int8 operands, zero padding, int32 sums: exact)
//   y   = float(acc) * (sx * sw[f])            the product sx * sw[f] first
//   y   = y * a[f]                             optional (a BN fold)
//   y   = y + b[f]                             optional (a BN fold or bias),
//                                              before or after the residual
//   y   = y + r[n, oh, ow, f]                  optional residual: int8 (times
//                                              its scale), bf16 or f32, NHWC
//   y   = y > 0 ? y : 0                        optional ReLU
// stored as int8 requantized with the consumer's scale
// (clip(round_half_even(y / so), -127, 127)), bf16, f32, or the raw int32
// sums, in NHWC or NCHW.  Every multiply, add and divide of the epilogue is
// an IEEE round-to-nearest intrinsic, so nvcc contracts nothing into an FMA
// and the result equals the plain version (`ops/int8_conv.py`) bitwise.
//
// What bounds each kind of site on the card (FPN/resnet18 at 512², batch
// 32): at K = 64 (the laterals and layer1's 1x1 downsample) bytes, above
// all the stores: lateral2 writes 268 MB of bf16 for 2.2 GMAC, 80 us at
// 3.35 TB/s against 2.2 us of int8 peak; at K = 2,304-4,608 (layer3/4's
// 3x3 convs) the main loop: layer4's conv2 is 19 GMAC, 19 us at 1,979
// TOP/s, against 10 MB of operands.  So the design keeps the tensor cores
// fed from a deep ring and writes the epilogue as wide, coalesced stores:
//
//   * GEMM view: M = N*OH*OW output pixels, N = F output channels, K =
//     KH*KW*C, both operands K-major.  A block tile is 128 pixels x BN
//     channels, BN = 64, 128 or 256 (the smallest that covers F, 256 for F
//     = 512, which takes two N tiles), so the activation is gathered once
//     per M tile for every F <= 256.
//   * Main loop: two consumer warpgroups, each 64 pixels x BN, issue
//     wgmma.mma_async m64nBNk32 s8.s8 -> s32 from shared memory, A and B
//     both K-major in 64-byte rows with the 64-byte swizzle (a K step is
//     64 bytes, so the K = 64 sites take one step), two wgmmas a step.  One
//     wgmma group stays in flight: a stage is released when the next one's
//     wgmmas are issued.
//   * An asynchronous ring of 8 stages, filled by a producer warpgroup and
//     tracked by mbarriers (full: 128 cp.async arrivals and the TMA's
//     bytes; empty: one arrival a consumer warp).  There is no block
//     barrier in the main loop.  The weights, a plain 2-D (F, K) int8
//     matrix, come by TMA (cp.async.bulk.tensor.2d, 64-byte swizzle, zeros
//     past F and K), encoded on the host with cuTensorMapEncodeTiled
//     reached through cudaGetDriverEntryPoint (no -lcuda).  The activations
//     are the implicit-GEMM gather as 16-byte cp.async pieces (16 channels
//     of one tap), four neighbouring producer threads on one pixel's 64
//     bytes of a K step so that a warp reads whole sectors, zero-filling
//     padding, rows past M and K past its end, completing on the stage's
//     mbarrier with cp.async.mbarrier.arrive.noinc.  cp.async and not
//     TMA's im2col mode: one code path serves every stride, padding and
//     dilation and a tap that straddles a K step, and the gather's address
//     arithmetic stays on the producer warpgroup.
//   * A persistent schedule: the grid is at most the SM count, and each
//     block walks tiles t = blockIdx.x, + gridDim.x, ... (N tile fastest).
//     The producer runs ahead through the ring into the next tiles while
//     the consumers run a tile's epilogue.
//   * The epilogue, staged through shared memory 32 columns at a time (16
//     values a thread, so that BN = 256's 128 accumulators leave room): the
//     tile's s = sx*sw[f], a[f] and b[f] sit in shared memory; the residual
//     is read into the staging buffer with 16-byte loads along NHWC rows;
//     the dequantize, affine, residual and ReLU run in registers, each step
//     over all 16 values; the outputs are staged and written with 16-byte
//     stores, along F for NHWC, and for NCHW (FPN's seg convs, f32 for
//     GroupNorm) along pixels of one channel, from a column-major staging.
//     The int32 -> float conversion and the int8 requantize's rounding are
//     full-rate ALU work (magic-number adds) with the exact conversion and
//     division kept for the values where those could differ; the results
//     are the same bits.
//   * The stem (C = 3, 7x7/2): the quantize kernel writes its input space
//     to depth, 2x2 pixels x 4 channels (a zero fourth, and zeros past an
//     odd edge) as 16 contiguous bytes, and the caller rearranges the
//     weights to match (ops/int8_conv.py::space_to_depth_weights): a 4x4/1
//     convolution with 16-byte taps on the one gather path, with no
//     byte-by-byte gather (and no divide per byte).  A zero tap adds
//     nothing, so the sums are those of the 3-channel convolution.  Chosen
//     over staging an input halo in shared memory: it needs no bound on the
//     image width and no second gather design.  So every input the kernel
//     takes has C a multiple of 16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels of a tile
constexpr int kBK = 64;         // bytes of K a stage (one swizzled row)
constexpr int kConsumers = 2;   // consumer warpgroups, 64 pixels each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kChunk = 32;      // epilogue columns staged at a time
constexpr int kValues = kChunk / 2;  // of them a consumer thread holds
// a staged chunk: 64 rows of up to 4 bytes a value, or 32 columns of 64
constexpr int kStagingBytes = 64 * (kChunk * 4 + 32);

enum Dtype { kNone = 0, kInt8 = 1, kBf16 = 2, kF32 = 3, kInt32 = 4 };

struct Params {
  const int8_t* x;  // (N, H, W, C)
  const float* sw;  // (F,)
  const float* a;   // (F,) or null
  const float* b;   // (F,) or null
  const void* res;  // (N, OH, OW, F) or null
  void* out;
  int n, h, wd, c, f, kh, kw, stride, pad, dil, oh, ow, m, k;
  int tiles_n, tiles;
  float sx, res_scale, out_scale;
  int res_type, out_type, bias_last, relu, nchw;
};

template <int BN>
struct Layout {
  static constexpr int kStages = 8;
  static constexpr int kA = kBM * kBK;
  static constexpr int kB = BN * kBK;
  static constexpr int kOffB = kStages * kA;
  static constexpr int kOffStaging = kOffB + kStages * kB;
  static constexpr int kOffVec = kOffStaging + kConsumers * kStagingBytes;
  static constexpr int kOffBar = kOffVec + kConsumers * 3 * BN * 4;
  // 1024 bytes of slack to align the base for the swizzle
  static constexpr int kBytes = kOffBar + 2 * kStages * 8 + 1024;
};


__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers, cp.async, TMA -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The executing thread's earlier cp.asyncs arrive on bar when they land.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes 0 zero-fills the 16 bytes at dst
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// -- wgmma ----------------------------------------------------------------------

// A K-major operand in 64-byte rows with the 64-byte swizzle: 8-row groups
// 512 bytes apart (SBO), the leading offset unused (1), layout type 2.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<uint64_t>((a & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accumulator accesses across a wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// m64n64k32: 32 int32 accumulators a thread
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n128k32: 64 int32 accumulators a thread
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// m64n256k32: 128 int32 accumulators a thread
__device__ __forceinline__ void wgmma_n256(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}


template <int BN>
__device__ __forceinline__ void wgmma_step(int* d, uint64_t a, uint64_t b,
                                           int accumulate) {
  if constexpr (BN == 64) {
    wgmma_n64(d, a, b, accumulate);
  } else if constexpr (BN == 128) {
    wgmma_n128(d, a, b, accumulate);
  } else {
    wgmma_n256(d, a, b, accumulate);
  }
}

// -- the producer -----------------------------------------------------------------

// The 16-byte gather: producer thread t copies K chunk t % 4 (16 bytes) of
// pixel rows t / 4 + 32 j, j = 0..3, so that four neighbouring lanes copy
// one pixel's 64 contiguous bytes of a K step and a warp instruction reads
// 8 whole pixels' worth of sectors.  All four of a thread's pixels sit at
// the same K offset, so one running tap (c, kw, kh) serves them.
struct Gather16 {
  int base[4];  // element offset of the pixel's image in x
  int ih0[4];   // input origin; a row past M gets an origin never inside
  int iw0[4];
  int c, kw, kh;

  __device__ __forceinline__ void init(const Params& p, int m0, int tid) {
    const int ohw = p.oh * p.ow;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + (tid >> 2) + 32 * j;
      const bool ok = m < p.m;
      const int mm = ok ? m : 0;
      const int img = mm / ohw;
      const int rem = mm - img * ohw;
      const int oh = rem / p.ow;
      base[j] = img * p.h * p.wd * p.c;
      ih0[j] = ok ? oh * p.stride - p.pad : -(1 << 29);
      iw0[j] = (rem - oh * p.ow) * p.stride - p.pad;
    }
    const int kb = (tid & 3) * 16;
    const int tap = kb / p.c;
    c = kb - tap * p.c;
    kh = tap / p.kw;
    kw = tap - kh * p.kw;
  }

  __device__ __forceinline__ void issue(const Params& p, uint32_t stage,
                                        int kt, int tid) {
    const bool kin = kt * kBK + (tid & 3) * 16 < p.k;
    const uint32_t dst = stage + (tid >> 2) * kBK +
                         (((tid & 3) ^ ((tid >> 3) & 3)) << 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ih = ih0[j] + kh * p.dil;
      const int iw = iw0[j] + kw * p.dil;
      const bool in = kin && ih >= 0 && ih < p.h && iw >= 0 && iw < p.wd;
      const int8_t* src = in ? p.x + base[j] + (ih * p.wd + iw) * p.c + c
                             : p.x;
      cp_async16(dst + j * 32 * kBK, src, in ? 16 : 0);
    }
    // this thread's chunk of the next K step, 64 bytes on
    c += kBK;
    while (c >= p.c) {
      c -= p.c;
      if (++kw == p.kw) {
        kw = 0;
        ++kh;
      }
    }
  }
};

// -- the epilogue -----------------------------------------------------------------

__device__ __forceinline__ int row_stride(int bytes) {
  // row-major staging of a chunk (NHWC): pads that keep the fragment
  // stores free of bank conflicts and rows 16-byte aligned
  return bytes == 1 ? 48 : (bytes == 2 ? 144 : 160);
}

__device__ __forceinline__ int col_stride(int bytes) {
  // column-major staging of a chunk (NCHW): 64 rows a column, padded
  return 64 * bytes + 16;
}

__device__ __forceinline__ int dtype_bytes(int t) {
  return t == kInt8 ? 1 : (t == kBf16 ? 2 : 4);
}

__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           int bytes) {
  if (bytes == 1) {
    *dst = *src;
  } else if (bytes == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  } else {
    *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src);
  }
}

// f[i] = float(v[i]) exactly as __int2float_rn: through the magic-number
// add where every |v| < 2^22 (exact there, and full-rate ALU work, where
// I2F is a quarter-rate conversion), else I2F.
__device__ __forceinline__ void to_float(const int* v, float* f) {
  bool big = false;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    big |= v[i] >= (1 << 22) || v[i] < -(1 << 22);
  }
  if (!big) {
#pragma unroll
    for (int i = 0; i < kValues; ++i) {
      f[i] = __fsub_rn(__int_as_float(0x4B400000 + v[i]), 12582912.f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kValues; ++i) f[i] = __int2float_rn(v[i]);
  }
}

__device__ __forceinline__ float int8_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.f);
}

// q[i] = clip(round_half_even(y[i] / s), -127, 127), equal bit for bit to
// the per-value __float2int_rn(__fdiv_rn(y, s)) chain.  t = RN(y RN(1/s))
// is within 2^-15 + 2^-17 of RN(y / s) where |t| < 256, so the two round
// to the same integer unless t lies within 2^-14 of a half-integer; past
// 256 both clip.  Those rare values (about one in 8,192) and NaN take the
// division, each alone.  The common path is full-rate ALU work (the
// rounding by the 1.5 * 2^23 add) with no branch, which the compiler
// interleaves across the values.
__device__ __forceinline__ void requantize(const float* y, float rs, float s,
                                           int* q) {
  uint32_t exact = 0;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    const float t = __fmul_rn(y[i], rs);
    const float tc = fminf(fmaxf(t, -256.f), 256.f);
    const float u = __fadd_rn(tc, 12582912.f);
    const float k = __fsub_rn(u, 12582912.f);
    const bool near = 0.5f - fabsf(__fsub_rn(tc, k)) <= 0x1p-14f;
    exact |= static_cast<uint32_t>(near || t != t) << i;
    const int v = __float_as_int(u) - 0x4B400000;
    q[i] = v < -127 ? -127 : (v > 127 ? 127 : v);
  }
  if (exact == 0) return;
#pragma unroll
  for (int i = 0; i < kValues; ++i) {
    if (exact & (1u << i)) {
      const int v = __float2int_rn(__fdiv_rn(y[i], s));
      q[i] = v < -127 ? -127 : (v > 127 ? 127 : v);
    }
  }
}

// The accumulators of chunk cc (16 a thread: 32 columns of 64 rows) of a
// warpgroup's BN / 2 into cur: the epilogue's body is compiled once and
// not once a chunk, which keeps it inside the instruction cache.
template <int BN>
__device__ __forceinline__ void take_chunk(const int* acc, int cc, int* cur) {
#define PDAC_TAKE(C)                                                \
  case C:                                                           \
    if constexpr ((C + 1) * kChunk <= BN) {                         \
      _Pragma("unroll") for (int i = 0; i < kValues; ++i) cur[i] =  \
          acc[C * kValues + i];                                     \
    }                                                               \
    break;
  switch (cc) {
    PDAC_TAKE(0)
    PDAC_TAKE(1)
    PDAC_TAKE(2)
    PDAC_TAKE(3)
    PDAC_TAKE(4)
    PDAC_TAKE(5)
    PDAC_TAKE(6)
    PDAC_TAKE(7)
  }
#undef PDAC_TAKE
}

// One consumer warpgroup's 64 x BN tile: rows row0.., columns n0..,
// staged 32 columns at a time.  A thread's value i of a chunk (i = 4 j +
// 2 h + e) is row 16 warp + g + 8 h, column 8 j + 2 q + e (the wgmma
// accumulator layout).
template <int BN>
__device__ __forceinline__ void epilogue(const Params& p, const int* acc,
                                         int row0, int n0, uint8_t* stg,
                                         const float* vs, const float* va,
                                         const float* vb, int bar_id) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int ob = dtype_bytes(p.out_type);
  const int rt = p.res_type;
  const float rs = __frcp_rn(p.out_scale);  // for requantize
  uint8_t* out = static_cast<uint8_t*>(p.out);
#pragma unroll 1
  for (int cc = 0; cc < BN / kChunk; ++cc) {
    const int col0 = n0 + cc * kChunk;
    const int nv = min(kChunk, p.f - col0);
    if (nv <= 0) break;  // uniform: the warpgroup's F and n0
    int cur[kValues];
    take_chunk<BN>(acc, cc, cur);
    // column 8 j + 2 q + e of this chunk: value i's factor index
    const float* cs = vs + cc * kChunk + 2 * q;
    const float* ca = va + cc * kChunk + 2 * q;
    const float* cb = vb + cc * kChunk + 2 * q;
    float rv[kValues];
    if (rt != kNone) {
      // the residual's chunk into the staging buffer, 16 bytes a load
      const int rb = dtype_bytes(rt);
      const int sr = row_stride(rb);
      const uint8_t* rbase = static_cast<const uint8_t*>(p.res);
      if (((p.f * rb) & 15) == 0 && ((nv * rb) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(rbase) & 15) == 0) {
        const int ppr = nv * rb / 16;
        for (int i = tid; i < 64 * ppr; i += 128) {
          const int r = i / ppr;
          const int pc = i - r * ppr;
          const int m = row0 + r;
          if (m < p.m) {
            *reinterpret_cast<uint4*>(stg + r * sr + pc * 16) =
                *reinterpret_cast<const uint4*>(
                    rbase + (static_cast<int64_t>(m) * p.f + col0) * rb +
                    pc * 16);
          }
        }
      } else {
        for (int i = tid; i < 64 * nv; i += 128) {
          const int r = i / nv;
          const int ci = i - r * nv;
          const int m = row0 + r;
          if (m < p.m) {
            copy_bytes(stg + r * sr + ci * rb,
                       rbase + (static_cast<int64_t>(m) * p.f + col0 + ci) *
                                   rb,
                       rb);
          }
        }
      }
      named_barrier(bar_id);
      const uint8_t* base = stg + (warp * 16 + g) * sr + 2 * q * rb;
      if (rt == kInt8) {
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          const uint16_t u = *reinterpret_cast<const uint16_t*>(
              base + ((i >> 1) & 1) * 8 * sr + (i >> 2) * 8);
          rv[i] = __fmul_rn(int8_to_float(static_cast<int8_t>(u & 0xff)),
                            p.res_scale);
          rv[i + 1] = __fmul_rn(int8_to_float(static_cast<int8_t>(u >> 8)),
                                p.res_scale);
        }
      } else if (rt == kBf16) {
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
              base + ((i >> 1) & 1) * 8 * sr + (i >> 2) * 16);
          rv[i] = __uint_as_float(u << 16);
          rv[i + 1] = __uint_as_float(u & 0xffff0000u);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          const float2 u = *reinterpret_cast<const float2*>(
              base + ((i >> 1) & 1) * 8 * sr + (i >> 2) * 32);
          rv[i] = u.x;
          rv[i + 1] = u.y;
        }
      }
      named_barrier(bar_id);
    }
    // the dequantize and what follows, each step over the values
    float y[kValues];
    to_float(cur, y);
#pragma unroll
    for (int i = 0; i < kValues; ++i) {
      y[i] = __fmul_rn(y[i], cs[(i >> 2) * 8 + (i & 1)]);
    }
    if (p.a != nullptr) {
#pragma unroll
      for (int i = 0; i < kValues; ++i) {
        y[i] = __fmul_rn(y[i], ca[(i >> 2) * 8 + (i & 1)]);
      }
    }
    if (p.b != nullptr && !p.bias_last) {
#pragma unroll
      for (int i = 0; i < kValues; ++i) {
        y[i] = __fadd_rn(y[i], cb[(i >> 2) * 8 + (i & 1)]);
      }
    }
    if (rt != kNone) {
#pragma unroll
      for (int i = 0; i < kValues; ++i) y[i] = __fadd_rn(y[i], rv[i]);
    }
    if (p.b != nullptr && p.bias_last) {
#pragma unroll
      for (int i = 0; i < kValues; ++i) {
        y[i] = __fadd_rn(y[i], cb[(i >> 2) * 8 + (i & 1)]);
      }
    }
    if (p.relu) {
#pragma unroll
      for (int i = 0; i < kValues; ++i) y[i] = y[i] > 0.f ? y[i] : 0.f;
    }
    // staged: row-major for NHWC, column-major for NCHW
    if (!p.nchw) {
      const int so = row_stride(ob);
      uint8_t* base = stg + (warp * 16 + g) * so + 2 * q * ob;
#define PDAC_AT(i) (base + (((i) >> 1) & 1) * 8 * so + ((i) >> 2) * 8 * ob)
      if (p.out_type == kInt32) {
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          *reinterpret_cast<int2*>(PDAC_AT(i)) = make_int2(cur[i], cur[i + 1]);
        }
      } else if (p.out_type == kF32) {
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          *reinterpret_cast<float2*>(PDAC_AT(i)) = make_float2(y[i], y[i + 1]);
        }
      } else if (p.out_type == kBf16) {
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          // one packed conversion, round to nearest each
          *reinterpret_cast<__nv_bfloat162*>(PDAC_AT(i)) =
              __floats2bfloat162_rn(y[i], y[i + 1]);
        }
      } else {
        int qv[kValues];
        requantize(y, rs, p.out_scale, qv);
#pragma unroll
        for (int i = 0; i < kValues; i += 2) {
          *reinterpret_cast<uint16_t*>(PDAC_AT(i)) =
              static_cast<uint16_t>((qv[i] & 0xff) | ((qv[i + 1] & 0xff) << 8));
        }
      }
#undef PDAC_AT
    } else {
      const int so = col_stride(ob);
      uint8_t* base = stg + 2 * q * so + (warp * 16 + g) * ob;
#define PDAC_AT(i) \
  (base + (((i) >> 2) * 8 + ((i) & 1)) * so + (((i) >> 1) & 1) * 8 * ob)
      if (p.out_type == kInt32) {
#pragma unroll
        for (int i = 0; i < kValues; ++i) {
          *reinterpret_cast<int*>(PDAC_AT(i)) = cur[i];
        }
      } else if (p.out_type == kF32) {
#pragma unroll
        for (int i = 0; i < kValues; ++i) {
          *reinterpret_cast<float*>(PDAC_AT(i)) = y[i];
        }
      } else if (p.out_type == kBf16) {
#pragma unroll
        for (int i = 0; i < kValues; ++i) {
          *reinterpret_cast<__nv_bfloat16*>(PDAC_AT(i)) =
              __float2bfloat16_rn(y[i]);
        }
      } else {
        int qv[kValues];
        requantize(y, rs, p.out_scale, qv);
#pragma unroll
        for (int i = 0; i < kValues; ++i) {
          *reinterpret_cast<int8_t*>(PDAC_AT(i)) = static_cast<int8_t>(qv[i]);
        }
      }
#undef PDAC_AT
    }
    named_barrier(bar_id);
    if (!p.nchw) {
      const int so = row_stride(ob);
      if (((p.f * ob) & 15) == 0 && ((nv * ob) & 15) == 0) {
        const int ppr = nv * ob / 16;
        for (int i = tid; i < 64 * ppr; i += 128) {
          const int r = i / ppr;
          const int pc = i - r * ppr;
          const int m = row0 + r;
          if (m < p.m) {
            *reinterpret_cast<uint4*>(
                out + (static_cast<int64_t>(m) * p.f + col0) * ob + pc * 16) =
                *reinterpret_cast<const uint4*>(stg + r * so + pc * 16);
          }
        }
      } else {
        for (int i = tid; i < 64 * nv; i += 128) {
          const int r = i / nv;
          const int ci = i - r * nv;
          const int m = row0 + r;
          if (m < p.m) {
            copy_bytes(out + (static_cast<int64_t>(m) * p.f + col0 + ci) * ob,
                       stg + r * so + ci * ob, ob);
          }
        }
      }
    } else {
      const int so = col_stride(ob);
      const int ohw = p.oh * p.ow;
      const int img = row0 / ohw;
      const int p0 = row0 - img * ohw;
      if (row0 + 64 <= p.m && p0 + 64 <= ohw && ((ohw * ob) & 15) == 0 &&
          ((p0 * ob) & 15) == 0) {
        // 16 bytes of one channel's contiguous pixels a thread
        const int ppc = 64 * ob / 16;
        for (int i = tid; i < nv * ppc; i += 128) {
          const int ci = i / ppc;
          const int pc = i - ci * ppc;
          *reinterpret_cast<uint4*>(
              out + ((static_cast<int64_t>(img) * p.f + col0 + ci) * ohw +
                     p0) * ob + pc * 16) =
              *reinterpret_cast<const uint4*>(stg + ci * so + pc * 16);
        }
      } else {
        for (int i = tid; i < 64 * nv; i += 128) {
          const int ci = i / 64;
          const int r = i - ci * 64;
          const int m = row0 + r;
          if (m < p.m) {
            const int n = m / ohw;
            copy_bytes(out + ((static_cast<int64_t>(n) * p.f + col0 + ci) *
                                  ohw + (m - n * ohw)) * ob,
                       stg + ci * so + r * ob, ob);
          }
        }
      }
    }
    named_barrier(bar_id);  // the staging buffer is free again
  }
}

// -- the kernel ---------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap wmap,
                     const Params p) {
  using L = Layout<BN>;
  constexpr int kStages = L::kStages;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + L::kOffB;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* empty = full + kStages;
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int ktiles = (p.k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128 + 1);       // producer threads + the TMA
      mbar_init(&empty[s], kConsumers * 4);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // == the producer warpgroup ==
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      const int m0 = (t / p.tiles_n) * kBM;
      const int n0 = (t % p.tiles_n) * BN;
      Gather16 g16;
      g16.init(p, m0, tid);
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        if (tid == 0) {
          mbar_expect_tx(&full[s], BN * kBK);
          tma_load_2d(sb + s * L::kB, &wmap, kt * kBK, n0, &full[s]);
        }
        g16.issue(p, smem_addr(sa + s * L::kA), kt, tid);
        cp_async_arrive(&full[s]);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // == a consumer warpgroup: pixels [64 wg, 64 wg + 64) of each tile ==
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    uint8_t* stg = smem + L::kOffStaging + wg * kStagingBytes;
    float* vs = reinterpret_cast<float*>(smem + L::kOffVec) + wg * 3 * BN;
    float* va = vs + BN;
    float* vb = va + BN;
    const int bar_id = 1 + wg;
    const int lane = tid & 31;
    int vec_n0 = -1;
    int acc[BN / 2];
    int seq = 0;  // the tile's place in the block's walk
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x, ++seq) {
      const int m0 = (t / p.tiles_n) * kBM;
      const int n0 = (t % p.tiles_n) * BN;
      int prev = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        // the stage and phase of step kt: the producer fills the ring in
        // the walk's order, ktiles steps a tile
        const int idx = seq * ktiles + kt;
        const int s = idx % kStages;
        mbar_wait(&full[s], (idx / kStages) & 1);
        // the cp.async (generic proxy) writes, seen by wgmma (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint64_t da = smem_desc(sa + s * L::kA + wg * 64 * kBK);
        const uint64_t db = smem_desc(sb + s * L::kB);
        fence_acc<BN / 2>(acc);
        wgmma_fence();
        wgmma_step<BN>(acc, da, db, kt > 0);
        wgmma_step<BN>(acc, da + 2, db + 2, 1);  // the second 32 bytes of K
        wgmma_commit();
        fence_acc<BN / 2>(acc);
        if (kt > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc<BN / 2>(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      if (n0 != vec_n0) {
        // the tile's per-channel factors: s = sx * sw[f], a[f], b[f]
        for (int i = tid; i < BN; i += 128) {
          const int f = n0 + i;
          const bool in = f < p.f;
          vs[i] = in ? __fmul_rn(p.sx, p.sw[f]) : 0.f;
          va[i] = in && p.a != nullptr ? p.a[f] : 0.f;
          vb[i] = in && p.b != nullptr ? p.b[f] : 0.f;
        }
        named_barrier(bar_id);
        vec_n0 = n0;
      }
      epilogue<BN>(p, acc, m0 + wg * 64, n0, stg, vs, va, vb, bar_id);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

template <int BN>
int launch(const CUtensorMap& map, const Params& p, int sms,
           cudaStream_t stream) {
  constexpr int kBytes = Layout<BN>::kBytes;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const int grid = p.tiles < sms ? p.tiles : sms;
  int8_conv_kernel<BN><<<grid, kThreads, kBytes, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, H, W, C) int8, C a multiple of 16 and x 16-byte aligned; w: the
// weights as (F, K) int8 rows, K = kh*kw*c, 16-byte aligned.  Returns a
// cudaError_t, or 1000 + the CUresult of the tensor map's encoding.
extern "C" int pdac_int8_conv(const void* x, const void* w, const void* sw, const void* a, const void* b,
                              const void* res, void* out, int n, int h,
                              int wd, int c, int f, int kh, int kw,
                              int stride, int pad, int dil, int oh, int ow,
                              float sx, int res_type, float res_scale,
                              int bias_last, int relu, int out_type,
                              float out_scale, int nchw, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.sw = static_cast<const float*>(sw);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.res = res;
  p.out = out;
  p.n = n;
  p.h = h;
  p.wd = wd;
  p.c = c;
  p.f = f;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.dil = dil;
  p.oh = oh;
  p.ow = ow;
  p.m = n * oh * ow;
  p.k = kh * kw * c;
  p.sx = sx;
  p.res_scale = res_scale;
  p.out_scale = out_scale;
  p.res_type = res_type;
  p.out_type = out_type;
  p.bias_last = bias_last;
  p.relu = relu;
  p.nchw = nchw;
  const int bn = f <= 64 ? 64 : (f <= 128 ? 128 : 256);
  p.tiles_n = (f + bn - 1) / bn;
  p.tiles = ((p.m + kBM - 1) / kBM) * p.tiles_n;

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p.k),
                              static_cast<cuuint64_t>(f)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p.k)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult cr = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 1000 + static_cast<int>(cr);

  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return launch<64>(map, p, sms, s);
  if (bn == 128) return launch<128>(map, p, sms, s);
  return launch<256>(map, p, sms, s);
}

