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
// What bounds it on the card: bytes.  At FPN/resnet18's 512² sites and
// batch 32 an int8 site moves more bytes than 1,979 TOP/s takes time to
// multiply (layer1's 3x3 64->64: 2.4 GMAC, 2.4 us of int8 peak, against
// 67 MB of int8 in and out, 20 us at 3.35 TB/s), so the design writes int8
// where the consumer is quantized, one byte an element.
//
// Design (right and simple first): an implicit GEMM, M = N*OH*OW output
// pixels, N = F output channels, K = KH*KW*C, on the tensor cores'
// mma.sync.m16n8k32 s8 x s8 -> s32.  A block of 256 threads (8 warps, 4 x 2,
// each a 32 x 32 tile of 2 x 4 mma tiles) computes a 128 x 64 output tile
// over K in steps of 64, double-buffered in shared memory.  Where C is a
// multiple of 16 (every site but the 3-channel stem) a 16-byte piece of a K
// step is 16 channels of one input pixel: cp.async copies it, zero-filling
// the padding.  Otherwise (the stem, K = 147) each thread gathers its bytes
// one by one.  Rows of 64 + 16 bytes keep the fragment loads free of bank
// conflicts.  wgmma, TMA, a persistent schedule and a staged (coalesced)
// epilogue are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kRow = kBK + 16;  // bytes of one shared-memory row
constexpr int kThreads = 256;

enum Dtype { kNone = 0, kInt8 = 1, kBf16 = 2, kF32 = 3, kInt32 = 4 };

struct Params {
  const int8_t* x;  // (N, H, W, C)
  const int8_t* w;  // (F, KH, KW, C)
  const float* sw;  // (F,)
  const float* a;   // (F,) or null
  const float* b;   // (F,) or null
  const void* res;  // (N, OH, OW, F) or null
  void* out;
  int n, h, wd, c, f, kh, kw, stride, pad, dil, oh, ow, m, k;
  float sx, res_scale, out_scale;
  int res_type, out_type, bias_last, relu, nchw;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  // bytes 0 zero-fills the 16 bytes at dst
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output pixel's input origin.
struct Pixel {
  int n, ih, iw;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int m) {
  Pixel px;
  px.ok = m < p.m;
  const int mm = px.ok ? m : 0;
  const int ohw = p.oh * p.ow;
  px.n = mm / ohw;
  const int rem = mm - px.n * ohw;
  const int oh = rem / p.ow;
  px.ih = oh * p.stride - p.pad;
  px.iw = (rem - oh * p.ow) * p.stride - p.pad;
  return px;
}

// The 16-byte-piece loader (C a multiple of 16): rows tid/4 and tid/4 + 64
// of A, row tid/4 of B, piece tid % 4 of the K step.
__device__ __forceinline__ void load_tile_vec(const Params& p, int8_t* as,
                                              int8_t* bs, int kt,
                                              const Pixel* px, int f0) {
  const int tid = threadIdx.x;
  const int piece = tid & 3;
  const int kb = kt * kBK + piece * 16;
  const bool kin = kb < p.k;
  int kh = 0, kw = 0, c = 0;
  if (kin) {
    const int khkw = kb / p.c;
    c = kb - khkw * p.c;
    kh = khkw / p.kw;
    kw = khkw - kh * p.kw;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (tid >> 2) + r * 64;
    const int8_t* src = p.x;
    int bytes = 0;
    if (kin && px[r].ok) {
      const int ih = px[r].ih + kh * p.dil;
      const int iw = px[r].iw + kw * p.dil;
      if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.wd) {
        src = p.x + ((static_cast<int64_t>(px[r].n) * p.h + ih) * p.wd + iw) *
                        p.c + c;
        bytes = 16;
      }
    }
    cp_async16(as + row * kRow + piece * 16, src, bytes);
  }
  const int fr = tid >> 2;
  const int8_t* src = p.w;
  int bytes = 0;
  if (kin && f0 + fr < p.f) {
    src = p.w + static_cast<int64_t>(f0 + fr) * p.k + kb;
    bytes = 16;
  }
  cp_async16(bs + fr * kRow + piece * 16, src, bytes);
}

// The byte-gather loader (any C): A row tid/2, bytes [32*(tid%2), +32) of
// the K step; B row tid/4, bytes [16*(tid%4), +16).
__device__ __forceinline__ void load_tile_bytes(const Params& p, int8_t* as,
                                                int8_t* bs, int kt,
                                                const Pixel& px, int f0) {
  const int tid = threadIdx.x;
  {
    const int row = tid >> 1;
    const int kb = kt * kBK + (tid & 1) * 32;
    int khkw = kb / p.c;
    int c = kb - khkw * p.c;
    int kh = khkw / p.kw;
    int kw = khkw - kh * p.kw;
    uint32_t words[8];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int v = 0;
      if (px.ok && kb + i < p.k) {
        const int ih = px.ih + kh * p.dil;
        const int iw = px.iw + kw * p.dil;
        if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.wd) {
          v = p.x[((static_cast<int64_t>(px.n) * p.h + ih) * p.wd + iw) * p.c +
                  c];
        }
      }
      const uint32_t byte = static_cast<uint32_t>(v) & 0xffu;
      if ((i & 3) == 0) {
        words[i >> 2] = byte;
      } else {
        words[i >> 2] |= byte << (8 * (i & 3));
      }
      if (++c == p.c) {
        c = 0;
        if (++kw == p.kw) {
          kw = 0;
          ++kh;
        }
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(as + row * kRow + (tid & 1) * 32);
    dst[0] = make_uint4(words[0], words[1], words[2], words[3]);
    dst[1] = make_uint4(words[4], words[5], words[6], words[7]);
  }
  {
    const int fr = tid >> 2;
    const int kb = kt * kBK + (tid & 3) * 16;
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      int v = 0;
      if (f0 + fr < p.f && kb + i < p.k) {
        v = p.w[static_cast<int64_t>(f0 + fr) * p.k + kb + i];
      }
      const uint32_t byte = static_cast<uint32_t>(v) & 0xffu;
      if ((i & 3) == 0) {
        words[i >> 2] = byte;
      } else {
        words[i >> 2] |= byte << (8 * (i & 3));
      }
    }
    *reinterpret_cast<uint4*>(bs + fr * kRow + (tid & 3) * 16) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

__device__ __forceinline__ void compute_tile(const int8_t* as,
                                             const int8_t* bs, int wm, int wn,
                                             int g, int t, int (*acc)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    uint32_t af[2][4];
    uint32_t bf[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* q = as + (wm * 32 + mi * 16 + g) * kRow + ks * 32 + t * 4;
      af[mi][0] = ld32(q);
      af[mi][1] = ld32(q + 8 * kRow);
      af[mi][2] = ld32(q + 16);
      af[mi][3] = ld32(q + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* q = bs + (wn * 32 + ni * 8 + g) * kRow + ks * 32 + t * 4;
      bf[ni][0] = ld32(q);
      bf[ni][1] = ld32(q + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_s8(acc[mi][ni], af[mi], bf[ni]);
      }
    }
  }
}

__device__ __forceinline__ void store_one(const Params& p, int m, int f,
                                          int v) {
  const int64_t nhwc = static_cast<int64_t>(m) * p.f + f;
  int64_t o = nhwc;
  if (p.nchw) {
    const int ohw = p.oh * p.ow;
    const int n = m / ohw;
    o = (static_cast<int64_t>(n) * p.f + f) * ohw + (m - n * ohw);
  }
  if (p.out_type == kInt32) {
    static_cast<int*>(p.out)[o] = v;
    return;
  }
  float y = __fmul_rn(__int2float_rn(v), __fmul_rn(p.sx, p.sw[f]));
  if (p.a != nullptr) y = __fmul_rn(y, p.a[f]);
  if (p.b != nullptr && !p.bias_last) y = __fadd_rn(y, p.b[f]);
  if (p.res_type == kInt8) {
    const int8_t r = static_cast<const int8_t*>(p.res)[nhwc];
    y = __fadd_rn(y, __fmul_rn(__int2float_rn(r), p.res_scale));
  } else if (p.res_type == kBf16) {
    y = __fadd_rn(
        y, __bfloat162float(static_cast<const __nv_bfloat16*>(p.res)[nhwc]));
  } else if (p.res_type == kF32) {
    y = __fadd_rn(y, static_cast<const float*>(p.res)[nhwc]);
  }
  if (p.b != nullptr && p.bias_last) y = __fadd_rn(y, p.b[f]);
  if (p.relu) y = y > 0.f ? y : 0.f;
  if (p.out_type == kInt8) {
    int q = __float2int_rn(__fdiv_rn(y, p.out_scale));
    q = q < -127 ? -127 : (q > 127 ? 127 : q);
    static_cast<int8_t*>(p.out)[o] = static_cast<int8_t>(q);
  } else if (p.out_type == kBf16) {
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(y);
  } else {
    static_cast<float*>(p.out)[o] = y;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Params p) {
  __shared__ __align__(16) int8_t smem_a[2][kBM * kRow];
  __shared__ __align__(16) int8_t smem_b[2][kBN * kRow];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * kBM;
  const int f0 = blockIdx.y * kBN;
  const int ktiles = (p.k + kBK - 1) / kBK;

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  if constexpr (kVec) {
    Pixel px[2];
    px[0] = pixel_of(p, m0 + (tid >> 2));
    px[1] = pixel_of(p, m0 + (tid >> 2) + 64);
    load_tile_vec(p, smem_a[0], smem_b[0], 0, px, f0);
    cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) {
        load_tile_vec(p, smem_a[(kt + 1) & 1], smem_b[(kt + 1) & 1], kt + 1,
                      px, f0);
      }
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      compute_tile(smem_a[kt & 1], smem_b[kt & 1], wm, wn, g, t, acc);
      __syncthreads();
    }
  } else {
    const Pixel px = pixel_of(p, m0 + (tid >> 1));
    load_tile_bytes(p, smem_a[0], smem_b[0], 0, px, f0);
    for (int kt = 0; kt < ktiles; ++kt) {
      __syncthreads();
      compute_tile(smem_a[kt & 1], smem_b[kt & 1], wm, wn, g, t, acc);
      if (kt + 1 < ktiles) {
        load_tile_bytes(p, smem_a[(kt + 1) & 1], smem_b[(kt + 1) & 1],
                        kt + 1, px, f0);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mi * 16 + g + (e >> 1) * 8;
        const int f = f0 + wn * 32 + ni * 8 + t * 2 + (e & 1);
        if (m < p.m && f < p.f) store_one(p, m, f, acc[mi][ni][e]);
      }
    }
  }
}

}  // namespace

extern "C" int pdac_int8_conv(const void* x, const void* w, const void* sw,
                              const void* a, const void* b, const void* res,
                              void* out, int n, int h, int wd, int c, int f,
                              int kh, int kw, int stride, int pad, int dil,
                              int oh, int ow, float sx, int res_type,
                              float res_scale, int bias_last, int relu,
                              int out_type, float out_scale, int nchw,
                              int vec, void* stream) {
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
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
  const dim3 grid((p.m + kBM - 1) / kBM, (f + kBN - 1) / kBN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    int8_conv_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    int8_conv_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
