// float -> int8 activation quantize for Hopper (sm_90a):
//   q = clip(round_half_even(f32(x) / s), -127, 127) as int8,
// from a float32 or bfloat16 (N, H, W, C) tensor given by four element
// strides, into a contiguous NHWC int8 tensor of Cout >= C channels (the
// channels past C are zeros: the int8 stem's 3 input channels padded to 4
// for its space-to-depth layout, 16 bytes a 2x2 block).
//
// Replaces no TPU kernel: the JAX package quantizes an activation with
// jnp.clip(jnp.round(x / s), -127, 127).astype(int8) at the consuming conv
// (infer/quantized.py::_conv_i8, _Ctx.act) and leaves it to XLA.  The port's
// plain version (ops/int8_conv.py::quantize_activation_reference) is four
// torch passes (divide, round, clamp, cast) with float32 temporaries; this
// kernel is the one pass that replaces them on the card.
//
// Exactness: __fdiv_rn divides by the scale as IEEE division (the plain
// version divides by a one-element tensor for the same reason: a Python
// scalar makes CUDA multiply by the reciprocal), __float2int_rn rounds half
// to even, then the clamp.  The result equals the plain version bit for bit
// (and through it the JAX expression).  Written in CUDA C++ and not Triton:
// Triton lowers an f32 `/` to the approximate div.full.f32.
//
// What bounds it: bytes.  It reads 2 or 4 bytes an element and writes 1,
// once each; the arithmetic is a divide and a convert an element.  Three
// layouts, chosen by the wrapper (ops/int8_conv.py::quantize_layout):
//   nhwc    contiguous NHWC input and Cout == C: 16 elements a thread, read
//           as 16-byte vectors and written as one 16-byte store;
//   strided any other strides (the NHWC view of NCHW memory among them),
//           or Cout > C: a thread writes 4 output channels of one pixel as
//           one 4-byte store where Cout % 4 == 0, else one byte;
//   s2d     space to depth, for a stride-2 convolution (the stem): output
//           (N, ceil(H/2), ceil(W/2), 4 Cout), channel (2 sh + sw) Cout + c
//           of pixel (i, j) from x[n, 2i + sh, 2j + sw, c] (zero for
//           c >= C, and past an odd edge); a thread writes one 16-byte
//           output pixel where 4 Cout == 16.  The stem's 7x7/2
//           convolution on it is a 4x4/1 convolution on 16 contiguous
//           bytes a tap (ops/int8_conv.py::space_to_depth_weights).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Layout { kNhwc = 0, kStrided = 1, kS2d = 2 };
enum Dtype { kBf16 = 2, kF32 = 3 };  // ops/int8_conv.py::_CODES

__device__ __forceinline__ int quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) |
         ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) |
         ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

// One 16-byte read (4 float32 or 8 bfloat16 elements) -> its quantized
// bytes as 1 or 2 packed words.
__device__ __forceinline__ void quant_piece(const float* x, float s,
                                            uint32_t* w) {
  const float4 f = *reinterpret_cast<const float4*>(x);
  w[0] = pack4(quant(f.x, s), quant(f.y, s), quant(f.z, s), quant(f.w, s));
}

__device__ __forceinline__ void quant_piece(const __nv_bfloat16* x, float s,
                                            uint32_t* w) {
  const uint4 u = *reinterpret_cast<const uint4*>(x);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
  int q[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // a bf16 is the top half of its float32
    q[2 * j] = quant(__uint_as_float(words[j] << 16), s);
    q[2 * j + 1] = quant(__uint_as_float(words[j] & 0xffff0000u), s);
  }
  w[0] = pack4(q[0], q[1], q[2], q[3]);
  w[1] = pack4(q[4], q[5], q[6], q[7]);
}

template <typename T>
__global__ void quantize_nhwc_kernel(const T* __restrict__ x,
                                     int8_t* __restrict__ out, int64_t total,
                                     float s) {
  const int64_t groups = (total + 15) / 16;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       g < groups; g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t e = g * 16;
    if (e + 16 <= total) {
      constexpr int kVec = 16 / sizeof(T);
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 16 / kVec; ++i) quant_piece(x + e + i * kVec, s,
                                                      w + i * kVec / 4);
      *reinterpret_cast<uint4*>(out + e) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int64_t i = e; i < total; ++i) {
        out[i] = static_cast<int8_t>(quant(load_f32(x + i), s));
      }
    }
  }
}

// One thread per (pixel, group of G output channels).
template <typename T, int G>
__global__ void quantize_strided_kernel(const T* __restrict__ x,
                                        int8_t* __restrict__ out, int n,
                                        int h, int w, int c, int64_t sn,
                                        int64_t sh, int64_t sw, int64_t sc,
                                        int cout, float s) {
  const int groups = cout / G;
  const int64_t total = static_cast<int64_t>(n) * h * w * groups;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int grp = static_cast<int>(i % groups);
    const int64_t pix = i / groups;
    const int xw = static_cast<int>(pix % w);
    const int64_t t = pix / w;
    const int xh = static_cast<int>(t % h);
    const int64_t xn = t / h;
    const T* base = x + xn * sn + xh * sh + xw * sw;
    int q[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int ch = grp * G + j;
      q[j] = ch < c ? quant(load_f32(base + ch * sc), s) : 0;
    }
    if constexpr (G == 4) {
      reinterpret_cast<uint32_t*>(out)[i] = pack4(q[0], q[1], q[2], q[3]);
    } else {
      out[i] = static_cast<int8_t>(q[0]);
    }
  }
}

// One thread per output pixel of the space-to-depth layout and group of G
// bytes of it (G = 16: the whole pixel, 4 Cout == 16).
template <typename T, int G>
__global__ void quantize_s2d_kernel(const T* __restrict__ x,
                                    int8_t* __restrict__ out, int n, int h,
                                    int w, int c, int64_t sn, int64_t sh,
                                    int64_t sw, int64_t sc, int cout,
                                    float s) {
  const int oc = 4 * cout;  // bytes of an output pixel
  const int groups = oc / G;
  const int hs = (h + 1) / 2;  // an odd edge's missing pixels are zeros
  const int ws = (w + 1) / 2;
  const int64_t total = static_cast<int64_t>(n) * hs * ws * groups;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int grp = static_cast<int>(i % groups);
    const int64_t pix = i / groups;
    const int xj = static_cast<int>(pix % ws);
    const int64_t t = pix / ws;
    const int xi = static_cast<int>(t % hs);
    const int64_t xn = t / hs;
    int q[G];
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const int ch = grp * G + e;  // (2 sh + sw) cout + cc
      const int sub = ch / cout;
      const int cc = ch - sub * cout;
      const int ih = 2 * xi + (sub >> 1);
      const int iw = 2 * xj + (sub & 1);
      q[e] = 0;
      if (cc < c && ih < h && iw < w) {
        q[e] = quant(load_f32(x + xn * sn + ih * sh + iw * sw + cc * sc), s);
      }
    }
    uint32_t words[G / 4];
#pragma unroll
    for (int e = 0; e < G / 4; ++e) {
      words[e] = pack4(q[4 * e], q[4 * e + 1], q[4 * e + 2], q[4 * e + 3]);
    }
    if constexpr (G == 16) {
      reinterpret_cast<uint4*>(out)[i] =
          make_uint4(words[0], words[1], words[2], words[3]);
    } else {
      reinterpret_cast<uint32_t*>(out)[i] = words[0];
    }
  }
}

int blocks_for(int64_t work, int threads) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int64_t want = (work + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(sms) * 16;
  return static_cast<int>(want < cap ? (want < 1 ? 1 : want) : cap);
}

template <typename T>
int launch(const void* xv, void* outv, int n, int h, int w, int c,
           int64_t sn, int64_t sh, int64_t sw, int64_t sc, int cout,
           float s, int layout, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  int8_t* out = static_cast<int8_t*>(outv);
  if (layout == kNhwc) {
    const int64_t total = static_cast<int64_t>(n) * h * w * c;
    quantize_nhwc_kernel<T>
        <<<blocks_for((total + 15) / 16, 256), 256, 0, st>>>(x, out, total,
                                                             s);
  } else if (layout == kS2d) {
    const int64_t pixels =
        static_cast<int64_t>(n) * ((h + 1) / 2) * ((w + 1) / 2);
    if (4 * cout == 16) {
      quantize_s2d_kernel<T, 16><<<blocks_for(pixels, 256), 256, 0, st>>>(
          x, out, n, h, w, c, sn, sh, sw, sc, cout, s);
    } else {
      quantize_s2d_kernel<T, 4>
          <<<blocks_for(pixels * cout, 256), 256, 0, st>>>(
              x, out, n, h, w, c, sn, sh, sw, sc, cout, s);
    }
  } else {
    const int64_t pixels = static_cast<int64_t>(n) * h * w;
    if (cout % 4 == 0) {
      quantize_strided_kernel<T, 4>
          <<<blocks_for(pixels * (cout / 4), 256), 256, 0, st>>>(
              x, out, n, h, w, c, sn, sh, sw, sc, cout, s);
    } else {
      quantize_strided_kernel<T, 1>
          <<<blocks_for(pixels * cout, 256), 256, 0, st>>>(
              x, out, n, h, w, c, sn, sh, sw, sc, cout, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pdac_quantize(const void* x, int dtype, void* out, int n,
                             int h, int w, int c, long long sn, long long sh,
                             long long sw, long long sc, int cout,
                             float scale, int layout, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return launch<float>(x, out, n, h, w, c, sn, sh, sw, sc, cout, scale,
                         layout, st);
  }
  if (dtype == kBf16) {
    return launch<__nv_bfloat16>(x, out, n, h, w, c, sn, sh, sw, sc, cout,
                                 scale, layout, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
