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
//      pure index remap (the TPU kernel's 0/1 MXU matmuls were a Mosaic
//      workaround); the mask rides through the same remap and is written as
//      the float32 of its uint8 value.
//
// What bounds it: memory traffic.  Per 512^2 sample 1 MiB in (image and
// mask) and 2.5 MiB out (bf16 image, f32 mask), plus 0.75 MiB for the one
// statistics pass of a jittered sample (below); the arithmetic is a few
// dozen flops a pixel, about a hundred for a jittered one.
//
// Five launches over a grid of (64x64 source tiles, N).  Only a slot whose
// gamma is not 0 uses the mean of its input (contrast, one slot per sample
// in the tables of augment.make_augment_tables); for the others
// gamma * mean is 0 whatever the mean, so:
//   pass k = 0..3 (augment_stats_kernel<kVec, k>): for samples with j_apply
//     set and gamma_k != 0, every block re-derives slots < k per pixel from
//     the uint8 input and the means already known, and writes its tile's
//     partial sums of the slot-k input (3 floats); the other samples return
//     at once, and nothing reads the partials they did not write;
//   pass 4 (augment_out_kernel): every block writes its tile's output.
// A block that needs the means of slots < k reduces those slots' partials
// itself in a fixed order (one warp per (slot, channel): strided lane sums,
// then a fixed shuffle tree); a block's own sums are a thread's 16 pixels
// in order, a warp tree, then the warps in order.  No atomics: runs repeat
// bit for bit.
//
// What the design does about the bytes and instructions:
//   - Tiles and 16-byte loads.  Thread t of a block owns row t / 4 and
//     columns (t % 4) * 16 .. +15 of its tile: 48 contiguous image bytes
//     (three 16-byte loads) and 16 mask bytes (one).  No division per
//     pixel.  A size that is not a multiple of 16 leaves rows that are not
//     16-byte aligned; it takes the kVec = false instantiation of the same
//     kernels (byte loads, 2- and 4-byte stores), chosen by the wrapper.
//     Every block issues its span's loads before it reads the tables, the
//     slot matrices and the partials, so those round trips overlap.
//   - Byte lookup tables instead of divisions.  The wrapper passes unit[256]
//     = bf16(v / 255) as f32 and norm[3][256] = the normalized bf16 of an
//     un-jittered byte per channel, both computed by the plain version's
//     own functions (ops/fused_augment.py::lookup_tables), so they equal
//     the plain chain bit for bit.  Each block copies them into shared
//     memory (2.5 KiB).  An un-jittered sample's output is norm[c][byte],
//     with no float arithmetic; a jittered sample starts from unit[byte].
//   - Fewer instructions a jittered pixel, the same bits: the clip rides on
//     the last add as a saturation (slot_out), a diagonal slot skips its
//     zero products (apply_slots), and each pass is its own instantiation,
//     so the slot loop unrolls over parameters held in registers.
//   - Stores through a shared-memory tile.  Each thread puts its pixels at
//     the place the geometry gives them inside the block's output tile
//     (ops/fused_augment.py::out_tile and in_tile: the same formulas); then
//     the block stores the output tile row by row in 16-byte vectors (8 bf16
//     or 4 f32), one code path for all eight (t, l, r), transposed or not.
//     The staging tiles are XOR-swizzled by 16-byte chunk so that both the
//     row writes of an untransposed sample (16-byte vectors) and the column
//     writes of a transposed one (2-byte and 1-byte values, four rows 16
//     apart per warp) meet no bank conflict.  The output kernel is held to
//     80 registers, three blocks an SM, which its loads and stores need.
//
// Plain C interface, loaded with ctypes; runs on the caller's stream and
// allocates nothing (the wrapper passes the partials buffer of
// 4 * N * tiles * 3 floats and the two tables).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // source tile edge
constexpr int kSpan = 16;  // pixels a thread owns, along one tile row
constexpr int kSpansPerRow = kTile / kSpan;
constexpr int kSlots = 4;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct SampleParams {
  float a[kSlots][9];  // row-major 3x3 per slot
  float gm[kSlots];    // gamma_s * mean_gray of the slot input
  int diag[kSlots];    // the slot's off-diagonal entries are all zero
};

// One channel of a slot's output from its f32 sum t: the plain chain's
// clip(bf16(t + gm), 0, 1), computed as bf16(sat(t + gm)).  Rounding to
// bf16 is monotone and keeps 0 and 1, so clipping before or after it gives
// the same value.
__device__ __forceinline__ float slot_out(float t, float gm) {
  return bf16_round(__saturatef(__fadd_rn(t, gm)));
}

// x (three bf16-valued floats) through slots [0, kN).  A diagonal slot
// (brightness, contrast) skips its off-diagonal products: each is an exact
// zero, and adding one changes at most the sign of a zero sum, which
// neither the means nor the normalize can see.
template <int kN>
__device__ __forceinline__ void apply_slots(const SampleParams& p, float& x0,
                                            float& x1, float& x2) {
#pragma unroll
  for (int s = 0; s < kN; ++s) {
    const float* a = p.a[s];
    if (p.diag[s]) {
      x0 = slot_out(__fmul_rn(a[0], x0), p.gm[s]);
      x1 = slot_out(__fmul_rn(a[4], x1), p.gm[s]);
      x2 = slot_out(__fmul_rn(a[8], x2), p.gm[s]);
    } else {
      float y[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float t = __fadd_rn(__fmul_rn(a[3 * c], x0),
                            __fmul_rn(a[3 * c + 1], x1));
        t = __fadd_rn(t, __fmul_rn(a[3 * c + 2], x2));
        y[c] = slot_out(t, p.gm[s]);
      }
      x0 = y[0];
      x1 = y[1];
      x2 = y[2];
    }
  }
}

// Loads the sample's slot matrices and, for slots < nmeans, derives
// gamma_s * mean_gray from the partials of earlier passes; a slot whose
// gamma is 0 gets 0 without them (its statistics pass did not run).  Ends
// with a __syncthreads(); the result is in shared memory.
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
    if (gammas[i * kSlots + s] == 0.f) continue;
    const float* p = partials + (static_cast<int64_t>(s) * n + i) * blocks * 3;
    float v = 0.f;
    for (int b = lane; b < blocks; b += 32) v += p[3 * b + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) totals[s][c] = v;
  }
  __syncthreads();
  if (tid < kSlots) {
    const float* a = sp.a[tid];
    sp.diag[tid] = a[1] == 0.f && a[2] == 0.f && a[3] == 0.f && a[5] == 0.f &&
                   a[6] == 0.f && a[7] == 0.f;
  }
  if (tid < nmeans) {
    const float mu0 = __fmul_rn(totals[tid][0], inv_hw);
    const float mu1 = __fmul_rn(totals[tid][1], inv_hw);
    const float mu2 = __fmul_rn(totals[tid][2], inv_hw);
    float m = __fadd_rn(__fmul_rn(0.299f, mu0), __fmul_rn(0.587f, mu1));
    m = __fadd_rn(m, __fmul_rn(0.114f, mu2));
    const float g = gammas[i * kSlots + tid];
    sp.gm[tid] = g == 0.f ? 0.f : __fmul_rn(g, m);
  }
  __syncthreads();
}

// The block's source tile and the thread's span in it.
struct Span {
  int ty0, tx0;  // tile origin in the sample
  int th, tw;    // tile extent (ragged at the bottom and right edges)
  int sr, sc0;   // the thread's tile row and first tile column
  int valid;     // pixels of the span inside the sample (0..16)
};

__device__ __forceinline__ Span thread_span(int size) {
  const int tiles_x = (size + kTile - 1) / kTile;
  Span s;
  s.ty0 = (blockIdx.x / tiles_x) * kTile;
  s.tx0 = (blockIdx.x % tiles_x) * kTile;
  s.th = min(kTile, size - s.ty0);
  s.tw = min(kTile, size - s.tx0);
  s.sr = threadIdx.x / kSpansPerRow;
  s.sc0 = (threadIdx.x % kSpansPerRow) * kSpan;
  s.valid = s.sr < s.th ? max(0, min(kSpan, s.tw - s.sc0)) : 0;
  return s;
}

// the index of the span's first pixel among all N * size^2
__device__ __forceinline__ int64_t span_start(const Span& s, int i, int size) {
  return static_cast<int64_t>(i) * size * size +
         static_cast<int64_t>(s.ty0 + s.sr) * size + s.tx0 + s.sc0;
}

// The span's 48 RGB bytes (pixel j channel c is byte 3j + c) and, with
// `mask`, its 16 mask bytes; bytes past `valid` pixels read as 0.
template <bool kVec>
__device__ __forceinline__ void load_span(const uint8_t* __restrict__ p,
                                          const uint8_t* __restrict__ mp,
                                          int valid, uint32_t (&rgb)[12],
                                          uint32_t (&msk)[4]) {
  if (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    rgb[0] = a.x; rgb[1] = a.y; rgb[2] = a.z; rgb[3] = a.w;
    rgb[4] = b.x; rgb[5] = b.y; rgb[6] = b.z; rgb[7] = b.w;
    rgb[8] = c.x; rgb[9] = c.y; rgb[10] = c.z; rgb[11] = c.w;
    if (mp != nullptr) {
      const uint4 m = __ldg(reinterpret_cast<const uint4*>(mp));
      msk[0] = m.x; msk[1] = m.y; msk[2] = m.z; msk[3] = m.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < 12; ++w) rgb[w] = 0u;
#pragma unroll
    for (int w = 0; w < 4; ++w) msk[w] = 0u;
#pragma unroll
    for (int k = 0; k < 3 * kSpan; ++k)
      if (k / 3 < valid)
        rgb[k / 4] |= static_cast<uint32_t>(__ldg(p + k)) << (8 * (k % 4));
    if (mp != nullptr) {
#pragma unroll
      for (int k = 0; k < kSpan; ++k)
        if (k < valid)
          msk[k / 4] |= static_cast<uint32_t>(__ldg(mp + k)) << (8 * (k % 4));
    }
  }
}

__device__ __forceinline__ int byte_at(const uint32_t* w, int k) {
  return (w[k / 4] >> (8 * (k % 4))) & 0xff;
}

// partial sums of slot kPass's input over the block's tile (kPass 0..3)
template <bool kVec, int kPass>
__global__ void __launch_bounds__(kThreads)
augment_stats_kernel(const uint8_t* __restrict__ img,
                     const float* __restrict__ a_mats,
                     const float* __restrict__ gammas,
                     const int32_t* __restrict__ ints,
                     const float* __restrict__ unit_table,
                     float* __restrict__ partials, int n, int size) {
  const int i = blockIdx.y;
  // only a slot with a gamma (contrast) uses the mean of its input
  if (ints[i * 8 + 4] != 1 || gammas[i * kSlots + kPass] == 0.f) return;
  // the span's loads go out first; the table and the means of earlier
  // slots arrive while they are in flight
  const int hw = size * size;
  const Span s = thread_span(size);
  uint32_t rgb[12], msk[4];
  if (s.valid > 0)
    load_span<kVec>(img + 3 * span_start(s, i, size), nullptr, s.valid, rgb,
                    msk);
  __shared__ SampleParams sp;
  __shared__ float unit[256];
  unit[threadIdx.x] = unit_table[threadIdx.x];
  load_params(sp, a_mats, gammas, partials, i, n, gridDim.x, kPass,
              __fdiv_rn(1.f, static_cast<float>(hw)));

  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  if (s.valid > 0) {
    const SampleParams prm = sp;
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      if (kVec || j < s.valid) {
        float x0 = unit[byte_at(rgb, 3 * j)];
        float x1 = unit[byte_at(rgb, 3 * j + 1)];
        float x2 = unit[byte_at(rgb, 3 * j + 2)];
        apply_slots<kPass>(prm, x0, x1, x2);
        s0 += x0;
        s1 += x1;
        s2 += x2;
      }
    }
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
    partials[((static_cast<int64_t>(kPass) * n + i) * gridDim.x + blockIdx.x) *
                 3 + threadIdx.x] = t;
  }
}

// Staging tiles: row r of the output tile holds its 16-byte chunks in the
// order chunk ^ swizzle(r).  Image: 8 bf16 chunks a row; a transposed warp
// writes one chunk column in four rows 16 apart, which these swizzles send
// to four different chunks (and untransposed row pairs to disjoint ones).
__device__ __forceinline__ int img_slot(int r, int c) {
  return r * kTile + ((((c >> 3) ^ (r ^ (r >> 3))) & 7) << 3) + (c & 7);
}
// Mask: 4 u8 chunks a row.
__device__ __forceinline__ int mask_slot(int r, int c) {
  return r * kTile + ((((c >> 4) ^ (r ^ (r >> 4))) & 3) << 4) + (c & 15);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// the output: one tile of the sample, through the staging tiles
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 3)
augment_out_kernel(const uint8_t* __restrict__ img,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ a_mats,
                   const float* __restrict__ gammas,
                   const int32_t* __restrict__ ints,
                   const int32_t* __restrict__ geom,
                   const float* __restrict__ unit_table,
                   const uint16_t* __restrict__ norm_table,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ mout,
                   const float* __restrict__ partials, int n, int size) {
  __shared__ SampleParams sp;
  __shared__ float unit[256];
  __shared__ uint16_t norm[3][256];
  __shared__ __align__(16) uint16_t stage[3][kTile * kTile];
  __shared__ __align__(16) uint8_t mstage[kTile * kTile];
  const int i = blockIdx.y;
  const int tid = threadIdx.x;
  // the span's loads go out first, as in augment_stats_kernel
  const int hw = size * size;
  const Span s = thread_span(size);
  uint32_t rgb[12], msk[4];
  if (s.valid > 0) {
    const int64_t p = span_start(s, i, size);
    load_span<kVec>(img + 3 * p, mask + p, s.valid, rgb, msk);
  }
  const bool jitter = ints[i * 8 + 4] == 1;
  unit[tid] = unit_table[tid];
#pragma unroll
  for (int c = 0; c < 3; ++c) norm[c][tid] = norm_table[c * 256 + tid];
  load_params(sp, a_mats, gammas, partials, i, n, gridDim.x,
              jitter ? kSlots : 0, __fdiv_rn(1.f, static_cast<float>(hw)));

  const bool t = geom[i * 3] == 1;
  const bool l = geom[i * 3 + 1] == 1;
  const bool r = geom[i * 3 + 2] == 1;
  // the output tile (ops/fused_augment.py::out_tile)
  const int a0 = t ? s.tx0 : s.ty0, ah = t ? s.tw : s.th;
  const int b0 = t ? s.ty0 : s.tx0, bw = t ? s.th : s.tw;
  const int orow0 = l ? size - a0 - ah : a0;
  const int ocol0 = r ? size - b0 - bw : b0;

  if (s.valid > 0) {
    // pix[c][k]: the bf16 bits of pixels 2k (low half) and 2k + 1 (high)
    uint32_t pix[3][kSpan / 2];
    if (!jitter) {
#pragma unroll
      for (int k = 0; k < kSpan / 2; ++k) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          pix[c][k] = norm[c][byte_at(rgb, 6 * k + c)] |
                      static_cast<uint32_t>(norm[c][byte_at(rgb, 6 * k + 3 + c)])
                          << 16;
      }
    } else {
      const SampleParams prm = sp;
      const float mean_bf[3] = {bf16_round(0.485f), bf16_round(0.456f),
                                bf16_round(0.406f)};
      const float std_bf[3] = {bf16_round(0.229f), bf16_round(0.224f),
                               bf16_round(0.225f)};
#pragma unroll
      for (int j = 0; j < kSpan; ++j) {
        float x[3] = {unit[byte_at(rgb, 3 * j)], unit[byte_at(rgb, 3 * j + 1)],
                      unit[byte_at(rgb, 3 * j + 2)]};
        apply_slots<kSlots>(prm, x[0], x[1], x[2]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = bf16_round(__fsub_rn(x[c], mean_bf[c]));
          const uint32_t b = bf16_bits(__fdiv_rn(v, std_bf[c]));
          pix[c][j / 2] = (j % 2 == 0) ? b : (pix[c][j / 2] | (b << 16));
        }
      }
    }
    if (kVec && !t) {
      // a whole span lands in one output row, reversed when r: two 16-byte
      // chunks per channel and one of the mask
      const int orow = l ? s.th - 1 - s.sr : s.sr;
      const int ocs = r ? s.tw - kSpan - s.sc0 : s.sc0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        uint32_t w[kSpan / 2];
#pragma unroll
        for (int k = 0; k < kSpan / 2; ++k)
          w[k] = r ? __byte_perm(pix[c][kSpan / 2 - 1 - k], 0, 0x1032)
                   : pix[c][k];
        *reinterpret_cast<uint4*>(&stage[c][img_slot(orow, ocs)]) =
            make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(&stage[c][img_slot(orow, ocs + 8)]) =
            make_uint4(w[4], w[5], w[6], w[7]);
      }
      uint32_t m[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[k] = r ? __byte_perm(msk[3 - k], 0, 0x0123) : msk[k];
      *reinterpret_cast<uint4*>(&mstage[mask_slot(orow, ocs)]) =
          make_uint4(m[0], m[1], m[2], m[3]);
    } else {
      // pixel by pixel (ops/fused_augment.py::in_tile)
#pragma unroll
      for (int j = 0; j < kSpan; ++j) {
        if (kVec || j < s.valid) {
          const int yr = t ? s.sc0 + j : s.sr;
          const int yc = t ? s.sr : s.sc0 + j;
          const int oi = l ? ah - 1 - yr : yr;
          const int oj = r ? bw - 1 - yc : yc;
          const int at = img_slot(oi, oj);
#pragma unroll
          for (int c = 0; c < 3; ++c)
            stage[c][at] = static_cast<uint16_t>(pix[c][j / 2] >> (16 * (j % 2)));
          mstage[mask_slot(oi, oj)] = static_cast<uint8_t>(byte_at(msk, j));
        }
      }
    }
  }
  __syncthreads();

  // the output tile, row by row
  const int oh = ah, ow = bw;
  uint16_t* dst = reinterpret_cast<uint16_t*>(out) + static_cast<int64_t>(i) * 3 * hw;
  float* mdst = mout + static_cast<int64_t>(i) * hw;
  if (kVec) {
    // 8 bf16 a thread: a warp stores 4 rows of 128 bytes
#pragma unroll
    for (int q = 0; q < 3 * kTile * kTile / 8 / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int c = idx / (kTile * kTile / 8);
      const int row = (idx / (kTile / 8)) % kTile;
      const int col = (idx % (kTile / 8)) * 8;
      if (row < oh && col < ow) {
        const uint4 v = *reinterpret_cast<const uint4*>(&stage[c][img_slot(row, col)]);
        *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(c) * hw +
                                  static_cast<int64_t>(orow0 + row) * size +
                                  ocol0 + col) = v;
      }
    }
    // 4 f32 a thread: a warp stores 2 rows of 256 bytes
#pragma unroll
    for (int q = 0; q < kTile * kTile / 4 / kThreads; ++q) {
      const int idx = tid + q * kThreads;
      const int row = idx / (kTile / 4);
      const int col = (idx % (kTile / 4)) * 4;
      if (row < oh && col < ow) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(&mstage[mask_slot(row, col)]);
        *reinterpret_cast<float4*>(mdst + static_cast<int64_t>(orow0 + row) * size +
                                   ocol0 + col) =
            make_float4(static_cast<float>(w & 0xff),
                        static_cast<float>((w >> 8) & 0xff),
                        static_cast<float>((w >> 16) & 0xff),
                        static_cast<float>(w >> 24));
      }
    }
  } else {
    for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
      const int row = idx / kTile;
      const int col = idx % kTile;
      if (row < oh && col < ow) {
        const int64_t o = static_cast<int64_t>(orow0 + row) * size + ocol0 + col;
        const int at = img_slot(row, col);
#pragma unroll
        for (int c = 0; c < 3; ++c) dst[static_cast<int64_t>(c) * hw + o] = stage[c][at];
        mdst[o] = static_cast<float>(mstage[mask_slot(row, col)]);
      }
    }
  }
}

// one statistics pass; its cudaGetLastError()
template <bool kVec, int kPass>
int launch_stats(dim3 grid, const void* images, const void* a_mats,
                 const void* gammas, const void* ints, const void* unit,
                 void* partials, int n, int size, cudaStream_t st) {
  augment_stats_kernel<kVec, kPass><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(images), static_cast<const float*>(a_mats),
      static_cast<const float*>(gammas), static_cast<const int32_t*>(ints),
      static_cast<const float*>(unit), static_cast<float*>(partials), n, size);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int launch_all(const void* images, const void* masks, const void* a_mats,
               const void* gammas, const void* ints, const void* geom,
               const void* unit, const void* norm, void* out, void* mout,
               void* partials, int n, int size, cudaStream_t st) {
  const int tiles_x = (size + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_x),
                  static_cast<unsigned>(n));
  decltype(&launch_stats<kVec, 0>) passes[kSlots] = {
      launch_stats<kVec, 0>, launch_stats<kVec, 1>, launch_stats<kVec, 2>,
      launch_stats<kVec, 3>};
  for (auto pass : passes) {
    const int err =
        pass(grid, images, a_mats, gammas, ints, unit, partials, n, size, st);
    if (err != 0) return err;
  }
  augment_out_kernel<kVec><<<grid, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(images), static_cast<const uint8_t*>(masks),
      static_cast<const float*>(a_mats), static_cast<const float*>(gammas),
      static_cast<const int32_t*>(ints), static_cast<const int32_t*>(geom),
      static_cast<const float*>(unit), static_cast<const uint16_t*>(norm),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(mout),
      static_cast<const float*>(partials), n, size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// images (N, S, S, 3) uint8, masks (N, S, S) uint8, a_mats (N, 4, 3, 3) f32,
// gammas (N, 4) f32, ints (N, 8) i32, geom (N, 3) i32, unit (256,) f32,
// norm (3, 256) bf16 -> out (N, 3, S, S) bf16, mout (N, S, S) f32;
// partials: 4 * N * tiles * 3 floats with tiles = ceil(S / 64)^2.  vec != 0
// takes the 16-byte instantiation, which needs S % 16 == 0 and 16-byte
// aligned images, masks, out and mout.  Returns cudaGetLastError() after the
// five launches (0 on success).
extern "C" int pdac_fused_augment(const void* images, const void* masks,
                                  const void* a_mats, const void* gammas,
                                  const void* ints, const void* geom,
                                  const void* unit, const void* norm,
                                  void* out, void* mout, void* partials,
                                  int n, int size, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_all<true>(images, masks, a_mats, gammas, ints, geom,
                                unit, norm, out, mout, partials, n, size, st)
             : launch_all<false>(images, masks, a_mats, gammas, ints, geom,
                                 unit, norm, out, mout, partials, n, size, st);
}
