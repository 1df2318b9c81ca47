// Overlap-blend stitch of one batch of probability windows into the
// canvases, for Hopper (sm_90a): for each window i < k in tile order, at
// its clamped origin (y, x),
//   accum[y:y+t, x:x+t] += probs[i] * win     weight[y:y+t, x:x+t] += win
// on a binary (h, w) or channelled (h, w, C) accumulation canvas and the
// shared 2-D weight canvas, in place.
//
// Replaces no Pallas kernel: the JAX package's stitch
// (pdac_pathological_image_segmentation_tpu/ops/stitch.py) is a lax.scan of
// dynamic slice updates that XLA compiles.  The port's plain version
// (ops/stitch.py::stitch_tiles_into_reference) is a Python loop of two
// slice adds a window; on the card each add is its own strided launch and
// the card waits on the host between them.  This kernel is the one launch
// a batch that replaces them.
//
// What bounds it: bytes.  A batch reads its k windows' probabilities once
// (k t^2 C elements) and reads and writes the accumulation and weight
// canvases once over the pixels its windows cover: 128 windows of 512^2
// float32 at stride 256 read 128 MiB and move 17-25 M pixels x 16 bytes,
// 0.4-0.55 GB, 0.12-0.16 ms at 3.35 TB/s.  The arithmetic is a multiply
// and two adds a pixel and window.  The design moves each of those bytes
// once: a block owns a patch of kRows rows and kThreads canvas elements
// (element = pixel x C + channel) of the span the batch covers, keeps its
// pixels in registers while every covering window is added, and loads and
// stores each pixel once.  The blend window (1 MiB) stays in L2.
//
// Determinism: no atomics.  A block keeps, in tile order, the windows
// that cover its patch (a warp ballot and a popcount prefix over the
// warps keep the order), kThreads windows a round, so any k works; each
// thread adds them to its pixels in that order.  Each add rounds the
// product and then the sum (__fmul_rn, __fadd_rn, never a contracted
// FMA), as the plain loop's `probs.float() * win` and `+=` do, so every
// pixel sees the same float32 operations in the same order as the loop
// and the maps are bit-equal to it, run after run.
//
// The probabilities are float32, bfloat16 or float16 (converted exactly
// to float32) in any element strides (n, y, x, c); the canvases and the
// window are contiguous float32; the origins are k (y, x) int32 pairs on
// the card, already clamped inside the canvas.  The launch covers rows
// [y_lo, y_hi) and pixel columns [x_lo, x_hi), the span of the clamped
// origins; a block whose patch no window covers exits without touching
// the canvases.
//
// Plain C interface, loaded with ctypes.  It launches on the caller's
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // canvas elements of a patch row
constexpr int kRows = 16;      // rows of a patch
constexpr int kWarps = kThreads / 32;

enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };  // ops/stitch.py::_DTYPES

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stitch_kernel(float* __restrict__ accum, float* __restrict__ weight,
                  const T* __restrict__ probs, const float* __restrict__ win,
                  const int* __restrict__ yx, int k, int t, int w, int c,
                  int64_t sn, int64_t sh, int64_t sw, int64_t sc, int y_lo,
                  int y_hi, int x_lo, int x_hi) {
  __shared__ int s_idx[kThreads];
  __shared__ int s_y[kThreads];
  __shared__ int s_x[kThreads];
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // the patch: rows [r0, r1), canvas elements [e0, e1), pixels [p0, p1]
  const int r0 = y_lo + blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, y_hi);
  const int e0 = x_lo * c + blockIdx.x * kThreads;
  const int e1 = min(e0 + kThreads, x_hi * c);
  const int p0 = e0 / c;
  const int p1 = (e1 - 1) / c;
  // this thread's element of each patch row
  const int e = e0 + tid;
  const bool live = e < e1;
  const int px = e / c;
  const int ch = e - px * c;
  const int64_t row_elems = static_cast<int64_t>(w) * c;

  float acc[kRows];
  float wt[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = wt[i] = 0.0f;
  bool loaded = false;

  for (int base = 0; base < k; base += kThreads) {
    // keep, in tile order, this round's windows that cover the patch
    const int j = base + tid;
    int oy = 0, ox = 0;
    bool cover = false;
    if (j < k) {
      oy = yx[2 * j];
      ox = yx[2 * j + 1];
      cover = oy < r1 && oy + t > r0 && ox <= p1 && ox + t > p0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, cover);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int n = s_warp[v];
      before += v < warp ? n : 0;
      total += n;
    }
    if (cover) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      s_idx[pos] = j;
      s_y[pos] = oy;
      s_x[pos] = ox;
    }
    __syncthreads();

    if (total > 0 && !loaded) {  // block-uniform
      loaded = true;
      if (live) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = r0 + i;
          if (r < r1) {
            acc[i] = accum[r * row_elems + e];
            if (ch == 0) wt[i] = weight[static_cast<int64_t>(r) * w + px];
          }
        }
      }
    }
    for (int s = 0; s < total; ++s) {
      const int wy = s_y[s];
      const int dx = px - s_x[s];
      if (!live || dx < 0 || dx >= t) continue;
      const T* pp = probs + s_idx[s] * sn + dx * sw + ch * sc;
      const float* ww = win + dx;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int dy = r0 + i - wy;
        if (dy >= 0 && dy < t) {
          const float wv = __ldg(ww + static_cast<int64_t>(dy) * t);
          const float p = to_f32(pp[dy * sh]);
          acc[i] = __fadd_rn(acc[i], __fmul_rn(p, wv));
          wt[i] = __fadd_rn(wt[i], wv);
        }
      }
    }
    __syncthreads();  // the next round rewrites the shared lists
  }

  if (loaded && live) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      if (r < r1) {
        accum[r * row_elems + e] = acc[i];
        if (ch == 0) weight[static_cast<int64_t>(r) * w + px] = wt[i];
      }
    }
  }
}

template <typename T>
int launch(void* accum, void* weight, const void* probs, const void* win,
           const void* yx, int k, int t, int w, int c, int64_t sn,
           int64_t sh, int64_t sw, int64_t sc, int y_lo, int y_hi, int x_lo,
           int x_hi, cudaStream_t st) {
  const int64_t elems = static_cast<int64_t>(x_hi - x_lo) * c;
  const int64_t rows = y_hi - y_lo;
  const dim3 grid(static_cast<unsigned>((elems + kThreads - 1) / kThreads),
                  static_cast<unsigned>((rows + kRows - 1) / kRows));
  stitch_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<float*>(accum), static_cast<float*>(weight),
      static_cast<const T*>(probs), static_cast<const float*>(win),
      static_cast<const int*>(yx), k, t, w, c, sn, sh, sw, sc, y_lo, y_hi,
      x_lo, x_hi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pdac_stitch(void* accum, void* weight, const void* probs,
                           int dtype, const void* win, const void* yx, int k,
                           int t, int w, int c, long long sn, long long sh,
                           long long sw, long long sc, int y_lo, int y_hi,
                           int x_lo, int x_hi, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return launch<float>(accum, weight, probs, win, yx, k, t, w, c, sn, sh,
                         sw, sc, y_lo, y_hi, x_lo, x_hi, st);
  }
  if (dtype == kBf16) {
    return launch<__nv_bfloat16>(accum, weight, probs, win, yx, k, t, w, c,
                                 sn, sh, sw, sc, y_lo, y_hi, x_lo, x_hi, st);
  }
  if (dtype == kF16) {
    return launch<__half>(accum, weight, probs, win, yx, k, t, w, c, sn, sh,
                          sw, sc, y_lo, y_hi, x_lo, x_hi, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
