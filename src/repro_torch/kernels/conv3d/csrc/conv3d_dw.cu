// Weight gradient of the direct 3-D convolution, NDHWC activations, DHWIO
// weights, f32 out:
//
//   dw[kd, kh, kw, ci, co] = sum_{n, od, oh, ow}
//       xp[n, od*s + kd, oh*s + kh, ow*s + kw, ci] * g[n, od, oh, ow, co]
//
// where xp is x dilated by `dil` (dil - 1 zeros between elements) and padded
// by the low pads (pd, ph, pw); a negative pad crops.  g is the cotangent of
// the conv output.  The same geometry as csrc/conv3d_fwd.cu.
//
// Replaces the TPU kernel `_dw_kernel` of src/repro/kernels/conv3d/conv3d.py
// (pallas_call in `_conv_dw_core`): dw = patches^T . g with the patch gather
// done inside the kernel, summed in f32 over N*OD*OH*OW.
//
// What bounds it: the function reads x and g once and writes dw once.  At
// the 3DGAN shapes that is 2-60 MB per call against 0.2-11 GFLOP of useful
// multiply-adds, so in bf16 it is bound by bytes and in f32 (on the CUDA
// cores) mostly by operations.  PERF.md gives the numbers per layer.
//
// Design, simple and right first:
// - Nothing is materialised: neither im2col nor the dilated input.  Each
//   block stages a tile of positions in shared memory: the operand read
//   straight ("direct", every channel of each position) and the operand
//   read at a tap's shift ("gathered", one column per (tap, channel)).
//   Index math decides which gathered elements exist; the rest are zeros.
// - Two orders of the sum.  With stride > 1 the positions are the output
//   positions and x is gathered (o*s + k - pad, skipped off the dilation
//   grid).  With stride 1 the positions are the INPUT positions and g is
//   gathered at o = i*dil + pad - k: every (input element, tap) pair that
//   meets a real output is visited once, so the transposed convs (dil 2)
//   do no multiply-adds with the dilation's zeros (1/8 of the naive work).
// - One thread per weight element, a block of 256 consecutive weights;
//   co runs fastest, so a warp reads a staged gathered value as a
//   broadcast and the direct values as consecutive words.
// - The reduction over positions (1.1M to 12.8M terms per weight at full
//   width) is split over blockIdx.y into f32 partials, each summed in a
//   fixed order, then a second kernel sums the partials of each weight in
//   split order.  No atomics: two runs give bit-identical dw.
// What it does not do yet: tensor cores (wgmma), register tiling over
// several weights per thread, TMA or cp.async staging.  Later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 256;        // weights per block, one per thread
constexpr int kMaxTile = 32;         // positions staged per pass
constexpr int kSmemFloats = 11776;   // 46 KB of dynamic shared memory (+ the
                                     // static `pos`: under the 48 KB default)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

struct Geometry {
  int n, d, h, w, ci;   // x
  int od, oh, ow, co;   // g
  int kd, kh, kw;       // taps
  int stride, dil;
  int pd, ph, pw;       // low pads of the dilated input (negative crops)
};

// Columns of the gathered operand per tap, and channels of the direct one.
__host__ __device__ __forceinline__ int gathered_ch(const Geometry& g, bool gather_g) {
  return gather_g ? g.co : g.ci;
}
__host__ __device__ __forceinline__ int direct_ch(const Geometry& g, bool gather_g) {
  return gather_g ? g.ci : g.co;
}

// The gathered columns [c0, c0 + width) that the weights [w0, w1) read.
__host__ __device__ __forceinline__ void tile_columns(const Geometry& g, bool gather_g,
                                                      int64_t w0, int64_t w1, int64_t* c0,
                                                      int64_t* width) {
  if (gather_g) {   // weight (tap, ci, co) reads column tap*co + co
    const int64_t per_tap = (int64_t)g.ci * g.co;
    const int64_t t0 = w0 / per_tap, t1 = (w1 - 1) / per_tap;
    *c0 = t0 * g.co;
    *width = (t1 - t0 + 1) * g.co;
  } else {          // weight (tap, ci, co) reads column tap*ci + ci
    *c0 = w0 / g.co;
    *width = (w1 - 1) / g.co - *c0 + 1;
  }
}

template <typename T, bool GATHER_G>
__global__ void __launch_bounds__(kThreads)
conv3d_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                         float* __restrict__ partial, Geometry g, int64_t positions,
                         int64_t chunk, int tile, int max_width) {
  extern __shared__ float smem[];
  __shared__ int pos[kMaxTile][4];           // decoded (n, a, b, c) of each staged position
  const int taps = g.kd * g.kh * g.kw;
  const int64_t n_weights = (int64_t)taps * g.ci * g.co;
  const int64_t w0 = (int64_t)blockIdx.x * kThreads;
  const int64_t w1 = w0 + kThreads < n_weights ? w0 + kThreads : n_weights;
  const int64_t wi = w0 + threadIdx.x;
  const bool active = wi < n_weights;
  const int cd = direct_ch(g, GATHER_G);
  const int cg = gathered_ch(g, GATHER_G);
  int64_t c0, width;
  tile_columns(g, GATHER_G, w0, w1, &c0, &width);
  float* gs = smem;                          // [tile][max_width]
  float* ds = smem + (int64_t)tile * max_width;   // [tile][cd]

  // this thread's weight: its gathered column (relative to c0) and direct channel
  int col = 0, dch = 0;
  if (active) {
    const int64_t co = wi % g.co;
    const int64_t ci = (wi / g.co) % g.ci;
    const int64_t tap = wi / ((int64_t)g.co * g.ci);
    col = (int)((GATHER_G ? tap * g.co + co : tap * g.ci + ci) - c0);
    dch = (int)(GATHER_G ? ci : co);
  }
  // position space: input positions when gathering g, output positions otherwise
  const int s1 = GATHER_G ? g.d : g.od, s2 = GATHER_G ? g.h : g.oh, s3 = GATHER_G ? g.w : g.ow;
  const int64_t p_begin = (int64_t)blockIdx.y * chunk;
  const int64_t p_end = p_begin + chunk < positions ? p_begin + chunk : positions;
  float acc = 0.f;
  for (int64_t pb = p_begin; pb < p_end; pb += tile) {
    const int nt = (int)(p_end - pb < tile ? p_end - pb : tile);
    if (threadIdx.x < tile) {
      int64_t p = pb + threadIdx.x;
      if (threadIdx.x < nt) {
        pos[threadIdx.x][3] = (int)(p % s3); p /= s3;
        pos[threadIdx.x][2] = (int)(p % s2); p /= s2;
        pos[threadIdx.x][1] = (int)(p % s1); p /= s1;
        pos[threadIdx.x][0] = (int)p;
      }
    }
    __syncthreads();
    // direct operand: every channel of each staged position, read straight
    const T* dsrc = GATHER_G ? x : gy;
    for (int i = threadIdx.x; i < tile * cd; i += kThreads) {
      const int t = i / cd;
      ds[i] = t < nt ? to_f32(dsrc[(pb + t) * cd + (i - t * cd)]) : 0.f;
    }
    // gathered operand: the tile's columns at each staged position
    for (int i = threadIdx.x; i < tile * width; i += kThreads) {
      const int t = (int)(i / width);
      const int64_t col_g = c0 + (i - (int64_t)t * width);
      float v = 0.f;
      if (t < nt && col_g < (int64_t)taps * cg) {
        const int tap = (int)(col_g / cg), ch = (int)(col_g % cg);
        const int kw = tap % g.kw, kh = (tap / g.kw) % g.kh, kd = tap / (g.kw * g.kh);
        const int n = pos[t][0];
        if (GATHER_G) {
          // input element (a, b, c) meets output a*dil + pad - k (stride 1)
          const int od = pos[t][1] * g.dil + g.pd - kd;
          const int oh = pos[t][2] * g.dil + g.ph - kh;
          const int ow = pos[t][3] * g.dil + g.pw - kw;
          if (od >= 0 && od < g.od && oh >= 0 && oh < g.oh && ow >= 0 && ow < g.ow)
            v = to_f32(gy[((((int64_t)n * g.od + od) * g.oh + oh) * g.ow + ow) * g.co + ch]);
        } else {
          // output (a, b, c) reads dilated input a*s + k - pad, if on the grid
          const int zd = pos[t][1] * g.stride + kd - g.pd;
          const int zh = pos[t][2] * g.stride + kh - g.ph;
          const int zw = pos[t][3] * g.stride + kw - g.pw;
          if (zd >= 0 && zh >= 0 && zw >= 0 && zd % g.dil == 0 && zh % g.dil == 0 &&
              zw % g.dil == 0) {
            const int id = zd / g.dil, ih = zh / g.dil, iw = zw / g.dil;
            if (id < g.d && ih < g.h && iw < g.w)
              v = to_f32(x[((((int64_t)n * g.d + id) * g.h + ih) * g.w + iw) * g.ci + ch]);
          }
        }
      }
      gs[(int64_t)t * max_width + (i - (int64_t)t * width)] = v;
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < nt; ++t) acc = fmaf(gs[t * max_width + col], ds[t * cd + dch], acc);
    }
    __syncthreads();
  }
  if (active) partial[(int64_t)blockIdx.y * n_weights + wi] = acc;
}

// dw[w] = sum over splits, in split order (deterministic)
__global__ void conv3d_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                        int64_t n_weights, int splits) {
  const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_weights) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += partial[(int64_t)k * n_weights + w];
  dw[w] = s;
}

template <typename T>
cudaError_t launch(bool gather_g, const void* x, const void* gy, float* partial, float* dw,
                   const Geometry& g, int splits, cudaStream_t stream) {
  const int64_t taps = (int64_t)g.kd * g.kh * g.kw;
  const int64_t n_weights = taps * g.ci * g.co;
  const int64_t positions = gather_g ? (int64_t)g.n * g.d * g.h * g.w
                                     : (int64_t)g.n * g.od * g.oh * g.ow;
  const int64_t tiles = (n_weights + kThreads - 1) / kThreads;
  // widest gathered column range of any block: sizes the shared memory
  int64_t max_width = 0;
  for (int64_t b = 0; b < tiles; ++b) {
    int64_t c0, width;
    const int64_t w0 = b * kThreads;
    const int64_t w1 = w0 + kThreads < n_weights ? w0 + kThreads : n_weights;
    tile_columns(g, gather_g, w0, w1, &c0, &width);
    if (width > max_width) max_width = width;
  }
  const int64_t per_pos = max_width + direct_ch(g, gather_g);
  int64_t tile = kSmemFloats / per_pos;
  if (tile > kMaxTile) tile = kMaxTile;
  if (tile < 1 || tiles > 0x7fffffff || splits < 1 || splits > 65535)
    return cudaErrorInvalidValue;
  const int64_t chunk = (positions + splits - 1) / splits;
  const size_t smem = (size_t)(tile * per_pos) * sizeof(float);
  const dim3 grid((unsigned)tiles, (unsigned)splits);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gy);
  if (gather_g) {
    conv3d_dw_partial_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        xt, gt, partial, g, positions, chunk, (int)tile, (int)max_width);
  } else {
    conv3d_dw_partial_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        xt, gt, partial, g, positions, chunk, (int)tile, (int)max_width);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rblocks = (n_weights + 255) / 256;
  conv3d_dw_reduce_kernel<<<(unsigned)rblocks, 256, 0, stream>>>(partial, dw, n_weights, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  `partial` is f32 scratch of
// splits * KD*KH*KW*Ci*Co elements, `dw` the f32 output; both allocated by
// the caller.  gather_g (the input-position order) needs stride 1.
// Returns the cudaError_t of the launches (0 on success); asynchronous on
// `stream`.
extern "C" int conv3d_dw(int dtype, int gather_g, const void* x, const void* gy, void* partial,
                         void* dw, int n, int d, int h, int w_in, int ci, int od, int oh, int ow,
                         int co, int kd, int kh, int kw, int stride, int dil, int pd, int ph,
                         int pw, int splits, void* stream) {
  const Geometry g{n, d, h, w_in, ci, od, oh, ow, co, kd, kh, kw, stride, dil, pd, ph, pw};
  if (stride < 1 || dil < 1 || (gather_g && stride != 1)) return (int)cudaErrorInvalidValue;
  if ((int64_t)kd * kh * kw * ci * co == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* dt = static_cast<float*>(dw);
  switch (dtype) {
    case kF32: return (int)launch<float>(gather_g != 0, x, gy, pt, dt, g, splits, s);
    case kBF16: return (int)launch<__nv_bfloat16>(gather_g != 0, x, gy, pt, dt, g, splits, s);
    case kF16: return (int)launch<__half>(gather_g != 0, x, gy, pt, dt, g, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
