// Direct 3-D convolution with a fused bias + activation epilogue, NDHWC
// activations and DHWIO weights:
//
//   y[n, od, oh, ow, co] = act(b[co] + sum_{kd,kh,kw,ci}
//       xp[n, od*s + kd, oh*s + kh, ow*s + kw, ci] * w[kd, kh, kw, ci, co])
//
// where xp is x dilated by `dil` (dil - 1 zeros between elements) and padded
// by the low pads (pd, ph, pw); a negative pad crops.  The high pads only
// set the output size, which the caller computes.
//
// Replaces the TPU kernel `_fused_conv_kernel` of
// src/repro/kernels/conv3d/conv3d.py (pallas_call in `_conv_core`): the one
// kernel behind the forward conv, the transposed conv (dil = stride,
// stride 1) and, in the training slice, both dx routes.
//
// What bounds it: at the 3DGAN generator's shapes a layer does a few
// hundred useful multiply-adds per output element and stores an output
// much larger than its input, so at bf16 the work is bound by the bytes
// it moves, at f32 on the CUDA cores by bytes and operations about
// equally (PERF.md gives the numbers per layer).
//
// This first design is simple and right, not fast: one thread per output
// element, f32 accumulation in a register, dilation and padding by index
// math (a tap is read only when its dilated coordinate falls on a real
// input element, so the dilated input is never built and zero taps cost
// no loads), bias and activation in f32 in the epilogue, one rounding at
// the store.  It does nothing about reuse: each thread reads its taps and
// weights through L1/L2, neighbouring threads (neighbouring co) read the
// same input element and neighbouring weights.  Tiling in shared memory,
// wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kNone = 0, kLeakyRelu = 1, kSoftplus = 2 };
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) { return __float2half_rn(v); }

struct Geometry {
  int n, d, h, w, ci;   // input
  int od, oh, ow, co;   // output
  int kd, kh, kw;       // taps
  int stride, dil;
  int pd, ph, pw;       // low pads of the dilated input (negative crops)
};

template <typename T, int ACT>
__global__ void conv3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                                  const T* __restrict__ b, T* __restrict__ y,
                                  Geometry g, float slope) {
  const int64_t total = (int64_t)g.n * g.od * g.oh * g.ow * g.co;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    int64_t t = i;
    const int co = (int)(t % g.co); t /= g.co;
    const int ow = (int)(t % g.ow); t /= g.ow;
    const int oh = (int)(t % g.oh); t /= g.oh;
    const int od = (int)(t % g.od); t /= g.od;
    const int n = (int)t;
    float acc = 0.f;
    for (int kd = 0; kd < g.kd; ++kd) {
      const int zd = od * g.stride + kd - g.pd;     // coordinate in the dilated input
      if (zd < 0 || zd % g.dil != 0) continue;
      const int id = zd / g.dil;
      if (id >= g.d) continue;
      for (int kh = 0; kh < g.kh; ++kh) {
        const int zh = oh * g.stride + kh - g.ph;
        if (zh < 0 || zh % g.dil != 0) continue;
        const int ih = zh / g.dil;
        if (ih >= g.h) continue;
        for (int kw = 0; kw < g.kw; ++kw) {
          const int zw = ow * g.stride + kw - g.pw;
          if (zw < 0 || zw % g.dil != 0) continue;
          const int iw = zw / g.dil;
          if (iw >= g.w) continue;
          const T* xp = x + ((((int64_t)n * g.d + id) * g.h + ih) * g.w + iw) * g.ci;
          const T* wp = wt + ((int64_t)((kd * g.kh + kh) * g.kw + kw) * g.ci) * g.co + co;
          for (int c = 0; c < g.ci; ++c) {
            acc = fmaf(to_f32(xp[c]), to_f32(wp[(int64_t)c * g.co]), acc);
          }
        }
      }
    }
    float v = acc + to_f32(b[co]);
    if (ACT == kLeakyRelu) {
      v = v >= 0.f ? v : v * slope;
    } else if (ACT == kSoftplus) {
      v = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    }
    y[i] = from_f32<T>(v);
  }
}

template <typename T>
cudaError_t launch(int act, const void* x, const void* w, const void* b, void* y,
                   const Geometry& g, float slope, cudaStream_t stream) {
  const int64_t total = (int64_t)g.n * g.od * g.oh * g.ow * g.co;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 30) blocks = (int64_t)1 << 30;  // grid-stride loop covers the rest
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  switch (act) {
    case kNone:
      conv3d_fwd_kernel<T, kNone><<<(unsigned)blocks, threads, 0, stream>>>(xt, wt, bt, yt, g, slope);
      break;
    case kLeakyRelu:
      conv3d_fwd_kernel<T, kLeakyRelu><<<(unsigned)blocks, threads, 0, stream>>>(xt, wt, bt, yt, g, slope);
      break;
    case kSoftplus:
      conv3d_fwd_kernel<T, kSoftplus><<<(unsigned)blocks, threads, 0, stream>>>(xt, wt, bt, yt, g, slope);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns the cudaError_t of the
// launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int conv3d_fwd(int dtype, int act, const void* x, const void* w, const void* b,
                          void* y, int n, int d, int h, int w_in, int ci, int od, int oh,
                          int ow, int co, int kd, int kh, int kw, int stride, int dil,
                          int pd, int ph, int pw, float slope, void* stream) {
  const Geometry g{n, d, h, w_in, ci, od, oh, ow, co, kd, kh, kw, stride, dil, pd, ph, pw};
  if ((int64_t)n * od * oh * ow * co == 0) return (int)cudaSuccess;
  if (stride < 1 || dil < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch<float>(act, x, w, b, y, g, slope, s);
    case kBF16: return (int)launch<__nv_bfloat16>(act, x, w, b, y, g, slope, s);
    case kF16: return (int)launch<__half>(act, x, w, b, y, g, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
