// Split-KV single-query decode attention against a ragged KV cache, and the
// log-sum-exp merge of its splits.
//
//   q (B, 1, H, D), k/v (B, T, KH, D) at cache capacity T, kv_len (B,) int32;
//   the query of row b sits at position kv_len[b] - 1 and sees key t when
//   t < kv_len[b] and, with a window, t > kv_len[b] - 1 - window.
//   H = KH * G: query head h * G + g reads KV head h (GQA).
//
// Replaces the TPU kernel `_decode_kernel` of
// src/repro/kernels/flash_attention/decode.py (pallas_call in
// `flash_decode`) and the pure-JAX `combine_splits` after it.
//
// Pass 1, `flash_decode_kernel`: one block owns (split s, KV head h, row b)
// and walks its split's positions itself, in tiles of kTile, where the TPU
// walks them as a sequential grid axis with scratch carried across it.  The
// G query heads of KV head h are loaded once and every K/V tile the block
// reads serves all G of them.  Tiles at or past kv_len[b] (or wholly below
// the window) are never read, so a short row costs only its live
// positions.  Each split writes its UNNORMALISED partials: acc (G, D),
// running max m (G) and denominator l (G), in f32; a split with no live
// position writes (0, -1e30, 0).
// Pass 2, `combine_kernel`: a second small kernel (one block per query
// head and row, a thread per output column) merges the splits:
// o = sum_s acc_s w_s / sum_s l_s w_s with w_s = exp(m_s - max m) and
// w_s = 0 where l_s = 0, so an empty split adds exactly nothing; it rounds
// once to q's dtype at the store.
//
// The split length is set by the caller from the cache capacity T and D
// alone (repro_torch/kernels/flash_attention/decode.py), never from other
// rows' kv_len: a row's result does not depend on its neighbours.
//
// What bounds it: it reads K and V of the live positions once and does
// 4 * G * D flops per position and head, ~3 flops per byte in f32, far
// under the card's balance point, so its bound is bytes: K and V of the
// live positions over HBM's rate.  This first design is simple and right:
// scores, softmax and P.V on the CUDA cores from shared memory (f32), one
// pass over the live K/V.  Tensor cores (wgmma), TMA and double-buffered
// tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // positions per K/V tile in shared memory
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int B, T, H, KH, D, G;
  int split;       // positions per split
  int n_splits;
  int window;      // 0: none
  float scale;     // 1 / sqrt(D)
};

__host__ __device__ inline size_t decode_smem_floats(int G, int D) {
  return (size_t)G * D               // q
         + (size_t)G * D             // acc
         + (size_t)kTile * (D + 1)   // k (rows padded: no bank conflicts)
         + (size_t)kTile * D         // v
         + (size_t)G * kTile         // scores, then probabilities
         + 3 * (size_t)G;            // m, l, alpha
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ acc_out, float* __restrict__ m_out,
                    float* __restrict__ l_out, Shape sh) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = sh.G, D = sh.D, tid = threadIdx.x;
  float* q_s = smem;
  float* acc_s = q_s + G * D;
  float* k_s = acc_s + G * D;
  float* v_s = k_s + kTile * (D + 1);
  float* p_s = v_s + kTile * D;
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int len = kv_len[b];
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[i] = to_f32(q[((size_t)b * sh.H + h * G + g) * D + d]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // live positions of this split: [lo, hi)
  const int start = s * sh.split;
  const int hi = min(start + sh.split, min(len, sh.T));
  const int lo = sh.window ? max(start, len - sh.window) : start;
  __syncthreads();

  for (int t0 = start; t0 < hi; t0 += kTile) {
    if (t0 + kTile <= lo) continue;            // wholly below the window
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int j = i / D, d = i % D, p = t0 + j;
      const bool live = p >= lo && p < hi;
      const size_t off = (((size_t)b * sh.T + p) * sh.KH + h) * D + d;
      k_s[j * (D + 1) + d] = live ? to_f32(k[off]) : 0.f;
      v_s[j * D + d] = live ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, j = i % kTile, p = t0 + j;
      float acc = 0.f;
      const float* qr = q_s + g * D;
      const float* kr = k_s + j * (D + 1);
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      p_s[i] = (p >= lo && p < hi) ? acc * sh.scale : kNegInf;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float* pr = p_s + g * kTile;
      float mx = kNegInf;
      for (int j = 0; j < kTile; ++j) mx = fmaxf(mx, pr[j]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < kTile; ++j) {
        const int p = t0 + j;
        const float e = (p >= lo && p < hi) ? expf(pr[j] - m_new) : 0.f;
        pr[j] = e;
        sum += e;
      }
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      a_s[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = p_s + g * kTile;
      float pv = 0.f;
      for (int j = 0; j < kTile; ++j) pv = fmaf(pr[j], v_s[j * D + d], pv);
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
    __syncthreads();
  }

  const size_t part = ((size_t)b * sh.KH + h) * sh.n_splits + s;   // (B, KH, S)
  for (int i = tid; i < G * D; i += kThreads) acc_out[part * G * D + i] = acc_s[i];
  for (int g = tid; g < G; g += kThreads) {
    m_out[part * G + g] = m_s[g];
    l_out[part * G + g] = l_s[g];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
               const float* __restrict__ l, T* __restrict__ out, Shape sh) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = sh.G, D = sh.D, S = sh.n_splits;
  const size_t base = ((size_t)b * sh.KH + h) * S;     // first split of (b, h)
  float m_glob = kNegInf;
  for (int s = 0; s < S; ++s) m_glob = fmaxf(m_glob, m[(base + s) * G + g]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ls = l[(base + s) * G + g];
      const float w = ls > 0.f ? expf(m[(base + s) * G + g] - m_glob) : 0.f;
      den += ls * w;
      num += acc[((base + s) * G + g) * D + d] * w;
    }
    out[((size_t)b * sh.H + h * G + g) * D + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len,
                   float* acc, float* m, float* l, void* out, const Shape& sh,
                   cudaStream_t stream) {
  const size_t smem = decode_smem_floats(sh.G, sh.D) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  flash_decode_kernel<T><<<dim3(sh.n_splits, sh.KH, sh.B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      acc, m, l, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<T><<<dim3(sh.G, sh.KH, sh.B), kThreads, 0, stream>>>(
      acc, m, l, static_cast<T*>(out), sh);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes.  acc (B, KH, S, G, D), m and l
// (B, KH, S, G) are f32 scratch the caller allocates; out is (B, 1, H, D)
// in q's dtype.  Returns the cudaError_t of the launches (0 on success);
// both run asynchronously on `stream`.
extern "C" int flash_decode(int dtype, const void* q, const void* k, const void* v,
                            const int* kv_len, float* acc, float* m, float* l, void* out,
                            int B, int T, int H, int KH, int D, int split, int n_splits,
                            int window, float scale, void* stream) {
  if (B <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || split <= 0 ||
      n_splits <= 0 || (long long)split * n_splits < T || window < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, T, H, KH, D, H / KH, split, n_splits, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch<float>(q, k, v, kv_len, acc, m, l, out, sh, s);
    case kBF16: return (int)launch<__nv_bfloat16>(q, k, v, kv_len, acc, m, l, out, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
