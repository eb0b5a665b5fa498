// Causal or windowed attention with GQA over a whole sequence (the
// training forward), emitting O and the per-row f32 log-sum-exp.
//
//   q (B, S, H, D), k/v (B, T, KH, D), H = KH * G.  Query i sees key t
//   when t < T, t <= i (causal) and, with a window, t > i - window.
//   out (B, S, H, D) in q's dtype; lse (B, S, H) f32, head kh * G + g, the
//   residual the backward kernels (flash_bwd.cu) rebuild the
//   probabilities from.  A row that sees no key is exact 0 with
//   lse = -1e30 + log(1e-30), as in the TPU kernel.
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py (pallas_call in
// `flash_attention_fwd`).
//
// One block owns (q tile, KV head h, row b).  Like the TPU kernel it packs
// the tile's block_q queries times the G query heads of KV head h into
// R = block_q * G score rows (row r is query r / G, head r % G), so each
// K/V tile it reads serves all of them.  Where the TPU walks the KV tiles
// as a sequential grid axis with (acc, m, l) in VMEM scratch, the block
// loops over them itself, from the window's first tile up to the causal
// diagonal of its last query: tiles that the mask leaves empty are never
// read.  Scores, running max and denominator and the accumulator are f32;
// the output rounds once at the store.
//
// What bounds it: 4 * D flops per visible (query head, key) pair against
// one read of q, k, v and one write of out; at the training shapes
// (S = T = 256, G = 6, D = 128, f32) each K/V tile is reused by 60 rows,
// so it is bound by operations on the CUDA cores.  The design is the
// serving chunk kernel's (flash_chunk.cu): Q (transposed), a K tile
// (transposed), a V tile and the tile's probabilities in shared memory,
// and each of the 256 threads owns a register tile of 4 score rows: 4 x 4
// scores (keys tx + 16c) in the QK^T step and 4 x D/16 outputs (columns
// tx + 16n) in the P.V step, so each shared-memory load feeds 3-4
// multiply-adds.  The 16 threads of a row group share its running max and
// sum by warp shuffles.  Tensor cores (wgmma), TMA and double-buffered
// tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // R = block_q * G score rows per block, at most
constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kThreads = 256;    // 16 row groups (ty) x 16 lanes (tx)
constexpr int kQS = kRows + 4;   // row stride of qT and pT (float4-aligned)
constexpr int kKS = kKeys + 1;   // row stride of kT (no bank conflicts)

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

struct Shape {
  int B, S, T, H, KH, D, G;
  int block_q;     // queries per block; R = block_q * G rows
  int causal;      // 0 or 1
  int window;      // 0: none
  float scale;     // 1 / sqrt(D)
};

inline size_t fwd_smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * kQS      // qT  [D][kQS]
                          + (size_t)D * kKS    // kT  [D][kKS]
                          + (size_t)kKeys * D  // v   [kKeys][D]
                          + (size_t)kKeys * kQS);  // pT [kKeys][kQS]
}

__device__ __forceinline__ float group_max(float v) {   // over the 16 lanes of tx
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Shape sh) {
  constexpr int NC = D / 16;     // output columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + D * kQS;
  float* v_s = kT + D * kKS;
  float* pT = v_s + kKeys * D;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = sh.G, tid = threadIdx.x, tx = tid % 16, r0 = (tid / 16) * 4;
  const int R = sh.block_q * G;
  const int q_start = qt * sh.block_q;
  const int q_end = min(q_start + sh.block_q, sh.S);      // exclusive

  // Q, transposed (row r is query q_start + r / G, head h * G + r % G)
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q_start + r / G;
    qT[d * kQS + r] = (r < R && qi < sh.S)
        ? to_f32(q[(((size_t)b * sh.S + qi) * sh.H + h * G + r % G) * D + d]) : 0.f;
  }
  int qpos[4];
  bool live[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + u, qi = q_start + r / G;
    live[u] = r < R && qi < sh.S;
    qpos[u] = qi;
    m[u] = -1e30f;
    l[u] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[u][n] = 0.f;
  }
  // keys any row of the tile may see: [lo, hi)
  const int hi = sh.causal ? min(sh.T, q_end) : sh.T;
  const int lo = sh.window ? max(0, q_start - sh.window + 1) : 0;
  __syncthreads();

  for (int t0 = (lo / kKeys) * kKeys; t0 < hi; t0 += kKeys) {
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i % D, p = t0 + j;
      const bool in = p < hi;
      const size_t o = (((size_t)b * sh.T + p) * sh.KH + h) * D + d;
      kT[d * kKS + j] = in ? to_f32(k[o]) : 0.f;
      v_s[j * D + d] = in ? to_f32(v[o]) : 0.f;
    }
    __syncthreads();
    // scores of rows r0..r0+3 against keys tx + 16c
    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[u][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * kQS + r0);
      const float* kr = kT + d * kKS + tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kv = kr[16 * c];
        s[0][c] = fmaf(qv.x, kv, s[0][c]);
        s[1][c] = fmaf(qv.y, kv, s[1][c]);
        s[2][c] = fmaf(qv.z, kv, s[2][c]);
        s[3][c] = fmaf(qv.w, kv, s[3][c]);
      }
    }
    // mask, online softmax (f32), probabilities to pT, rescale the outputs
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = t0 + tx + 16 * c;
        const bool vis = live[u] && p < sh.T && (!sh.causal || p <= qpos[u]) &&
                         (sh.window == 0 || p > qpos[u] - sh.window);
        s[u][c] = vis ? s[u][c] * sh.scale : -INFINITY;
        mx = fmaxf(mx, s[u][c]);
      }
      const float m_new = fmaxf(m[u], group_max(mx));
      const float alpha = expf(m[u] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[u][c] - m_new);     // 0 where masked
        pT[(tx + 16 * c) * kQS + r0 + u] = e;
        sum += e;
      }
      l[u] = l[u] * alpha + group_sum(sum);
      m[u] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[u][n] *= alpha;
    }
    __syncthreads();
    // outputs of rows r0..r0+3, columns tx + 16n
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(pT + j * kQS + r0);
      const float* vr = v_s + j * D + tx;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float vv = vr[16 * n];
        acc[0][n] = fmaf(pv.x, vv, acc[0][n]);
        acc[1][n] = fmaf(pv.y, vv, acc[1][n]);
        acc[2][n] = fmaf(pv.z, vv, acc[2][n]);
        acc[3][n] = fmaf(pv.w, vv, acc[3][n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!live[u]) continue;
    const int r = r0 + u;
    const size_t row = ((size_t)b * sh.S + qpos[u]) * sh.H + h * G + r % G;
    const float den = fmaxf(l[u], 1e-30f);
    T* o = out + row * D + tx;
#pragma unroll
    for (int n = 0; n < NC; ++n) o[16 * n] = from_f32<T>(acc[u][n] / den);
    if (tx == 0) lse[row] = m[u] + logf(den);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse,
                     const Shape& sh, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((sh.S + sh.block_q - 1) / sh.block_q, sh.KH, sh.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   const Shape& sh, cudaStream_t stream) {
  switch (sh.D) {
    case 16: return launch_d<T, 16>(q, k, v, out, lse, sh, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, lse, sh, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, lse, sh, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, lse, sh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  out is (B, S, H, D) in q's
// dtype, lse (B, S, H) f32.  block_q * (H / KH) must be at most kRows
// (64), and D one of 16, 32, 64, 128.  Returns the cudaError_t of the
// launch (0 on success); it runs asynchronously on `stream`.
extern "C" int flash_fwd(int dtype, const void* q, const void* k, const void* v, void* out,
                         float* lse, int B, int S, int T, int H, int KH, int D, int block_q,
                         int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || block_q <= 0 ||
      block_q * (H / KH) > kRows || window < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, H, KH, D, H / KH, block_q, causal ? 1 : 0, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch<float>(q, k, v, out, lse, sh, s);
    case kBF16: return (int)launch<__nv_bfloat16>(q, k, v, out, lse, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
