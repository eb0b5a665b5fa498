// The backward of causal or windowed GQA attention (flash-2 recompute):
// dq, and dk/dv summed over the G query heads of each KV head.
//
//   q, dout (B, S, H, D), k/v (B, T, KH, D), H = KH * G; lse and delta
//   (B, S, H) f32, head kh * G + g: lse from the forward (flash_fwd.cu),
//   delta = rowsum(dout * out) in f32, computed by the wrapper.  Each tile
//   rebuilds its probabilities p = exp(s * scale - lse) from the same
//   score product as the forward, exactly 0 where the mask hides a key
//   (the score there is never exponentiated), and
//   ds = p * (dout . v - delta) * scale.  Then dq = ds . k, dv = p^T . dout
//   and dk = ds^T . q, all accumulated in f32 and rounded once at the store.
//   Masks as in the forward: t < T, t <= i (causal), t > i - window.
//
// Replaces the TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` of src/repro/kernels/flash_attention/
// flash_attention.py (pallas_calls in `flash_attention_bwd`).
//
// dq: one block owns (q tile, KV head h, row b) and loops over the KV
// tiles its rows see, where the TPU walks them as a sequential grid axis
// with the dq accumulator in VMEM.  It packs block_q queries times the G
// heads into R = block_q * G <= 64 rows as the forward does; each of the
// 256 threads owns 4 rows x 4 keys of s and dp (one pass over D for both),
// then 4 rows x D/16 columns of dq.
//
// dk/dv: one block owns (KV tile of 32 keys, KV head h, row b) and loops
// over the q tiles (all G heads of each) that see its keys, where the TPU
// walks them as the sequential grid axis with dk/dv in VMEM: the sum over
// the G heads happens inside the block, so no atomics and no second pass,
// and a step is reproducible bit for bit.  Each thread owns 2 keys x 4
// rows of s and dp, then 2 keys x D/16 columns of dk and dv.  Tiles of 32
// keys give 128 blocks at the training shapes (B 8, T 256, KH 2), about
// one per SM.
//
// What bounds them: the score product is redone (dq: 3 products of
// 2 * D flops per visible pair, dk/dv: 4), against one read of q, k, v,
// dout, lse, delta and one write of each gradient; at the training
// shapes (S = T = 256, G = 6, D = 128, f32) both are bound by operations
// on the CUDA cores.  Both kernels skip the tiles that the causal mask or
// the window leaves empty.  Tensor cores (wgmma), TMA and double-buffered
// tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;        // R = block_q * G rows of a q tile, at most
constexpr int kThreads = 256;    // 16 groups (ty) x 16 lanes (tx)
// dq kernel
constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kQS = kRows + 4;   // row stride of qT, doT, dsT (float4-aligned)
constexpr int kKS = kKeys + 1;   // row stride of kT, vT (no bank conflicts)
// dk/dv kernel
constexpr int kKeysB = 32;       // keys per block
constexpr int kKB = kKeysB + 4;  // row stride of kT, vT (float2-aligned)
constexpr int kRB = kRows + 1;   // row stride of qT, doT (no bank conflicts)
constexpr int kPB = kKeysB + 2;  // row stride of p and ds (float2-aligned)

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
  int block_q;     // queries per q tile; R = block_q * G rows
  int causal;      // 0 or 1
  int window;      // 0: none
  float scale;     // 1 / sqrt(D)
};

__device__ __forceinline__ bool visible(const Shape& sh, int qi, int p) {
  return p < sh.T && (!sh.causal || p <= qi) && (sh.window == 0 || p > qi - sh.window);
}

inline size_t dq_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)D * kQS      // qT, doT [D][kQS]
                          + 2 * (size_t)D * kKS    // kT, vT  [D][kKS]
                          + (size_t)kKeys * kQS);  // dsT     [kKeys][kQS]
}

inline size_t dkv_smem_bytes(int D) {
  return sizeof(float) * (2 * (size_t)D * kKB       // kT, vT  [D][kKB]
                          + 2 * (size_t)kRows * kPB // p, ds   [kRows][kPB]
                          + 2 * (size_t)D * kRB     // qT, doT [D][kRB]
                          + 2 * (size_t)kRows);     // lse, delta
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, Shape sh) {
  constexpr int NC = D / 16;     // dq columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* doT = qT + D * kQS;
  float* kT = doT + D * kQS;
  float* vT = kT + D * kKS;
  float* dsT = vT + D * kKS;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = sh.G, tid = threadIdx.x, tx = tid % 16, r0 = (tid / 16) * 4;
  const int R = sh.block_q * G;
  const int q_start = qt * sh.block_q;
  const int q_end = min(q_start + sh.block_q, sh.S);      // exclusive

  // Q and dO, transposed (row r is query q_start + r / G, head h * G + r % G)
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q_start + r / G;
    const bool in = r < R && qi < sh.S;
    const size_t o = (((size_t)b * sh.S + qi) * sh.H + h * G + r % G) * D + d;
    qT[d * kQS + r] = in ? to_f32(q[o]) : 0.f;
    doT[d * kQS + r] = in ? to_f32(dout[o]) : 0.f;
  }
  int qpos[4];
  bool live[4];
  float row_lse[4], row_delta[4], acc[4][NC];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = r0 + u, qi = q_start + r / G;
    live[u] = r < R && qi < sh.S;
    qpos[u] = qi;
    const size_t row = ((size_t)b * sh.S + qi) * sh.H + h * G + r % G;
    row_lse[u] = live[u] ? lse[row] : 0.f;
    row_delta[u] = live[u] ? delta[row] : 0.f;
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
      vT[d * kKS + j] = in ? to_f32(v[o]) : 0.f;
    }
    __syncthreads();
    // s = q . k and dp = dout . v of rows r0..r0+3 against keys tx + 16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[u][c] = dp[u][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * kQS + r0);
      const float4 gv = *reinterpret_cast<const float4*>(doT + d * kQS + r0);
      const float* kr = kT + d * kKS + tx;
      const float* vr = vT + d * kKS + tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float kk = kr[16 * c], vv = vr[16 * c];
        s[0][c] = fmaf(qv.x, kk, s[0][c]);
        s[1][c] = fmaf(qv.y, kk, s[1][c]);
        s[2][c] = fmaf(qv.z, kk, s[2][c]);
        s[3][c] = fmaf(qv.w, kk, s[3][c]);
        dp[0][c] = fmaf(gv.x, vv, dp[0][c]);
        dp[1][c] = fmaf(gv.y, vv, dp[1][c]);
        dp[2][c] = fmaf(gv.z, vv, dp[2][c]);
        dp[3][c] = fmaf(gv.w, vv, dp[3][c]);
      }
    }
    // p (0 where masked), ds to dsT
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = t0 + tx + 16 * c;
        const float pr = (live[u] && visible(sh, qpos[u], p))
            ? expf(s[u][c] * sh.scale - row_lse[u]) : 0.f;
        dsT[(tx + 16 * c) * kQS + r0 + u] = pr * (dp[u][c] - row_delta[u]) * sh.scale;
      }
    __syncthreads();
    // dq of rows r0..r0+3, columns tx + 16n
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      const float4 dv = *reinterpret_cast<const float4*>(dsT + j * kQS + r0);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float kk = kT[(tx + 16 * n) * kKS + j];
        acc[0][n] = fmaf(dv.x, kk, acc[0][n]);
        acc[1][n] = fmaf(dv.y, kk, acc[1][n]);
        acc[2][n] = fmaf(dv.z, kk, acc[2][n]);
        acc[3][n] = fmaf(dv.w, kk, acc[3][n]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (!live[u]) continue;
    const int r = r0 + u;
    T* o = dq + (((size_t)b * sh.S + qpos[u]) * sh.H + h * G + r % G) * D + tx;
#pragma unroll
    for (int n = 0; n < NC; ++n) o[16 * n] = from_f32<T>(acc[u][n]);
  }
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, Shape sh) {
  constexpr int NC = D / 16;     // dk / dv columns per thread
  extern __shared__ float4 smem4[];
  float* kT = reinterpret_cast<float*>(smem4);
  float* vT = kT + D * kKB;
  float* p_s = vT + D * kKB;
  float* ds_s = p_s + kRows * kPB;
  float* qT = ds_s + kRows * kPB;
  float* doT = qT + D * kRB;
  float* lse_s = doT + D * kRB;
  float* dl_s = lse_s + kRows;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = sh.G, tid = threadIdx.x, tx = tid % 16, j0 = (tid / 16) * 2;
  const int R = sh.block_q * G;
  const int k_start = kt * kKeysB;
  const int k_end = min(k_start + kKeysB, sh.T);          // exclusive

  // this block's K and V, transposed (column j is key k_start + j)
  for (int i = tid; i < kKeysB * D; i += kThreads) {
    const int j = i / D, d = i % D, p = k_start + j;
    const bool in = p < k_end;
    const size_t o = (((size_t)b * sh.T + p) * sh.KH + h) * D + d;
    kT[d * kKB + j] = in ? to_f32(k[o]) : 0.f;
    vT[d * kKB + j] = in ? to_f32(v[o]) : 0.f;
  }
  float dk_acc[2][NC], dv_acc[2][NC];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk_acc[u][n] = dv_acc[u][n] = 0.f;
  // queries that may see a key of this block: [q_lo, q_hi)
  const int q_lo = sh.causal ? k_start : 0;
  const int q_hi = sh.window ? min(sh.S, k_end - 1 + sh.window) : sh.S;

  for (int q_start = (q_lo / sh.block_q) * sh.block_q; q_start < q_hi;
       q_start += sh.block_q) {
    __syncthreads();       // the previous tile's reads of qT, doT, p, ds are done
    // Q and dO of the tile, transposed (row r: query q_start + r / G, head h * G + r % G)
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, d = i % D, qi = q_start + r / G;
      const bool in = r < R && qi < sh.S;
      const size_t o = (((size_t)b * sh.S + qi) * sh.H + h * G + r % G) * D + d;
      qT[d * kRB + r] = in ? to_f32(q[o]) : 0.f;
      doT[d * kRB + r] = in ? to_f32(dout[o]) : 0.f;
    }
    for (int r = tid; r < kRows; r += kThreads) {
      const int qi = q_start + r / G;
      const bool in = r < R && qi < sh.S;
      const size_t row = ((size_t)b * sh.S + qi) * sh.H + h * G + r % G;
      lse_s[r] = in ? lse[row] : 0.f;
      dl_s[r] = in ? delta[row] : 0.f;
    }
    __syncthreads();
    // s^T = k . q and dp^T = v . dout of keys j0, j0+1 against rows tx + 16c
    float s[2][4], dp[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[u][c] = dp[u][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float2 kv = *reinterpret_cast<const float2*>(kT + d * kKB + j0);
      const float2 vv = *reinterpret_cast<const float2*>(vT + d * kKB + j0);
      const float* qr = qT + d * kRB + tx;
      const float* gr = doT + d * kRB + tx;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float qq = qr[16 * c], gg = gr[16 * c];
        s[0][c] = fmaf(kv.x, qq, s[0][c]);
        s[1][c] = fmaf(kv.y, qq, s[1][c]);
        dp[0][c] = fmaf(vv.x, gg, dp[0][c]);
        dp[1][c] = fmaf(vv.y, gg, dp[1][c]);
      }
    }
    // p (0 where masked) and ds, row-major [r][j]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = tx + 16 * c, qi = q_start + r / G;
      const bool live = r < R && qi < sh.S;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float pr = (live && visible(sh, qi, k_start + j0 + u))
            ? expf(s[u][c] * sh.scale - lse_s[r]) : 0.f;
        p_s[r * kPB + j0 + u] = pr;
        ds_s[r * kPB + j0 + u] = pr * (dp[u][c] - dl_s[r]) * sh.scale;
      }
    }
    __syncthreads();
    // dv += p^T . dout and dk += ds^T . q over the tile's rows
    for (int r = 0; r < R; ++r) {
      const float2 pv = *reinterpret_cast<const float2*>(p_s + r * kPB + j0);
      const float2 sv = *reinterpret_cast<const float2*>(ds_s + r * kPB + j0);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const float gg = doT[(tx + 16 * n) * kRB + r];
        const float qq = qT[(tx + 16 * n) * kRB + r];
        dv_acc[0][n] = fmaf(pv.x, gg, dv_acc[0][n]);
        dv_acc[1][n] = fmaf(pv.y, gg, dv_acc[1][n]);
        dk_acc[0][n] = fmaf(sv.x, qq, dk_acc[0][n]);
        dk_acc[1][n] = fmaf(sv.y, qq, dk_acc[1][n]);
      }
    }
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int p = k_start + j0 + u;
    if (p >= k_end) continue;
    const size_t o = (((size_t)b * sh.T + p) * sh.KH + h) * D + tx;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      dk[o + 16 * n] = from_f32<T>(dk_acc[u][n]);
      dv[o + 16 * n] = from_f32<T>(dv_acc[u][n]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
};

template <typename T, int D>
cudaError_t launch_dq_d(const Args& a, const Shape& sh, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(D);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sh.S + sh.block_q - 1) / sh.block_q, sh.KH, sh.B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), sh);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_d(const Args& a, const Shape& sh, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(D);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((sh.T + kKeysB - 1) / kKeysB, sh.KH, sh.B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), sh);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool dkv, const Args& a, const Shape& sh, cudaStream_t s) {
  switch (sh.D) {
    case 16: return dkv ? launch_dkv_d<T, 16>(a, sh, s) : launch_dq_d<T, 16>(a, sh, s);
    case 32: return dkv ? launch_dkv_d<T, 32>(a, sh, s) : launch_dq_d<T, 32>(a, sh, s);
    case 64: return dkv ? launch_dkv_d<T, 64>(a, sh, s) : launch_dq_d<T, 64>(a, sh, s);
    case 128: return dkv ? launch_dkv_d<T, 128>(a, sh, s) : launch_dq_d<T, 128>(a, sh, s);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(bool dkv, int dtype, const Args& a, int B, int S, int T, int H, int KH, int D,
             int block_q, int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || block_q <= 0 ||
      block_q * (H / KH) > kRows || window < 0)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, S, T, H, KH, D, H / KH, block_q, causal ? 1 : 0, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch<float>(dkv, a, sh, s);
    case kBF16: return (int)launch<__nv_bfloat16>(dkv, a, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  Gradients come out in q's
// dtype; lse and delta are (B, S, H) f32.  block_q * (H / KH) must be at
// most kRows (64), and D one of 16, 32, 64, 128.  Each returns the
// cudaError_t of its launch (0 on success); it runs asynchronously on
// `stream`.
extern "C" int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                            const void* dout, const float* lse, const float* delta, void* dq,
                            int B, int S, int T, int H, int KH, int D, int block_q, int causal,
                            int window, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr};
  return dispatch(false, dtype, a, B, S, T, H, KH, D, block_q, causal, window, scale, stream);
}

extern "C" int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta, void* dk,
                             void* dv, int B, int S, int T, int H, int KH, int D, int block_q,
                             int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv};
  return dispatch(true, dtype, a, B, S, T, H, KH, D, block_q, causal, window, scale, stream);
}
