// Standalone tiled GEMM: y (M, N) = x (M, K) @ w (K, N), all row-major,
// summed in f32 and rounded once to the output type (f32 or bf16).
//
// Replaces the TPU kernel `_gemm_kernel` of src/repro/kernels/conv3d/conv3d.py
// (pallas_call in `gemm`): (bm, bk) x (bk, bn) MXU tiles accumulated in an f32
// VMEM scratch along a sequential K grid axis, the ragged edges zero-padded in
// HBM first.
//
// What bounds it: 2*M*N*K operations against M*K + K*N inputs read once and
// M*N outputs written once.  At the models' shapes (M 2048, K and N 1536 to
// 8960) that is hundreds of operations per byte, so it is bound by operations:
// 67 TFLOP/s in f32 on the CUDA cores, 989 TFLOP/s in bf16 on the tensor cores.
//
// Design (the textbook tiling; no wgmma or TMA yet):
// - One block of 256 threads owns a 128 x 128 output tile and walks K in
//   steps with the whole sum in registers.  K is summed in a fixed order, with
//   no split-K and no atomics, so a repeat is bit-identical.  Each K step of
//   both operands is staged in shared memory by cp.async, double (f32) or
//   triple (bf16) buffered, so the next steps load while this one computes.
// - Ragged edges: a copy whose source lies past M, N or K is a zero-fill
//   (cp.async with src-size 0), so no operand is padded in device memory and
//   a tail K step adds exact zeros.  16-byte copies need 16-byte aligned rows:
//   f32 w takes them when N % 4 == 0, bf16 x when K % 8 == 0, bf16 w when
//   N % 8 == 0 (and the base pointers are 16-byte aligned); otherwise f32 uses
//   4-byte copies and bf16 plain loads and shared stores.
// - f32: K steps of 16.  Each thread keeps an 8 x 8 register tile of outputs
//   (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise by tx) and
//   runs true FP32 FMAs, no TF32.  x's step is stored k-major (transposed) with
//   padded rows, so a thread reads its four rows of one k as one float4.
// - bf16: K steps of 32 through mma.sync.m16n8k16 (bf16 in, f32 out; a bf16
//   product is exact in f32).  The tensor core's own f32 accumulation keeps
//   fewer bits than a chain of rounded adds: carried over K = 8960 it drifted
//   1.04e-5 of the largest output from an f32 sum on an H100.  So the tensor
//   core sums only each K step's 32 products, starting from zero, and that
//   partial is added to the f32 accumulators by FADD: one rounded add per
//   32 k, a chain the f32 route's accuracy bounds.  8 warps of
//   64 x 32 outputs; fragments by ldmatrix (x row-major; w by ldmatrix.trans
//   of its (K, N) rows); row strides padded so that ldmatrix's eight 16-byte
//   rows hit distinct banks.
// - The store rounds once: f32, or bf16 by __float2bfloat16_rn (round to
//   nearest even, as torch's .to(torch.bfloat16)).  Offsets are 64-bit.
// The kernels are named tiled_gemm_* so that a profile tells them from
// cuBLAS's GEMMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };

constexpr int kBM = 128, kBN = 128, kThreads = 256;
// f32 route: K step, stages, x's k-major row stride (padded: see the store)
constexpr int kFK = 16, kFStages = 2, kFAStride = kBM + 4;
// bf16 route: K step, stages, row strides in bf16 (80 and 272 bytes: eight
// consecutive rows fall on eight distinct 16-byte bank groups)
constexpr int kHK = 32, kHStages = 3, kHAStride = kHK + 8, kHBStride = kBN + 8;
constexpr int kHSmemBytes =
    kHStages * (kBM * kHAStride + kHK * kHBStride) * (int)sizeof(uint16_t);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; with pred false it reads nothing and writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, 8 x 8 outputs a thread
// ---------------------------------------------------------------------------

struct F32Smem {
  float a[kFStages][kFK][kFAStride];   // x's step, k-major
  float b[kFStages][kFK][kBN];         // w's step, as in memory
};

// Stage K step `kt` of x and w into buffer `s`.
template <bool kVecB>
__device__ __forceinline__ void f32_load(F32Smem& sm, int s, int kt, const float* __restrict__ x,
                                         const float* __restrict__ w, int64_t M, int64_t K,
                                         int64_t N, int64_t m0, int64_t n0) {
  const int tid = threadIdx.x;
  const int64_t k0 = (int64_t)kt * kFK;
  {  // x: 128 rows x 16 k; a thread copies one k of 8 rows (16 threads a row)
    const int kk = tid % kFK;
    const int64_t gk = k0 + kk;
#pragma unroll
    for (int i = 0; i < kBM * kFK / kThreads; ++i) {
      const int r = tid / kFK + (kThreads / kFK) * i;
      const int64_t gm = m0 + r;
      const bool ok = gm < M && gk < K;
      cp_async4(&sm.a[s][kk][r], ok ? x + gm * K + gk : x, ok);
    }
  }
  // w: 16 k x 128 n; a thread copies four consecutive columns of two rows
#pragma unroll
  for (int i = 0; i < kBN * kFK / (4 * kThreads); ++i) {
    const int kk = tid / (kBN / 4) + (4 * kThreads / kBN) * i;
    const int c = (tid % (kBN / 4)) * 4;
    const int64_t gk = k0 + kk, gn = n0 + c;
    if (kVecB) {  // N % 4 == 0: the four columns are all in or all out
      const bool ok = gk < K && gn < N;
      cp_async16(&sm.b[s][kk][c], ok ? w + gk * N + gn : w, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = gk < K && gn + j < N;
        cp_async4(&sm.b[s][kk][c + j], ok ? w + gk * N + gn + j : w, ok);
      }
    }
  }
}

template <bool kVecB, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          OutT* __restrict__ y, int64_t M, int64_t K, int64_t N) {
  __shared__ __align__(16) F32Smem sm;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int nk = (int)((K + kFK - 1) / kFK);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < nk) f32_load<kVecB>(sm, s, s, x, w, M, K, N, m0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // step kt landed; every thread is done with step kt - 1
    const int next = kt + kFStages - 1;
    if (next < nk) f32_load<kVecB>(sm, next % kFStages, next, x, w, M, K, N, m0, n0);
    cp_async_commit();
    const int s = kt % kFStages;
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.a[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.a[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.b[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.b[s][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) store(y + row * N + col, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16 on the tensor cores, f32 accumulators
// ---------------------------------------------------------------------------

// Stage K step `kt` of x and w into buffer `s` of the dynamic shared memory:
// x's 128 rows x 32 k and w's 32 k x 128 n, each 512 chunks of 8 bf16.
template <bool kVecA, bool kVecB>
__device__ __forceinline__ void bf16_load(uint16_t* a_s, uint16_t* b_s, int kt,
                                          const uint16_t* __restrict__ x,
                                          const uint16_t* __restrict__ w, int64_t M, int64_t K,
                                          int64_t N, int64_t m0, int64_t n0) {
  const int tid = threadIdx.x;
  const int64_t k0 = (int64_t)kt * kHK;
#pragma unroll
  for (int i = 0; i < kBM * kHK / (8 * kThreads); ++i) {
    const int c = tid + kThreads * i;
    const int r = c / (kHK / 8), kc = (c % (kHK / 8)) * 8;
    const int64_t gm = m0 + r, gk = k0 + kc;
    uint16_t* dst = a_s + r * kHAStride + kc;
    if (kVecA) {  // K % 8 == 0: the chunk is all in or all out
      const bool ok = gm < M && gk < K;
      cp_async16(dst, ok ? x + gm * K + gk : x, ok);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = (gm < M && gk + 2 * j < K) ? x[gm * K + gk + 2 * j] : 0u;
        const uint32_t hi = (gm < M && gk + 2 * j + 1 < K) ? x[gm * K + gk + 2 * j + 1] : 0u;
        v[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < kHK * kBN / (8 * kThreads); ++i) {
    const int c = tid + kThreads * i;
    const int kk = c / (kBN / 8), nc = (c % (kBN / 8)) * 8;
    const int64_t gk = k0 + kk, gn = n0 + nc;
    uint16_t* dst = b_s + kk * kHBStride + nc;
    if (kVecB) {  // N % 8 == 0
      const bool ok = gk < K && gn < N;
      cp_async16(dst, ok ? w + gk * N + gn : w, ok);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = (gk < K && gn + 2 * j < N) ? w[gk * N + gn + 2 * j] : 0u;
        const uint32_t hi = (gk < K && gn + 2 * j + 1 < N) ? w[gk * N + gn + 2 * j + 1] : 0u;
        v[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a b, and c = a b (from zero)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16_zero(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

template <bool kVecA, bool kVecB, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_gemm_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                           OutT* __restrict__ y, int64_t M, int64_t K, int64_t N) {
  extern __shared__ __align__(16) uint16_t hsmem[];
  uint16_t* a_sm = hsmem;                                  // [stage][128][kHAStride]
  uint16_t* b_sm = hsmem + kHStages * kBM * kHAStride;     // [stage][32][kHBStride]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;                   // 2 x 4 warps of 64 x 32
  const int64_t m0 = (int64_t)blockIdx.y * kBM, n0 = (int64_t)blockIdx.x * kBN;
  const int nk = (int)((K + kHK - 1) / kHK);

  float acc[4][4][4];   // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kHStages - 1; ++s) {
    if (s < nk)
      bf16_load<kVecA, kVecB>(a_sm + s * kBM * kHAStride, b_sm + s * kHK * kHBStride, s, x, w,
                              M, K, N, m0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kHStages - 2>();
    __syncthreads();  // step kt landed; every thread is done with step kt - 1
    const int next = kt + kHStages - 1;
    if (next < nk) {
      const int ns = next % kHStages;
      bf16_load<kVecA, kVecB>(a_sm + ns * kBM * kHAStride, b_sm + ns * kHK * kHBStride, next,
                              x, w, M, K, N, m0, n0);
    }
    cp_async_commit();
    const int s = kt % kHStages;
    const uint16_t* a_s = a_sm + s * kBM * kHAStride;
    const uint16_t* b_s = b_sm + s * kHK * kHBStride;
    // w's fragments of both k16 halves for the warp's 4 n8 tiles; then per
    // m16 tile x's fragments of both halves and, per (m16, n8) pair, the
    // step's partial from zero, added to the accumulators once
    uint32_t bfr[kHK / 16][4][2];
#pragma unroll
    for (int h = 0; h < kHK / 16; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p) {    // lanes 0-15 k 0-15 at n, 16-31 at n + 8
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + (16 * h + lane % 16) * kHBStride + wn * 32 + p * 16 +
                                 (lane / 16) * 8);
        bfr[h][2 * p][0] = r[0];
        bfr[h][2 * p][1] = r[1];
        bfr[h][2 * p + 1][0] = r[2];
        bfr[h][2 * p + 1][1] = r[3];
      }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t af[kHK / 16][4];
#pragma unroll
      for (int h = 0; h < kHK / 16; ++h)   // lanes 0-15 rows 0-15 at k, 16-31 at k + 8
        ldmatrix_x4(af[h], a_s + (wm * 64 + mi * 16 + lane % 16) * kHAStride + 16 * h +
                               (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        float part[4];
        mma_bf16_zero(part, af[0], bfr[0][nj]);
#pragma unroll
        for (int h = 1; h < kHK / 16; ++h) mma_bf16(part, af[h], bfr[h][nj]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[e];
      }
    }
  }

  // fragment (e0, e1) at (row g, cols 2t, 2t + 1), (e2, e3) at row g + 8
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = m0 + wm * 64 + mi * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t col = n0 + wn * 32 + nj * 8 + 2 * t + e;
          if (col < N) store(y + row * N + col, acc[mi][nj][2 * h + e]);
        }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename OutT>
cudaError_t launch_f32(const float* x, const float* w, OutT* y, int64_t M, int64_t K, int64_t N,
                       dim3 grid, cudaStream_t s) {
  if (N % 4 == 0 && aligned16(w))
    tiled_gemm_f32_kernel<true, OutT><<<grid, kThreads, 0, s>>>(x, w, y, M, K, N);
  else
    tiled_gemm_f32_kernel<false, OutT><<<grid, kThreads, 0, s>>>(x, w, y, M, K, N);
  return cudaGetLastError();
}

template <bool kVecA, bool kVecB, typename OutT>
cudaError_t launch_bf16_as(const uint16_t* x, const uint16_t* w, OutT* y, int64_t M, int64_t K,
                           int64_t N, dim3 grid, cudaStream_t s) {
  auto kernel = tiled_gemm_bf16_kernel<kVecA, kVecB, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kHSmemBytes, s>>>(x, w, y, M, K, N);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_bf16(const uint16_t* x, const uint16_t* w, OutT* y, int64_t M, int64_t K,
                        int64_t N, dim3 grid, cudaStream_t s) {
  const bool va = K % 8 == 0 && aligned16(x), vb = N % 8 == 0 && aligned16(w);
  if (va && vb) return launch_bf16_as<true, true>(x, w, y, M, K, N, grid, s);
  if (va) return launch_bf16_as<true, false>(x, w, y, M, K, N, grid, s);
  if (vb) return launch_bf16_as<false, true>(x, w, y, M, K, N, grid, s);
  return launch_bf16_as<false, false>(x, w, y, M, K, N, grid, s);
}

}  // namespace

// Plain C entry point, bound with ctypes.  x (M, K), w (K, N) and y (M, N)
// are contiguous row-major on the device; x and w are both `dtype` (0 f32,
// 1 bf16), y is `out_dtype` (the same codes), allocated by the caller.
// Returns the cudaError_t of the launch (0 on success); asynchronous on
// `stream`.
extern "C" int gemm(int dtype, int out_dtype, const void* x, const void* w, void* y, int64_t m,
                    int64_t k, int64_t n, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t gx = (n + kBN - 1) / kBN, gy = (m + kBM - 1) / kBM;
  if (gx > 0x7fffffff || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32_out = out_dtype == kF32;
  if (out_dtype != kF32 && out_dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    return f32_out ? (int)launch_f32(xf, wf, static_cast<float*>(y), m, k, n, grid, s)
                   : (int)launch_f32(xf, wf, static_cast<__nv_bfloat16*>(y), m, k, n, grid, s);
  }
  if (dtype == kBF16) {
    const uint16_t* xh = static_cast<const uint16_t*>(x);
    const uint16_t* wh = static_cast<const uint16_t*>(w);
    return f32_out ? (int)launch_bf16(xh, wh, static_cast<float*>(y), m, k, n, grid, s)
                   : (int)launch_bf16(xh, wh, static_cast<__nv_bfloat16*>(y), m, k, n, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}
