// Mamba2 (SSD) chunked scan, forward: y, the final state and each chunk's
// entry state (the backward's residual).
//
//   x (Bt, S, H, P), B and C (Bt, S, N) shared by all heads, dt (Bt, S, H),
//   A (H,) negative; all f32.  Per head h the recurrence is
//   s_t = exp(dt_t A_h) s_{t-1} + dt_t x_t B_t^T, y_t = C_t . s_t, from a
//   zero state, computed in chunks of L steps:
//     F        = cumsum(dt A) over the chunk          (log-decay)
//     y_inter  = exp(F_t) C_t . state                 (L, P)
//     M[t, s]  = (C_t . B_s) exp(F_t - F_s) dt_s      s <= t, else 0
//     y_intra  = M x                                  (L, L) @ (L, P)
//     state'   = exp(F_L) state + sum_s exp(F_L - F_s) dt_s x_s B_s^T
//   y (Bt, S, H, P); final state (Bt, H, P, N); entry states
//   (Bt, H, nC, P, N), nC = ceil(S / L).
//
// Replaces the TPU kernel `_ssd_kernel` of
// src/repro/kernels/ssm_scan/ssm_scan.py (pallas_call in `ssm_scan`).
//
// Design.  The TPU walks the chunks as its innermost, sequential grid axis
// and carries the (P, N) state in VMEM scratch.  Here one block owns one
// (batch row, head), 8 x 64 = 512 blocks on the training path, and loops
// over its chunks in order; each thread keeps 4 x 4 elements of the state
// in registers across chunks.  Per chunk the block stages x (L, P), B and
// C (L, N) and the state in shared memory, builds M (L, L) there, and
// forms the three products with register tiles: thread (ty, tx) of 16 x 16
// owns rows ty + 16i and columns tx + 16j, so each shared load feeds
// several multiply-adds and a warp reads either one broadcast address or
// consecutive ones (row strides of N + 1 and L + 1 keep the transposed
// reads free of bank conflicts).  At L = 128, P = N = 64 that is 184.1 KB
// of shared memory, one block per SM, opted in with
// cudaFuncAttributeMaxDynamicSharedMemorySize.  F is summed and kept in
// f64: at the path's decay rates it falls to a few hundred within a chunk,
// where an f32 spacing (3e-5) would put 1e-5 of relative error on every
// exp(F_t - F_s); each difference is taken in f64 and rounded once.
// exp(F_t - F_s) is taken only where s <= t: F falls along the chunk, so
// there it is at most 1, and above the diagonal it could overflow.  A ragged last chunk is
// masked in the loads: steps past S read dt = x = B = C = 0 (a decay of 1
// and no injection, as the reference's zero padding) and are not written.
// Like the TPU kernel it recomputes C B^T per head.  No atomics: a launch
// is bit-reproducible.
//
// What bounds it: the function's work, not what this kernel spends.  Per
// chunk of l steps, over its l (l + 1) / 2 pairs s <= t: C B^T once per
// batch row and M x per head; per head the state update (l P N) in every
// chunk and C state (l P N) in every chunk but the first (zero entry);
// against one read of x, B, C, dt and one write of y and the states.  At
// the training shapes (Bt 8, S 256, H 64, P = N = 64, L 128) that is
// 2.7 GFLOP against 94 MB: bound by operations on the CUDA cores (f32,
// 67 TFLOP/s).  This kernel, like the TPU's, computes each (L, L) product
// whole and C B^T per head.  Tensor cores (TF32 wgmma), one C B^T shared
// by all heads and more blocks per SM are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;          // longest chunk
constexpr int kP = 64;           // largest head dim P
constexpr int kN = 64;           // largest state dim N
constexpr int kThreads = 256;    // 16 (ty) x 16 (tx)
constexpr int kRS = kN + 1;      // row stride of B, C (t, n) and the state (p, n)
constexpr int kMS = kL + 1;      // row stride of M (t, s)

struct Shape {
  int Bt, S, H, P, N, L, nC;
};

constexpr size_t kSmemBytes = sizeof(double) * kL                   // F
                              + sizeof(float) * ((size_t)kL * kP       // x      [t][p]
                                                 + 2 * (size_t)kL * kRS  // B, C   [t][n]
                                                 + (size_t)kP * kRS      // state  [p][n]
                                                 + (size_t)kL * kMS      // M      [t][s]
                                                 + 2 * (size_t)kL);      // dt, w

__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ A, float* __restrict__ y,
               float* __restrict__ final_state, float* __restrict__ chunk_states,
               Shape sh) {
  extern __shared__ float4 smem4[];
  double* Fs = reinterpret_cast<double*>(smem4);
  float* xs = reinterpret_cast<float*>(Fs + kL);
  float* bs = xs + kL * kP;
  float* cs = bs + kL * kRS;
  float* st = cs + kL * kRS;
  float* ms = st + kP * kRS;
  float* dts = ms + kL * kMS;
  float* ws = dts + kL;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];

  float sreg[4][4];              // state (p = ty + 16i, n = tx + 16j)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sreg[i][j] = 0.f;

  for (int c = 0; c < sh.nC; ++c) {
    const int t0 = c * sh.L;
    // ---- stage the chunk (zeros past L, S, P, N)
    for (int i = tid; i < kL * kP; i += kThreads) {
      const int t = i / kP, p = i % kP, ts = t0 + t;
      xs[i] = (t < sh.L && ts < sh.S && p < sh.P)
                  ? x[(((size_t)b * sh.S + ts) * sh.H + h) * sh.P + p] : 0.f;
    }
    for (int i = tid; i < kL * kN; i += kThreads) {
      const int t = i / kN, n = i % kN, ts = t0 + t;
      const bool in = t < sh.L && ts < sh.S && n < sh.N;
      const size_t o = ((size_t)b * sh.S + ts) * sh.N + n;
      bs[t * kRS + n] = in ? Bm[o] : 0.f;
      cs[t * kRS + n] = in ? Cm[o] : 0.f;
    }
    if (tid < kL) {
      const int ts = t0 + tid;
      dts[tid] = (tid < sh.L && ts < sh.S) ? dt[((size_t)b * sh.S + ts) * sh.H + h] : 0.f;
    }
    // the state to shared memory, and out as this chunk's entry state
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        st[p * kRS + n] = sreg[i][j];
        if (p < sh.P && n < sh.N)
          chunk_states[((((size_t)b * sh.H + h) * sh.nC + c) * sh.P + p) * sh.N + n] =
              sreg[i][j];
      }
    __syncthreads();
    if (tid == 0) {              // inclusive cumsum of the log-decay, in order, in f64
      double f = 0.0;
      for (int t = 0; t < kL; ++t) {
        f += (double)(dts[t] * a);
        Fs[t] = f;
      }
    }
    __syncthreads();
    const double Ftot = Fs[kL - 1];  // = F at the chunk's last step (dt = 0 after it)
    if (tid < kL) ws[tid] = expf((float)(Ftot - Fs[tid])) * dts[tid];

    // ---- M[t, s] = (C_t . B_s) exp(F_t - F_s) dt_s for s <= t
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < sh.N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * kRS + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[(tx + 16 * j) * kRS + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          ms[t * kMS + s] = (s <= t) ? acc[i][j] * expf((float)(Fs[t] - Fs[s])) * dts[s] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = exp(F_t) C_t . state + (M x)_t, rows ty + 16i, columns tx + 16j
    {
      float ye[8][4], yi[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ye[i][j] = yi[i][j] = 0.f;
      for (int n = 0; n < sh.N; ++n) {
        float cv[8], sv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * kRS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[(tx + 16 * j) * kRS + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ye[i][j] = fmaf(cv[i], sv[j], ye[i][j]);
      }
      for (int s = 0; s < sh.L; ++s) {
        float mv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) mv[i] = ms[(ty + 16 * i) * kMS + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[s * kP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(mv[i], xv[j], yi[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i, ts = t0 + t;
        if (t >= sh.L || ts >= sh.S) continue;
        const float ef = expf((float)Fs[t]);
        float* yr = y + (((size_t)b * sh.S + ts) * sh.H + h) * sh.P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < sh.P) yr[p] = ye[i][j] * ef + yi[i][j];
        }
      }
    }

    // ---- state' = exp(F_L) state + sum_s (w_s x_s) B_s^T
    {
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ds[i][j] = 0.f;
      for (int s = 0; s < sh.L; ++s) {
        const float w = ws[s];
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[s * kP + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[s * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ds[i][j] = fmaf(xv[i], bv[j], ds[i][j]);
      }
      const float e = expf((float)Ftot);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sreg[i][j] = sreg[i][j] * e + ds[i][j];
    }
    __syncthreads();             // the next chunk overwrites shared memory
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = ty + 16 * i, n = tx + 16 * j;
      if (p < sh.P && n < sh.N)
        final_state[(((size_t)b * sh.H + h) * sh.P + p) * sh.N + n] = sreg[i][j];
    }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every tensor is f32 and
// contiguous; y (Bt, S, H, P), final_state (Bt, H, P, N) and chunk_states
// (Bt, H, ceil(S / L), P, N) are written whole.  L (the chunk, already
// clamped to S) must be at most 128, P and N at most 64.  Returns the
// cudaError_t of the launch (0 on success); it runs asynchronously on
// `stream`.
extern "C" int ssd_fwd(const float* x, const float* B, const float* C, const float* dt,
                       const float* A, float* y, float* final_state, float* chunk_states,
                       int Bt, int S, int H, int P, int N, int L, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kP || N <= 0 || N > kN || L <= 0 ||
      L > kL || L > S || H > 65535 || Bt > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{Bt, S, H, P, N, L, (S + L - 1) / L};
  const size_t smem = kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(ssd_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_fwd_kernel<<<dim3(H, Bt), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, B, C, dt, A, y, final_state, chunk_states, sh);
  return (int)cudaGetLastError();
}
