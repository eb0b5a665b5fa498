// Mamba2 (SSD) chunked scan, backward: a reverse walk over the chunks
// that carries G = dL/d(chunk-end state) and emits dx, the per-head dB and
// dC, ddt and the log-decay cotangent dla.
//
//   x, dy (Bt, S, H, P), B and C (Bt, S, N), dt (Bt, S, H), A (H,), the
//   forward's chunk entry states s0 (Bt, H, nC, P, N); all f32.  Per chunk,
//   with F = cumsum(dt A), e(t, s) = exp(F_t - F_s) for s <= t (else 0),
//   cb = C B^T, dyx = dy x^T, M = cb e dt_s, T1 = dyx e, DM = dyx cb e,
//   w = exp(F_L - F) dt and the chunk-end state s1:
//     dx    = M^T dy + w (B G^T)
//     dB_h  = dt (T1^T C) + w (x G)
//     dC_h  = (T1 dt_s) B + exp(F) (dy s0)
//     dF    = sum_p dy y_inter + rowsum(DM dt_s) - colsum(DM dt_s) - w xBG,
//             plus <G, s1> on the chunk's last row (xBG = rowsum(x * B G^T))
//     dla   = sum(dF) - cumsum(dF) + dF      (the reverse cumsum)
//     ddt   = A dla + colsum(DM) + exp(F_L - F) xBG
//     G     <- exp(F_L) G + (dy exp(F))^T C  (for the chunk before)
//   dx (Bt, S, H, P); dB_h and dC_h (Bt, H, S, N), per head (the wrapper
//   sums them over heads in a fixed order); ddt and dla (Bt, S, H) (the
//   wrapper forms dA = sum dt dla).
//
// Replaces the TPU kernel `_ssd_bwd_kernel` of
// src/repro/kernels/ssm_scan/ssm_scan.py (pallas_call in `ssm_scan_bwd`).
//
// Design.  One block owns one (batch row, head) and walks its chunks last
// to first, the TPU's reversed sequential grid axis; each thread keeps 4 x
// 4 elements of G in registers across chunks.  Shared memory does not hold
// x, dy, B, C, s0, G and the TPU kernel's three (L, L) matrices (about
// 350 KB at L = 128, P = N = 64, f32; a block has 227 KB), so the design
// keeps ONE (L, L) buffer and recomputes instead of storing:
//   1. dy s0 (then s0's space is the (L, L) buffer's), the first dF term
//      as sum_n C (exp(F) dy s0), B G^T and xBG, w B G^T parked in dx's
//      output, dstate and <G, s1>;
//   2. cb -> the buffer as cb e (the TPU's Mnodt); dyx in registers, with
//      the row sums of DM dt_s; T1 = dyx e stays in registers (64 a thread);
//   3. Z = (cb e)^T dy gives dx = dt_s Z + w B G^T and colsum(DM) =
//      rowsum(x * Z), so no cross-warp column reduction is needed;
//   4. T1 -> the buffer; dB_h and dC_h from it;
//   5. dF, dla (one thread, in order) and ddt; then G for the chunk before.
// That is 219.9 KB of shared memory at the largest shapes (one block per
// SM, opted in with cudaFuncAttributeMaxDynamicSharedMemorySize).  The
// products are register-tiled as in ssd_fwd.cu.  As there, F is summed and
// kept in f64, and so are the sums the reverse cumsum is cut from (dla is
// small beside them where dF's terms cancel).  exp(F_t - F_s) is taken
// only where s <= t (at most 1 there), never as inf times 0.  Steps past S
// read zeros, as the reference's zero padding, and are not written; the
// <G, s1> bump falls on the chunk's last row L - 1 whether or not it is
// past S, as in the reference.  No atomics: a launch is bit-reproducible.
//
// What bounds it: the function's work, not what this kernel spends.  Per
// chunk of l steps, over its l (l + 1) / 2 pairs s <= t: C B^T once per
// batch row, and per head dy x^T, M^T dy, T1^T C and T1 B; then l P N each
// for dy s0 and dy^T C (every chunk but the first, whose entry state is
// zero) and B G^T, x G and dstate (every chunk but the last, where G is
// zero); against one read of x, dy, B, C, dt, s0 and one write of the
// wrapper's outputs.  At the training shapes (Bt 8, S 256, H 64, P = N =
// 64, L 128) that is 7.0 GFLOP against 121 MB: bound by operations on the
// CUDA cores (f32, 67 TFLOP/s).  This kernel computes every (L, L) product
// whole and per head, and the five (L, P, N) products in every chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 128;          // longest chunk
constexpr int kP = 64;           // largest head dim P
constexpr int kN = 64;           // largest state dim N
constexpr int kThreads = 256;    // 16 (ty) x 16 (tx), 8 warps
constexpr int kRS = 65;          // row stride of dy (t, p), B, C (t, n) and G (p, n)

struct Shape {
  int Bt, S, H, P, N, L, nC;
};

constexpr size_t kSmemBytes =
    sizeof(double) * kL                                // F
    + sizeof(float) * ((size_t)kP * kL                 // x^T   [p][s]
                       + 3 * (size_t)kL * kRS          // dy [t][p], B, C [t][n]
                       + (size_t)kP * kRS              // G     [p][n]
                       + (size_t)kL * kL               // (L, L) buffer; s0 [p][n] first
                       + 8 * (size_t)kL                // dt, eF, wexp, w, dF, rowDM, colDM, xBG
                       + 8);                           // one partial per warp

__device__ __forceinline__ float lanes16_sum(float v) {   // over the 16 tx lanes
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ chunk_states,
               const float* __restrict__ dy, float* __restrict__ dx,
               float* __restrict__ dBh, float* __restrict__ dCh,
               float* __restrict__ ddt, float* __restrict__ dla, Shape sh) {
  extern __shared__ float4 smem4[];
  double* Fs = reinterpret_cast<double*>(smem4);
  float* xT = reinterpret_cast<float*>(Fs + kL);
  float* dys = xT + kP * kL;
  float* bs = dys + kL * kRS;
  float* cs = bs + kL * kRS;
  float* gs = cs + kL * kRS;
  float* LL = gs + kP * kRS;
  float* s0s = LL;               // s0 [p][n], stride kN, until the buffer is built
  float* dts = LL + kL * kL;
  float* eFs = dts + kL;
  float* wexps = eFs + kL;
  float* ws = wexps + kL;
  float* dFs = ws + kL;          // first the sum_p dy y_inter term, then dF
  float* rowDM = dFs + kL;       // rowsum(DM dt_s), then dla
  float* colDM = rowDM + kL;
  float* xBGs = colDM + kL;
  float* red = xBGs + kL;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];

  float g[4][4];                 // G (p = ty + 16i, n = tx + 16j)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.f;

  for (int c = sh.nC - 1; c >= 0; --c) {
    const int t0 = c * sh.L;
    // ---- stage the chunk (zeros past L, S, P, N), s0 and G
    for (int i = tid; i < kL * kP; i += kThreads) {
      const int t = i / kP, p = i % kP, ts = t0 + t;
      const bool in = t < sh.L && ts < sh.S && p < sh.P;
      const size_t o = (((size_t)b * sh.S + ts) * sh.H + h) * sh.P + p;
      xT[p * kL + t] = in ? x[o] : 0.f;
      dys[t * kRS + p] = in ? dy[o] : 0.f;
    }
    for (int i = tid; i < kL * kN; i += kThreads) {
      const int t = i / kN, n = i % kN, ts = t0 + t;
      const bool in = t < sh.L && ts < sh.S && n < sh.N;
      const size_t o = ((size_t)b * sh.S + ts) * sh.N + n;
      bs[t * kRS + n] = in ? Bm[o] : 0.f;
      cs[t * kRS + n] = in ? Cm[o] : 0.f;
    }
    const float* s0g = chunk_states + (((size_t)b * sh.H + h) * sh.nC + c) * sh.P * sh.N;
    for (int i = tid; i < kP * kN; i += kThreads) {
      const int p = i / kN, n = i % kN;
      s0s[i] = (p < sh.P && n < sh.N) ? s0g[p * sh.N + n] : 0.f;
    }
    if (tid < kL) {
      const int ts = t0 + tid;
      dts[tid] = (tid < sh.L && ts < sh.S) ? dt[((size_t)b * sh.S + ts) * sh.H + h] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) gs[(ty + 16 * i) * kRS + tx + 16 * j] = g[i][j];
    __syncthreads();
    if (tid == 0) {              // inclusive cumsum of the log-decay, in order, in f64
      double f = 0.0;
      for (int t = 0; t < kL; ++t) {
        f += (double)(dts[t] * a);
        Fs[t] = f;
      }
    }
    __syncthreads();
    const double Ftot = Fs[kL - 1];
    const float eTot = expf((float)Ftot);
    if (tid < kL) {
      eFs[tid] = expf((float)Fs[tid]);
      wexps[tid] = expf((float)(Ftot - Fs[tid]));
      ws[tid] = wexps[tid] * dts[tid];
    }
    __syncthreads();

    // ---- 1a. dC's second term exp(F_t) (dy s0)[t, n], parked in dC_h's
    // output; the first dF term sum_n C[t, n] of it
#pragma unroll
    for (int half = 0; half < 2; ++half) {     // rows ty + 16i, i in [4 half, 4 half + 4)
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int p = 0; p < sh.P; ++p) {
        float dv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = dys[(ty + 16 * (4 * half + i)) * kRS + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = s0s[p * kN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * (4 * half + i), ts = t0 + t;
        const float ef = eFs[t];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          const float v = ef * acc[i][j];
          part = fmaf(cs[t * kRS + n], v, part);
          if (t < sh.L && ts < sh.S && n < sh.N)
            dCh[(((size_t)b * sh.H + h) * sh.S + ts) * sh.N + n] = v;
        }
        part = lanes16_sum(part);
        if (tx == 0) dFs[t] = part;
      }
    }

    // ---- 1b. B G^T (rows s = ty + 16i, columns p = tx + 16j), xBG, and
    // w B G^T parked in dx's output
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < sh.N; ++n) {
        float bv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = bs[(ty + 16 * (4 * half + i)) * kRS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = gs[(tx + 16 * j) * kRS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], gv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * (4 * half + i), ts = t0 + s;
        const float w = ws[s];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          part = fmaf(xT[p * kL + s], acc[i][j], part);
          if (s < sh.L && ts < sh.S && p < sh.P)
            dx[(((size_t)b * sh.S + ts) * sh.H + h) * sh.P + p] = w * acc[i][j];
        }
        part = lanes16_sum(part);
        if (tx == 0) xBGs[s] = part;
      }
    }

    // ---- 1c. <G, s1>, s1 = exp(F_L) s0 + sum_s (w_s x_s) B_s^T
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
        for (int i = 0; i < 4; ++i) xv[i] = xT[(ty + 16 * i) * kL + s] * w;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[s * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ds[i][j] = fmaf(xv[i], bv[j], ds[i][j]);
      }
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float s1 = s0s[(ty + 16 * i) * kN + tx + 16 * j] * eTot + ds[i][j];
          part = fmaf(g[i][j], s1, part);
        }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (tid % 32 == 0) red[tid / 32] = part;
    }
    __syncthreads();             // s0's space becomes the (L, L) buffer

    // ---- 2. LL = cb e (rows t = ty + 16i, columns s = tx + 16j); dyx; the
    // row sums of DM dt_s; T1 = dyx e kept in registers
    float t1[8][8];
    {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) t1[i][j] = 0.f;
      for (int n = 0; n < sh.N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = cs[(ty + 16 * i) * kRS + n];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = bs[(tx + 16 * j) * kRS + n];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) t1[i][j] = fmaf(cv[i], bv[j], t1[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          LL[t * kL + s] = (s <= t) ? t1[i][j] * expf((float)(Fs[t] - Fs[s])) : 0.f;
          t1[i][j] = 0.f;
        }
      }
      for (int p = 0; p < sh.P; ++p) {
        float dv[8], xv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) dv[i] = dys[(ty + 16 * i) * kRS + p];
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] = xT[p * kL + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) t1[i][j] = fmaf(dv[i], xv[j], t1[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          part = fmaf(t1[i][j] * LL[t * kL + s], dts[s], part);   // DM dt_s
          t1[i][j] = (s <= t) ? t1[i][j] * expf((float)(Fs[t] - Fs[s])) : 0.f;
        }
        part = lanes16_sum(part);
        if (tx == 0) rowDM[t] = part;
      }
    }
    __syncthreads();

    // ---- 3. Z = (cb e)^T dy (rows s = ty + 16i, columns p = tx + 16j):
    // dx = dt_s Z + w B G^T, colsum(DM)[s] = sum_p x[s, p] Z[s, p]
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float z[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
      for (int t = 0; t < sh.L; ++t) {
        float mv[4], dv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = LL[t * kL + ty + 16 * (4 * half + i)];
#pragma unroll
        for (int j = 0; j < 4; ++j) dv[j] = dys[t * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) z[i][j] = fmaf(mv[i], dv[j], z[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * (4 * half + i), ts = t0 + s;
        const float d = dts[s];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          part = fmaf(xT[p * kL + s], z[i][j], part);
          if (s < sh.L && ts < sh.S && p < sh.P) {
            float* o = dx + (((size_t)b * sh.S + ts) * sh.H + h) * sh.P + p;
            *o = d * z[i][j] + *o;
          }
        }
        part = lanes16_sum(part);
        if (tx == 0) colDM[s] = part;
      }
    }
    __syncthreads();

    // ---- 4. T1 -> the buffer; dB_h and dC_h from it
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) LL[(ty + 16 * i) * kL + tx + 16 * j] = t1[i][j];
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {    // dB_h: rows s = ty + 16i, columns n = tx + 16j
      float tc[4][4], xg[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) tc[i][j] = xg[i][j] = 0.f;
      for (int t = 0; t < sh.L; ++t) {
        float mv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = LL[t * kL + ty + 16 * (4 * half + i)];
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = cs[t * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) tc[i][j] = fmaf(mv[i], cv[j], tc[i][j]);
      }
      for (int p = 0; p < sh.P; ++p) {
        float xv[4], gv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xT[p * kL + ty + 16 * (4 * half + i)];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = gs[p * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) xg[i][j] = fmaf(xv[i], gv[j], xg[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = ty + 16 * (4 * half + i), ts = t0 + s;
        if (s >= sh.L || ts >= sh.S) continue;
        const float d = dts[s], w = ws[s];
        float* o = dBh + (((size_t)b * sh.H + h) * sh.S + ts) * sh.N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          if (n < sh.N) o[n] = d * tc[i][j] + w * xg[i][j];
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {    // dC_h: rows t = ty + 16i, columns n = tx + 16j
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int s = 0; s < sh.L; ++s) {
        const float d = dts[s];
        float mv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = LL[(ty + 16 * (4 * half + i)) * kL + s] * d;
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[s * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * (4 * half + i), ts = t0 + t;
        if (t >= sh.L || ts >= sh.S) continue;
        float* o = dCh + (((size_t)b * sh.H + h) * sh.S + ts) * sh.N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = tx + 16 * j;
          if (n < sh.N) o[n] = acc[i][j] + o[n];
        }
      }
    }

    // ---- 5. dF, dla, ddt
    if (tid < kL) {
      const int t = tid;
      dFs[t] = dFs[t] + rowDM[t] - dts[t] * colDM[t] - ws[t] * xBGs[t];
    }
    __syncthreads();
    if (tid == 0) {
      float gs1 = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) gs1 += red[k];
      dFs[sh.L - 1] += gs1;
      double total = 0.0;        // f64: dla is small beside the sums it is cut from
      for (int t = 0; t < sh.L; ++t) total += dFs[t];
      double cum = 0.0;
      for (int t = 0; t < sh.L; ++t) {
        cum += dFs[t];
        rowDM[t] = (float)(total - cum + dFs[t]);  // dla
      }
    }
    __syncthreads();
    if (tid < sh.L && t0 + tid < sh.S) {
      const int t = tid;
      const size_t o = ((size_t)b * sh.S + t0 + t) * sh.H + h;
      const float l = rowDM[t];
      dla[o] = l;
      ddt[o] = a * l + colDM[t] + wexps[t] * xBGs[t];
    }

    // ---- G for the chunk before: exp(F_L) G + sum_t (dy_t exp(F_t)) C_t^T
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < sh.L; ++t) {
        const float ef = eFs[t];
        float dv[4], cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) dv[i] = dys[t * kRS + ty + 16 * i] * ef;
#pragma unroll
        for (int j = 0; j < 4; ++j) cv[j] = cs[t * kRS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(dv[i], cv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = g[i][j] * eTot + acc[i][j];
    }
    __syncthreads();             // the next chunk overwrites shared memory
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  Every tensor is f32 and
// contiguous; chunk_states is the forward's (Bt, H, ceil(S / L), P, N).
// dx (Bt, S, H, P), dB_h and dC_h (Bt, H, S, N), ddt and dla (Bt, S, H)
// are written whole.  L (the chunk, already clamped to S) must be at most
// 128, P and N at most 64.  Returns the cudaError_t of the launch (0 on
// success); it runs asynchronously on `stream`.
extern "C" int ssd_bwd(const float* x, const float* B, const float* C, const float* dt,
                       const float* A, const float* chunk_states, const float* dy, float* dx,
                       float* dB_h, float* dC_h, float* ddt, float* dla, int Bt, int S, int H,
                       int P, int N, int L, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || P <= 0 || P > kP || N <= 0 || N > kN || L <= 0 ||
      L > kL || L > S || H > 65535 || Bt > 65535)
    return (int)cudaErrorInvalidValue;
  const Shape sh{Bt, S, H, P, N, L, (S + L - 1) / L};
  const size_t smem = kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<<<dim3(H, Bt), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, B, C, dt, A, chunk_states, dy, dx, dB_h, dC_h, ddt, dla, sh);
  return (int)cudaGetLastError();
}
