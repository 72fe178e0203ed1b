// The forward passes of the local word-region similarity over packed word
// columns, shared by K1 (csrc/local_sim_fwd.cu, the forward) and K2
// (csrc/local_sim_bwd.cu, the backward, which recomputes the forward).
//
// The wrapper (ops/local_sim.py) packs the valid words of all texts, text by
// text, into Wc [N, D]; text t owns columns [text_start[t], text_start[t + 1]).
// For every image b (ctx[b] = its regions, [S, D]), over all columns at once:
//   k?w_word_norms   wn[n]  = sqrt(max(|Wc[n]|^2, 1e-12))
//   k?p_gram         G[b]   = ctx ctx^T                    [S, S], K = D  (product)
//   k?p_raw          raw[b] = ctx Wc^T                     [S, N], K = D  (product)
//   k?w_row_softmax  per row and text segment: the word softmax a1 (its max
//                    and 1/sum kept), e2 = exp(temp1 a1 - max(temp1, 0))
//   k?w_col_softmax  per column: a2 = e2 / sum_s e2 (in place), dot = sum_s a2 raw
//   k?p_ga2          G[b] a2                               [S, N], K = S  (product)
// and then, per column, cn2 = sum_s a2 (G a2) (column_cn2) and
// e = exp(temp2 cos), cos = dot / max(wn sqrt(max(cn2, 1e-12)), 1e-8)
// (column_exp).  a1 lies in [0, 1], so the region softmax's logits temp1 a1
// are bounded and e2 needs no running max (the wrapper refuses |temp1| > 80,
// where it could underflow).  The three products run on tf32x3_mma.cuh:
// tensor cores at f32 accuracy (3xTF32 mma.sync).
//
// Define LSIM_PREFIX (k1 or k2) before including this header: each library's
// kernels then carry its own names (k1w_word_norms ... / k2w_word_norms ...),
// as the profiler shows them.  LSIM_PRODUCT names a product kernel of the
// including file's own.

#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "tf32x3_mma.cuh"

#ifndef LSIM_PREFIX
#error "define LSIM_PREFIX (k1 or k2) before including local_sim_fwd_passes.cuh"
#endif
#define LSIM_CAT_(a, b) a##b
#define LSIM_CAT(a, b) LSIM_CAT_(a, b)
#define LSIM_NAME(pass) LSIM_CAT(LSIM_PREFIX, pass)

// One named kernel per product pass, all the same routine.
#define LSIM_PRODUCT(name, a_k, b_k)                                                       \
  __global__ void __launch_bounds__(tf32x3::kThreads, 2) name(tf32x3::Args p) {            \
    tf32x3::product<a_k, b_k>(p);                                                           \
  }

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The shapes every pass reads.  np, sp, dp: leading dimensions (multiples
// of 4) of the [B, S, N] work arrays, the Gram [B, S, S] and ctx / Wc.
struct Shape {
  int B, T, S, W, D, N, np, sp, dp;
};

size_t round4(size_t x) { return (x + 3) / 4 * 4; }

// ---- products ---------------------------------------------------------------
LSIM_PRODUCT(LSIM_NAME(p_gram), true, true)  // ctx [S][D] . ctx [S][D]^T
LSIM_PRODUCT(LSIM_NAME(p_raw), true, true)   // ctx [S][D] . Wc [N][D]^T
LSIM_PRODUCT(LSIM_NAME(p_ga2), true, false)  // G [S][S] . a2 [S][N]

// ---- elementwise and reduction passes --------------------------------------

// wn[n] = sqrt(max(|Wc[n]|^2, 1e-12)), one warp per column.
__global__ void __launch_bounds__(kThreads) LSIM_NAME(w_word_norms)(const float* __restrict__ wc,
                                                                    float* __restrict__ wn,
                                                                    Shape sh) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= sh.N) return;
  const float* row = wc + (size_t)n * sh.dp;
  float acc = 0.f;
  for (int d = lane; d < sh.D; d += 32) acc += row[d] * row[d];
  acc = warp_sum(acc);
  if (lane == 0) wn[n] = sqrtf(fmaxf(acc, 1e-12f));
}

// One block per row (b, s); warp w takes segments w, w + 8, ...  Writes the
// segment's max and 1/sum of the word softmax and e2 = exp(temp1 a1 - shift).
__global__ void __launch_bounds__(kThreads) LSIM_NAME(w_row_softmax)(
    const float* __restrict__ raw, float* __restrict__ e2, float* __restrict__ row_m,
    float* __restrict__ row_iz, const int* __restrict__ text_start, Shape sh, float temp1) {
  const int row = blockIdx.x;  // b * S + s
  const int lane = threadIdx.x & 31;
  const float shift = fmaxf(temp1, 0.f);
  const float* r = raw + (size_t)row * sh.np;
  float* e = e2 + (size_t)row * sh.np;
  for (int t = threadIdx.x >> 5; t < sh.T; t += kWarps) {
    const int c0 = text_start[t], c1 = text_start[t + 1];
    if (c0 == c1) continue;
    float m = -INFINITY;
    for (int n = c0 + lane; n < c1; n += 32) m = fmaxf(m, r[n]);
    m = warp_max(m);
    float z = 0.f;
    for (int n = c0 + lane; n < c1; n += 32) z += expf(r[n] - m);
    const float iz = 1.f / warp_sum(z);
    if (lane == 0) {
      row_m[(size_t)row * sh.T + t] = m;
      row_iz[(size_t)row * sh.T + t] = iz;
    }
    for (int n = c0 + lane; n < c1; n += 32) e[n] = expf(temp1 * (expf(r[n] - m) * iz) - shift);
  }
}

// One thread per column (b, n): a2 = e2 / sum_s e2 in place; dot = sum_s a2 raw.
__global__ void __launch_bounds__(kThreads) LSIM_NAME(w_col_softmax)(
    const float* __restrict__ raw, float* __restrict__ a2, float* __restrict__ dot, Shape sh) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= sh.N) return;
  const size_t base = (size_t)b * sh.S * sh.np + n;
  float z = 0.f;
  for (int s = 0; s < sh.S; ++s) z += a2[base + (size_t)s * sh.np];
  const float iz = 1.f / z;
  float acc = 0.f;
  for (int s = 0; s < sh.S; ++s) {
    const size_t o = base + (size_t)s * sh.np;
    const float v = a2[o] * iz;
    a2[o] = v;
    acc += v * raw[o];
  }
  dot[(size_t)b * sh.N + n] = acc;
}

// cn2 = sum_s a2 (G a2) of column n of the image whose [S, np] arrays start
// at `base`.
__device__ __forceinline__ float column_cn2(const float* __restrict__ a2,
                                            const float* __restrict__ ga2, size_t base, int n,
                                            const Shape& sh) {
  float acc = 0.f;
  for (int s = 0; s < sh.S; ++s) {
    const size_t o = base + (size_t)s * sh.np + n;
    acc += a2[o] * ga2[o];
  }
  return acc;
}

// e = exp(temp2 cos) of one column from its word norm, cn2 and dot.
__device__ __forceinline__ float column_exp(float wn, float cn2, float dot, float temp2) {
  const float den = fmaxf(wn * sqrtf(fmaxf(cn2, 1e-12f)), 1e-8f);
  return expf(temp2 * (dot / den));
}

// ---- launching ------------------------------------------------------------------

template <class Kernel>
cudaError_t launch_product(Kernel kernel, const tf32x3::Args& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tf32x3::kSmemBytes);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB to shared memory, so two blocks fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<tf32x3::grid_of(p, batch), tf32x3::kThreads, tf32x3::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

tf32x3::Args args(const float* a, int lda, long long sa, const float* b, int ldb, long long sb,
                  float* c, int ldc, long long sc, int m, int n, int k, float alpha = 1.f,
                  int accumulate = 0) {
  return tf32x3::Args{a, b, c, m, n, k, k, lda, ldb, ldc, sa, sb, sc, alpha, accumulate};
}

// Where the forward passes read and write.  raw, a2 and ga2 are [B, S, np];
// ga2 may be raw's buffer, which is dead once the column softmax has read it.
struct FwdBuffers {
  float *raw, *a2, *ga2, *gram, *row_m, *row_iz, *wn, *dot;
};

// Launches the six forward passes in order on `stream`: ctx [B, S, dp],
// wc [N, dp] (16-byte aligned, dp a multiple of 4), N > 0.  Returns the first
// launch error, or cudaSuccess.
cudaError_t launch_fwd_passes(const float* ctx, const float* wc, const int* text_start,
                              const FwdBuffers& f, const Shape& sh, float temp1,
                              cudaStream_t stream) {
  const int B = sh.B, S = sh.S, D = sh.D, N = sh.N, dp = sh.dp;
  const long long s_ctx = (long long)S * dp, s_x = (long long)S * sh.np,
                  s_g = (long long)S * sh.sp;
  cudaError_t err;
  LSIM_NAME(w_word_norms)<<<(N + kWarps - 1) / kWarps, kThreads, 0, stream>>>(wc, f.wn, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_product(LSIM_NAME(p_gram), args(ctx, dp, s_ctx, ctx, dp, s_ctx, f.gram, sh.sp,
                                                    s_g, S, S, D), B, stream)) != cudaSuccess)
    return err;
  if ((err = launch_product(LSIM_NAME(p_raw), args(ctx, dp, s_ctx, wc, dp, 0, f.raw, sh.np, s_x,
                                                   S, N, D), B, stream)) != cudaSuccess)
    return err;
  LSIM_NAME(w_row_softmax)<<<B * S, kThreads, 0, stream>>>(f.raw, f.a2, f.row_m, f.row_iz,
                                                           text_start, sh, temp1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  LSIM_NAME(w_col_softmax)<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      f.raw, f.a2, f.dot, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_product(LSIM_NAME(p_ga2), args(f.gram, sh.sp, s_g, f.a2, sh.np, s_x, f.ga2, sh.np,
                                               s_x, S, N, S), B, stream);
}

}  // namespace
