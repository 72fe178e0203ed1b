// Fused bottleneck tail, forward (K3): bn2-apply + relu + the 1x1 conv3 as a
// product, with bn3's per-channel sum and sum of squares.
//
// Replaces scripts/experiments/fused_bn.py:_fwd_kernel (launched by
// _fwd_pallas).  For y2 [M, K] bf16, scale/shift [K] f32 (bn2 folded),
// w [K, N] f32:
//   z  = bf16(relu(y2 * scale + shift))
//   y3 = bf16(z @ bf16(w))                  f32 accumulation
//   s1 = sum_rows f32(y3),  s2 = sum_rows f32(y3)^2
//
// Design: a 2-D grid over (128-row tile, 128-column tile), 256 threads.
//  * Prologue: each 32-deep chunk of y2 is staged as z in shared memory
//    (scale, shift and relu applied, rounded to bf16), beside the matching
//    chunk of w rounded to bf16; z never goes to device memory.  Each thread
//    issues the loads of 8 entries before it converts any (for_each_entry).
//  * The product runs on the tensor cores (wmma bf16 fragments, f32 sums;
//    bf16_tile_mma.cuh).
//  * Epilogue: the f32 tile goes through shared memory, is rounded to bf16
//    and stored; the statistics are taken over those bf16-rounded values of
//    the valid rows and added with f32 atomics into zeroed s1, s2.
//  * Rows past M and columns past N are masked, never padded: the TPU
//    kernel's row padding and `valid` mask have no counterpart.  Offsets
//    into y2 and y3 are 64-bit (M * N reaches 6.9e7 at ResNet-50's layer 1).
// What bounds it on an H100: bytes at three of ResNet-50's four tail shapes
// (2MK + 2MN + 4KN bytes against 2MKN bf16 operations: 0.8 K operations a
// byte when N = 4K, against the card's 295 at its bf16 tensor-core peak, so
// the two cross near K = 370), operations at layer 4 (K = 512).  This
// first design keeps the product on the tensor cores but does not overlap
// loads with it (no cp.async / TMA pipeline, two __syncthreads a chunk).
// Launches: one per BottleneckTail forward; no model path calls the op (the
// JAX package removed it from its ResNet), chip_smoke.py drives it on the 16
// tails of a ResNet-50 train-mode forward.

#include <cuda_runtime.h>

#include <stdint.h>

#include "bf16_tile_mma.cuh"

namespace {

using tile::bf16;
using tile::kDepth;
using tile::kLdc;
using tile::kLong;
using tile::kShort;
using tile::kThreads;
using tile::kTile;
namespace wmma = nvcuda::wmma;

__global__ void __launch_bounds__(kThreads, tile::kMinBlocks)
fused_bn_fwd_kernel(const bf16* __restrict__ y2, const float* __restrict__ scale,
                    const float* __restrict__ shift, const float* __restrict__ w,
                    bf16* __restrict__ y3, float* __restrict__ s1, float* __restrict__ s2,
                    int64_t M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // z chunk [kTile][kShort]
  bf16* Bs = As + tile::kChunkElems;         // w chunk [kDepth][kLong]
  float* Cs = reinterpret_cast<float*>(smem);  // after the products: [kTile][kLdc]

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int col0 = blockIdx.y * kTile;
  tile::TileMma<wmma::row_major, wmma::row_major> mma(tid >> 5);

  const int64_t m_last = M - 1;
  const int wn = min(col0 + tid % kTile, N - 1);  // this thread's column of the w chunk
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    // z chunk: this thread's column k is fixed, so are its scale and shift
    const int k = k0 + tid % kDepth;
    const int kc = min(k, K - 1);
    const float sc = scale[kc], sh = shift[kc];
    tile::for_each_entry<kTile, kDepth>(
        tid,
        [&](int r, int) {
          return __bfloat162float(y2[tile::clamp_row(row0 + r, m_last) * K + kc]);
        },
        [&](int r, int d, float y) {
          const float z = (row0 + r < M && k < K) ? fmaxf(tile::bn_apply(y, sc, sh), 0.f) : 0.f;
          As[r * kShort + d] = __float2bfloat16(z);
        });
    tile::for_each_entry<kDepth, kTile>(
        tid, [&](int d, int) { return w[(int64_t)min(k0 + d, K - 1) * N + wn]; },
        [&](int d, int c, float v) {
          Bs[d * kLong + c] = __float2bfloat16((k0 + d < K && col0 + c < N) ? v : 0.f);
        });
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();

  // round to bf16, store, and sum the rounded values: thread (c, half) walks
  // column c over every other row, so a warp stores 32 neighbouring columns
  const int c = tid % kTile;
  const int n = col0 + c;
  if (n >= N) return;
  float p1 = 0.f, p2 = 0.f;
  for (int r = tid / kTile; r < kTile; r += kThreads / kTile) {
    const int64_t m = row0 + r;
    if (m >= M) break;
    const bf16 v = __float2bfloat16(Cs[r * kLdc + c]);
    y3[m * N + n] = v;
    const float f = __bfloat162float(v);
    p1 += f;
    p2 += f * f;
  }
  atomicAdd(s1 + n, p1);
  atomicAdd(s2 + n, p2);
}

}  // namespace

extern "C" {

// y2 [M, K] bf16, scale/shift [K] f32, w [K, N] f32 -> y3 [M, N] bf16 and
// s1, s2 [N] f32, which must be zeroed: the kernel adds into them.  All
// contiguous, on the device of `stream`.  Returns cudaGetLastError() after
// the launch.
int fused_bn_fwd(const void* y2, const float* scale, const float* shift, const float* w,
                 void* y3, float* s1, float* s2, long long M, int K, int N, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(fused_bn_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kTile - 1) / kTile), (unsigned)((N + kTile - 1) / kTile));
  fused_bn_fwd_kernel<<<grid, kThreads, tile::kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(y2), scale, shift, w, static_cast<bf16*>(y3), s1, s2,
      (int64_t)M, K, N);
  return (int)cudaGetLastError();
}

const char* fused_bn_fwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
