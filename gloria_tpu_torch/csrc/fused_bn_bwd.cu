// Fused bottleneck tail, backward (K4): the gradients of fused_bn_fwd.cu's
// outputs (y3, s1, s2) with respect to y2, scale, shift and w.
//
// Replaces scripts/experiments/fused_bn.py:_bwd_kernel (launched by
// _bwd_pallas, wired by the custom VJP).  For the forward's inputs, its y3,
// and the cotangents gy3 [M, N] bf16, gs1/gs2 [N] f32:
//   G      = bf16(gy3 + gs1 + 2 y3 gs2)             the cotangent of y3's f32 sums
//   dz     = G @ bf16(w)^T                          [M, K] f32
//   a      = y2 * scale + shift,  mask = a > 0
//   dy2    = bf16(dz * mask * scale)
//   dscale = sum_rows dz * mask * y2,  dshift = sum_rows dz * mask      [K] f32
//   dW     = bf16(relu(a))^T @ G                    [K, N] f32
//
// The two products contract over different axes: dz over N, dW over M, the
// long axis (270000 rows at ResNet-50's layer 1).  So one call launches two
// kernels on the stream:
//  * the row pass, a 2-D grid over (128-row tile, 128-column tile of K):
//    stages G (computed from y3, gy3, gs1, gs2 and rounded to bf16) and
//    bf16(w) chunk by chunk along N, takes dz on the tensor cores, and in its
//    epilogue recomputes a from y2, stores dy2 and adds the tile's dscale /
//    dshift column sums with f32 atomics into zeroed [K] outputs;
//  * the dW pass, a 3-D grid over (128-column tile of N, 128-row tile of K,
//    split of M): each block stages z^T and G for its rows chunk by chunk,
//    sums z^T @ G on the tensor cores and adds its partial [128 x 128] tile
//    into the zeroed dW with f32 atomics.  The splits are chosen so that
//    the grid fills one wave of resident blocks (the occupancy API's count,
//    two per SM at ~100 registers a thread).
// Neither pass reads a or G back from device memory: both recompute them
// elementwise, as the TPU kernel does.  a = y2*scale + shift is rounded after
// the product and after the sum (no fma), and G likewise, so the mask, z and
// G agree bit for bit with the plain version.  Offsets are 64-bit.
// What bounds it on an H100: bytes at three of ResNet-50's four tail shapes
// (4MK + 4MN + 8KN bytes against 4MKN bf16 operations), operations at
// layer 4 (K = 512, N = 2048).  This first design re-reads y3 and gy3 once per
// 128-wide tile of K in each pass, and does not overlap loads with products;
// each thread issues the loads of 8 entries before it uses any
// (for_each_entry), in the staging and in the row pass's epilogue.
// Launches: one call (two kernels) per BottleneckTail backward.

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

__device__ __forceinline__ float cotangent(bf16 y3, bf16 gy3, float gs1, float gs2) {
  return __fadd_rn(__fadd_rn(__bfloat162float(gy3), gs1),
                   __fmul_rn(__fmul_rn(2.f, __bfloat162float(y3)), gs2));
}

// dz = G @ bf16(w)^T, then dy2, dscale and dshift from it
__global__ void __launch_bounds__(kThreads, tile::kMinBlocks)
fused_bn_bwd_rows_kernel(const bf16* __restrict__ y2, const float* __restrict__ scale,
                         const float* __restrict__ shift, const float* __restrict__ w,
                         const bf16* __restrict__ y3, const bf16* __restrict__ gy3,
                         const float* __restrict__ gs1, const float* __restrict__ gs2,
                         bf16* __restrict__ dy2, float* __restrict__ dscale,
                         float* __restrict__ dshift, int64_t M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // G chunk [kTile rows][kShort]
  bf16* Bs = As + tile::kChunkElems;         // w chunk, [kTile of K][kShort of N]: w^T col-major
  float* Cs = reinterpret_cast<float*>(smem);  // after the products: dz [kTile][kLdc]

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int col0 = blockIdx.y * kTile;  // into K
  tile::TileMma<wmma::row_major, wmma::col_major> mma(tid >> 5);

  const int64_t m_last = M - 1;
  for (int n0 = 0; n0 < N; n0 += kDepth) {
    // G chunk: this thread's column n is fixed, so are gs1[n] and gs2[n]
    const int n = n0 + tid % kDepth;
    const int nc = min(n, N - 1);
    const float g1 = gs1[nc], g2 = gs2[nc];
    tile::for_each_entry<kTile, kDepth>(
        tid,
        [&](int r, int) {
          const int64_t at = tile::clamp_row(row0 + r, m_last) * N + nc;
          return cotangent(y3[at], gy3[at], g1, g2);
        },
        [&](int r, int d, float g) {
          As[r * kShort + d] = __float2bfloat16((row0 + r < M && n < N) ? g : 0.f);
        });
    // w^T chunk, staged [k][n]: the same column n, so a warp reads 32
    // neighbouring entries of a row of w
    tile::for_each_entry<kTile, kDepth>(
        tid, [&](int c, int) { return w[(int64_t)min(col0 + c, K - 1) * N + nc]; },
        [&](int c, int d, float v) {
          Bs[c * kShort + d] = __float2bfloat16((col0 + c < K && n < N) ? v : 0.f);
        });
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();

  // dy2, and this tile's share of dscale and dshift: thread (c, half) walks
  // column k = col0 + c over every other row
  const int k = min(col0 + tid % kTile, K - 1);
  const float sc = scale[k], sh = shift[k];
  float psc = 0.f, psh = 0.f;
  tile::for_each_entry<kTile, kTile>(
      tid,
      [&](int r, int) { return __bfloat162float(y2[tile::clamp_row(row0 + r, m_last) * K + k]); },
      [&](int r, int c, float y) {
        const int64_t m = row0 + r;
        if (m >= M || col0 + c >= K) return;
        const float dzm = tile::bn_apply(y, sc, sh) > 0.f ? Cs[r * kLdc + c] : 0.f;
        dy2[m * K + k] = __float2bfloat16(__fmul_rn(dzm, sc));
        psc += dzm * y;
        psh += dzm;
      });
  if (col0 + tid % kTile < K) {
    atomicAdd(dscale + k, psc);
    atomicAdd(dshift + k, psh);
  }
}

// dW += bf16(relu(a))^T @ G over the rows [m_begin, m_end) of this split
__global__ void __launch_bounds__(kThreads, tile::kMinBlocks)
fused_bn_bwd_dw_kernel(const bf16* __restrict__ y2, const float* __restrict__ scale,
                       const float* __restrict__ shift, const bf16* __restrict__ y3,
                       const bf16* __restrict__ gy3, const float* __restrict__ gs1,
                       const float* __restrict__ gs2, float* __restrict__ dw, int64_t M,
                       int K, int N, int64_t rows_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // z chunk [kDepth rows][kLong of K]: z^T col-major
  bf16* Bs = As + tile::kChunkElems;         // G chunk [kDepth rows][kLong of N]
  float* Cs = reinterpret_cast<float*>(smem);  // after the products: [kTile][kLdc]

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kTile;  // into N
  const int k0 = blockIdx.y * kTile;    // into K
  const int64_t m_begin = (int64_t)blockIdx.z * rows_per_split;
  const int64_t m_end = m_begin + rows_per_split < M ? m_begin + rows_per_split : M;
  tile::TileMma<wmma::col_major, wmma::row_major> mma(tid >> 5);

  const int64_t m_last = m_end - 1;
  // this thread's column of both chunks is fixed: k of the z^T chunk, n of G
  const int k = k0 + tid % kTile, kc = min(k, K - 1);
  const int n = col0 + tid % kTile, nc = min(n, N - 1);
  const float sc = scale[kc], sh = shift[kc], g1 = gs1[nc], g2 = gs2[nc];
  for (int64_t mc = m_begin; mc < m_end; mc += kDepth) {
    tile::for_each_entry<kDepth, kTile>(
        tid,
        [&](int d, int) {
          return __bfloat162float(y2[tile::clamp_row(mc + d, m_last) * K + kc]);
        },
        [&](int d, int c, float y) {
          const float z = (mc + d < m_end && k < K) ? fmaxf(tile::bn_apply(y, sc, sh), 0.f) : 0.f;
          As[d * kLong + c] = __float2bfloat16(z);
        });
    tile::for_each_entry<kDepth, kTile>(
        tid,
        [&](int d, int) {
          const int64_t at = tile::clamp_row(mc + d, m_last) * N + nc;
          return cotangent(y3[at], gy3[at], g1, g2);
        },
        [&](int d, int c, float g) {
          Bs[d * kLong + c] = __float2bfloat16((mc + d < m_end && n < N) ? g : 0.f);
        });
    __syncthreads();
    mma.step(As, Bs);
    __syncthreads();
  }
  mma.store(Cs);
  __syncthreads();

  if (n >= N) return;
  for (int r = tid / kTile; r < kTile; r += kThreads / kTile) {
    if (k0 + r >= K) break;
    atomicAdd(dw + (int64_t)(k0 + r) * N + n, Cs[r * kLdc + tid % kTile]);
  }
}

}  // namespace

extern "C" {

// Forward inputs y2 [M, K] bf16, scale/shift [K] f32, w [K, N] f32, the
// forward's y3 [M, N] bf16 and the cotangents gy3 [M, N] bf16, gs1/gs2 [N]
// f32 -> dy2 [M, K] bf16, and dscale/dshift [K] f32 and dw [K, N] f32, which
// must be zeroed: the kernels add into them.  All contiguous, on the device of
// `stream`.  Launches the row pass, then the dW pass; returns the first
// cudaGetLastError() that is not cudaSuccess, else cudaSuccess.
int fused_bn_bwd(const void* y2, const float* scale, const float* shift, const float* w,
                 const void* y3, const void* gy3, const float* gs1, const float* gs2,
                 void* dy2, float* dscale, float* dshift, float* dw, long long M, int K, int N,
                 void* stream) {
  const int smem = (int)tile::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(fused_bn_bwd_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fused_bn_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;

  const cudaStream_t s = (cudaStream_t)stream;
  const bf16* y2b = static_cast<const bf16*>(y2);
  const bf16* y3b = static_cast<const bf16*>(y3);
  const bf16* gy3b = static_cast<const bf16*>(gy3);
  const unsigned row_tiles = (unsigned)((M + kTile - 1) / kTile);
  const unsigned k_tiles = (unsigned)((K + kTile - 1) / kTile);
  const unsigned n_tiles = (unsigned)((N + kTile - 1) / kTile);

  fused_bn_bwd_rows_kernel<<<dim3(row_tiles, k_tiles), kThreads, smem, s>>>(
      y2b, scale, shift, w, y3b, gy3b, gs1, gs2, static_cast<bf16*>(dy2), dscale, dshift,
      (int64_t)M, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // split M so that the whole grid fits one wave of resident blocks (a
  // second, partial wave would nearly double the pass); each split covers a
  // whole number of kDepth-row chunks
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_bn_bwd_dw_kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)k_tiles * n_tiles;
  const long long chunks = (M + kDepth - 1) / kDepth;
  long long splits = (long long)per_sm * sms / tiles;
  if (splits > chunks) splits = chunks;
  if (splits > 65535) splits = 65535;
  if (splits < 1) splits = 1;
  const long long rows_per_split = (chunks + splits - 1) / splits * kDepth;
  splits = (M + rows_per_split - 1) / rows_per_split;
  fused_bn_bwd_dw_kernel<<<dim3(n_tiles, k_tiles, (unsigned)splits), kThreads, smem, s>>>(
      y2b, scale, shift, y3b, gy3b, gs1, gs2, dw, (int64_t)M, K, N, (int64_t)rows_per_split);
  return (int)cudaGetLastError();
}

const char* fused_bn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
