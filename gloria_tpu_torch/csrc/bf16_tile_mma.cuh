// One block's 128 x 128 output tile of a bf16 product with f32 accumulation,
// on the tensor cores through nvcuda::wmma 16x16x16 fragments.
//
// Shared by fused_bn_fwd.cu (K3) and fused_bn_bwd.cu (K4).  The kernels stage
// each 32-deep chunk of both operands into shared memory themselves (that is
// where they apply their prologues: scale/shift/relu, the cotangent G) and
// hand the staged chunk to TileMma::step.  8 warps in a 4 x 2 grid; each warp
// owns 32 rows x 64 columns of the tile, 2 x 4 accumulator fragments.
//
// Staged layouts (bf16 elements; every fragment pointer is 32-byte aligned):
//   A row-major: As[128 rows][kDepth + kPad]        element (i, d) at i * ldA + d
//   A col-major: As[kDepth][128 + kPad]              element (i, d) at d * ldA + i
//   B row-major: Bs[kDepth][128 + kPad]              element (d, j) at d * ldB + j
//   B col-major: Bs[128 cols][kDepth + kPad]         element (d, j) at j * ldB + d

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;  // 8 warps
// two blocks per SM: caps the kernels at 128 registers a thread (65536 / 512)
constexpr int kMinBlocks = 2;
constexpr int kTile = 128;     // rows and columns of the block's output tile
constexpr int kDepth = 32;     // depth of one staged chunk
constexpr int kPad = 8;        // bf16 row padding: strides stay multiples of 8 elements
constexpr int kShort = kDepth + kPad;  // stride of a staged [.][kDepth] array
constexpr int kLong = kTile + kPad;    // stride of a staged [.][kTile] array
constexpr int kLdc = kTile + 4;        // stride of the f32 output tile in shared memory
constexpr int kChunkElems = kTile * kShort > kDepth * kLong ? kTile * kShort : kDepth * kLong;
// shared memory: two staged chunks, or (after the products) the f32 output tile
constexpr size_t kStageBytes = 2 * sizeof(bf16) * kChunkElems;
constexpr size_t kOutBytes = sizeof(float) * kTile * kLdc;
constexpr size_t kSmemBytes = kStageBytes > kOutBytes ? kStageBytes : kOutBytes;

template <typename LayoutA, typename LayoutB>
struct TileMma {
  static constexpr bool kAColMajor = std::is_same<LayoutA, wmma::col_major>::value;
  static constexpr bool kBColMajor = std::is_same<LayoutB, wmma::col_major>::value;
  static constexpr int kLdA = kAColMajor ? kLong : kShort;
  static constexpr int kLdB = kBColMajor ? kShort : kLong;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  int row0, col0;  // the warp's first row and column in the tile

  __device__ explicit TileMma(int warp) : row0((warp >> 1) * 32), col0((warp & 1) * 64) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  // acc += As @ Bs over one staged chunk of depth kDepth
  __device__ void step(const bf16* As, const bf16* Bs) {
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0 + 16 * i;
        wmma::load_matrix_sync(a[i], kAColMajor ? As + kk * kLdA + r : As + r * kLdA + kk, kLdA);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + 16 * j;
        wmma::load_matrix_sync(b[j], kBColMajor ? Bs + c * kLdB + kk : Bs + kk * kLdB + c, kLdB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // the f32 sums into Cs[kTile][kLdc], row-major
  __device__ void store(float* Cs) const {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Cs + (row0 + 16 * i) * kLdc + col0 + 16 * j, acc[i][j], kLdc,
                                wmma::mem_row_major);
  }
};

// Walks a [kRows][kWidth] array with the block: thread t owns column
// t % kWidth and rows t / kWidth + s * (kThreads / kWidth).  For each batch of
// kBatch of its rows it first calls load(row, col) on all of them, then
// use(row, col, value): the loads of a batch are issued together, so the
// thread waits on device memory once a batch instead of once an entry.  load
// must not read out of bounds for any row and column of the array (the
// kernels clamp the index and let use() mask the value).
constexpr int kBatch = 8;

template <int kRows, int kWidth, typename Load, typename Use>
__device__ __forceinline__ void for_each_entry(int tid, Load load, Use use) {
  constexpr int kStep = kThreads / kWidth;
  constexpr int kIters = kRows / kStep;
  static_assert(kThreads % kWidth == 0 && kIters % kBatch == 0, "the batches must tile the array");
  const int col = tid % kWidth, row = tid / kWidth;
#pragma unroll
  for (int b = 0; b < kIters; b += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = load(row + (b + j) * kStep, col);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) use(row + (b + j) * kStep, col, v[j]);
  }
}

__device__ __forceinline__ int64_t clamp_row(int64_t m, int64_t last) { return m < last ? m : last; }

// a = y * scale + shift, rounded after the product and after the sum (no fma),
// so the relu mask and z agree bit for bit with the plain version
__device__ __forceinline__ float bn_apply(float y, float scale, float shift) {
  return __fadd_rn(__fmul_rn(y, scale), shift);
}

}  // namespace tile
