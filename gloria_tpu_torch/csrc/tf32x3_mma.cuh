// Batched f32 matrix product on Hopper's tensor cores at f32 accuracy (3xTF32).
//
//   C[z] = alpha * A[z] B[z] (+ C[z] when accumulate), z = blockIdx.z
//
// Each operand is split into a TF32 high part and a TF32 low part
// (split_tf32); a product sums lo*hi + hi*lo + hi*hi in f32 with mma.sync
// m16n8k8 TF32 fragments, which keeps about 21 of f32's 24 mantissa bits
// per product against plain TF32's 11.  The lo*lo term (2^-22 relative) is
// left out.
//
// Tiles: 128 x 128 outputs per block of 256 threads (8 warps as 2 x 4, each
// 64 x 32), 32-deep chunks staged through shared memory by cp.async in a
// ring of kStages, so the copies of the next chunks run under the products
// of this one.  Every edge (M, N, K) is zero-filled by cp.async's source
// size, so no operand needs padding beyond its leading dimension.
//
// Layouts: kAFastK (A(m, k) at A[m * lda + k]) or not (at A[k * lda + m]);
// kBFastK (B(k, n) at B[n * ldb + k]) or not (at B[k * ldb + n]).  The contiguous
// dimension of each operand is read in 16-byte pieces: base pointers, batch
// strides and leading dimensions must be multiples of 4 floats, the base
// 16-byte aligned.  C is written element by element with any ldc.
// K per batch is `k_len`, except the last batch's `k_last` (a split of one
// long contraction into batches whose partial sums a later pass adds).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int kThreads = 256;
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kLdK = kBK + 4;    // row length of a tile stored k-fastest
constexpr int kLdMN = kBM + 8;   // row length of a tile stored m- or n-fastest
constexpr int kTileFloats = kBM * kLdK > kBK * kLdMN ? kBM * kLdK : kBK * kLdMN;
constexpr int kSmemBytes = kStages * 2 * kTileFloats * (int)sizeof(float);

struct Args {
  const float* a;
  const float* b;
  float* c;
  int m, n, k_len, k_last;
  int lda, ldb, ldc;
  long long stride_a, stride_b, stride_c;
  float alpha;
  int accumulate;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// hi: x rounded to TF32's 10 mantissa bits (half up in magnitude, by an
// integer add and a mask); lo: the exact rest x - hi, truncated to TF32.
// Integer and FP32 operations at full rate, where cvt.rna.tf32.f32 runs on
// the slower conversion unit.  Error per operand <= 2^-21 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy one operand's 128 x 32 chunk into shared memory as 16-byte pieces,
// zero-filling what lies outside the operand.  kKFast: the tile is
// [128 (m or n)][32 (k)], else [32 (k)][128 (m or n)], both as stored in
// device memory.  lim_mn / lim_k: the valid extents from the tile's origin.
template <bool kKFast>
__device__ __forceinline__ void stage_tile(float* tile, const float* src, int ld, int lim_mn,
                                           int lim_k) {
  constexpr int kPieces = kBM * kBK / 4;
#pragma unroll
  for (int i = 0; i < kPieces / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    int outer, inner, valid;
    if (kKFast) {
      outer = p / (kBK / 4);         // m or n
      inner = (p % (kBK / 4)) * 4;   // k
      valid = outer < lim_mn ? min(max(lim_k - inner, 0), 4) : 0;
      cp_async16(tile + outer * kLdK + inner, valid ? src + (long long)outer * ld + inner : src,
                 4 * valid);
    } else {
      outer = p / (kBM / 4);         // k
      inner = (p % (kBM / 4)) * 4;   // m or n
      valid = outer < lim_k ? min(max(lim_mn - inner, 0), 4) : 0;
      cp_async16(tile + outer * kLdMN + inner, valid ? src + (long long)outer * ld + inner : src,
                 4 * valid);
    }
  }
}

// Element (mn, k) of a staged tile.
template <bool kKFast>
__device__ __forceinline__ float tile_at(const float* tile, int mn, int k) {
  return kKFast ? tile[mn * kLdK + k] : tile[k * kLdMN + mn];
}

template <bool kAFastK, bool kBFastK>
__device__ __forceinline__ void product(const Args& p) {
  extern __shared__ __align__(16) float smem[];
  const int z = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int K = (z == (int)gridDim.z - 1) ? p.k_last : p.k_len;
  const float* a = p.a + z * p.stride_a;
  const float* b = p.b + z * p.stride_b;
  // the tile's origin in each operand
  const float* a0 = kAFastK ? a + (long long)m0 * p.lda : a + m0;
  const float* b0 = kBFastK ? b + (long long)n0 * p.ldb : b + n0;
  const int lim_m = p.m - m0;
  const int lim_n = p.n - n0;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset
  const int g = lane >> 2;
  const int t = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto stage = [&](int slot, int kt) {
    float* as = smem + slot * 2 * kTileFloats;
    float* bs = as + kTileFloats;
    const int k0 = kt * kBK;
    stage_tile<kAFastK>(as, kAFastK ? a0 + k0 : a0 + (long long)k0 * p.lda, p.lda, lim_m, K - k0);
    stage_tile<kBFastK>(bs, kBFastK ? b0 + k0 : b0 + (long long)k0 * p.ldb, p.ldb, lim_n, K - k0);
  };

  const int k_tiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt has landed, and every warp is done with chunk kt - 1
    const int next = kt + kStages - 1;
    if (next < k_tiles) stage(next % kStages, next);
    cp_async_commit();

    const float* as = smem + (kt % kStages) * 2 * kTileFloats;
    const float* bs = as + kTileFloats;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        split_tf32(tile_at<kBFastK>(bs, n, kk + t), bh[j][0], bl[j][0]);
        split_tf32(tile_at<kBFastK>(bs, n, kk + t + 4), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm + i * 16 + g;
        uint32_t ah[4], al[4];
        split_tf32(tile_at<kAFastK>(as, m, kk + t), ah[0], al[0]);
        split_tf32(tile_at<kAFastK>(as, m + 8, kk + t), ah[1], al[1]);
        split_tf32(tile_at<kAFastK>(as, m, kk + t + 4), ah[2], al[2]);
        split_tf32(tile_at<kAFastK>(as, m + 8, kk + t + 4), ah[3], al[3]);
        // small terms first, each sweep over 4 independent accumulators
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al, bh[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah, bl[j]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah, bh[j]);
      }
    }
  }
  cp_async_wait<0>();

  float* c = p.c + z * p.stride_c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + i * 16 + g + (r >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + 2 * t + (r & 1);
        if (m < p.m && n < p.n) {
          float* out = c + (long long)m * p.ldc + n;
          const float v = p.alpha * acc[i][j][r];
          *out = p.accumulate ? *out + v : v;
        }
      }
    }
  }
}

inline dim3 grid_of(const Args& p, int batch) {
  return dim3((p.n + kBN - 1) / kBN, (p.m + kBM - 1) / kBM, batch);
}

}  // namespace tf32x3
