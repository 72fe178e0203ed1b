// Fused bottleneck tail, forward (K3): bn2-apply + relu + the 1x1 conv3 as a
// product, with bn3's per-channel sum and sum of squares.
//
// Replaces scripts/experiments/fused_bn.py:_fwd_kernel (launched by
// _fwd_pallas).  For y2 [M, K] bf16, scale/shift [K] f32 (bn2 folded),
// w [K, N] f32:
//   z  = bf16(relu(y2 * scale + shift))     rows past M zero
//   y3 = bf16(z @ bf16(w))                  f32 sums
//   s1 = sum_rows f32(y3),  s2 = sum_rows f32(y3)^2   over the rounded y3
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; chip_smoke.py's
// tail_bounds): 2MKN operations against 2MK + 4KN + 2MN bytes, so bytes at
// ResNet-50's tail shapes (M, K, N) = (270000, 64, 256), (69312, 128, 512)
// and (17328, 256, 1024): 0.052, 0.027 and 0.014 ms; operations at (4800,
// 512, 2048): 0.010 ms.
//
// The design.  A call launches three kernels:
//  * fused_bn_prep (fused_bn_tail.cuh) writes bf16(w) once into the
//    caller's workspace;
//  * fused_bn_fwd_main: persistent blocks, one per SM.  A unit of work is a
//    tile of 128 rows by one chunk of `width` (64, 128, 256) columns of N,
//    numbered row tile by row tile; block b takes the units [b·units /
//    grid, (b + 1)·units / grid) in order.  Where a block's unit starts a
//    row tile (or is its first), the tile's y2 arrives through the ring in
//    64-channel boxes, and the two consumer warpgroups (64 rows each) write
//    z = bf16(relu(y2·scale + shift)) into a buffer that holds all of K for
//    the 128 rows, rows past M zero: z is made once per row tile and block,
//    and stays for the tile's chunks of N.  Then bf16(w) streams through
//    the same ring in chunks of 32 or 64 rows of K by `width` columns (16
//    KB, the same for every row tile, so they come from L2), and each
//    warpgroup runs wgmma m64n{width}k16 with z K-major as A and the chunk
//    MN-major as B (no stage transposes), keeping one chunk's products in
//    flight while it waits for the next.  One producer thread issues every
//    TMA load, 3 to 8 stages ahead (as many as fit in 227 KB beside z).
//    scale and shift come from global memory (L1), 8 channels a thread, where a z
//    box is made.
//    Epilogue, per warp and 64-column piece: the sums are rounded to bf16
//    in registers and staged in 2 KB of the warp's own shared memory
//    (128-byte swizzle, free of bank conflicts), read back 16 bytes a lane
//    and stored to y3 with 16-byte stores, four full 128-byte rows a warp
//    instruction.  The same 16-byte reads give s1 and s2 over the stored
//    values: each lane sums 8 columns over 4 rows, the 4 lanes of a column
//    group are added by shuffles, the 4 warps of a warpgroup in warp order
//    through shared memory, and each warpgroup adds its unit's sums into a
//    row of partial sums of its own in the workspace;
//  * fused_bn_fwd_stats adds the 2·grid rows of partial sums per column in
//    row order.
// No atomics: every sum is taken in an order fixed by the launch plan, so
// y3, s1 and s2 repeat bit for bit from one call to the next.  The plan
// (unit width, stages, grid) comes from the caller
// (experiments/fused_bn.py:_fwd_plan), which this launcher checks.  K and N
// must be multiples of 8 (TMA's 16-byte row stride; the wrapper pads other
// shapes) and K at most 640 (z and 3 stages fill shared memory); 1 <= M <
// 2^31 (TMA coordinates).  Offsets into y3 are 64-bit.
// Launches: one call (three kernels) per BottleneckTail forward; no model
// path calls the op (the JAX package removed it from its ResNet),
// chip_smoke.py drives it on the 16 tails of a ResNet-50 train-mode
// forward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "fused_bn_tail.cuh"
#include "wgmma_tma.cuh"

namespace {

using namespace fused_tail;
using sm90::kAtomBytes;
using sm90::kBlockCols;
using sm90::kRowBytes;

constexpr int kRows = 128;                       // rows of a unit: two consumer warpgroups of 64
constexpr int kStageBytes = kRows * kRowBytes;   // a y2 box (128 rows x 64 channels) or a w chunk
constexpr int kZBlockBytes = kRows * kRowBytes;  // one 64-channel column block of z
constexpr int kConsumerWarps = 8;
constexpr int kWarpBytes = 2048;                 // a warp's epilogue scratch: 16 rows x 64 columns

// launcher errors beside CUDA's own (fused_bn_fwd_error_string)
constexpr int kErrPlan = -1;
constexpr int kErrShape = -2;
constexpr int kErrTensorMap = -3;

// rows of K in a staged chunk of bf16(w) of `width` columns: 16 KB, within one z column block
__host__ __device__ constexpr int w_depth(int width) { return width == 256 ? 32 : 64; }

constexpr int fwd_smem(int k_blocks, int stages) {
  return kAtomBytes + stages * kStageBytes + k_blocks * kZBlockBytes +
         kConsumerWarps * kWarpBytes + kBarrierBytes;
}

// Shared memory: the ring, z (k_blocks column blocks of 128 rows), the
// warps' epilogue scratch, the barriers.
template <int kBN>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
fused_bn_fwd_main(const __grid_constant__ CUtensorMap map_y2, const __grid_constant__ CUtensorMap map_wb,
                  const float* __restrict__ scale, const float* __restrict__ shift,
                  bf16* __restrict__ y3, float* __restrict__ part, int M, int K, int N,
                  int n_chunks, int units, int stages) {
  constexpr int kDepth = w_depth(kBN);
  constexpr uint32_t kWBytes = kBN * kDepth * 2;
  constexpr int kPieces = kBN / kBlockCols;
  const int k_blocks = (K + kBlockCols - 1) / kBlockCols;
  const int w_chunks = (K + kDepth - 1) / kDepth;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  unsigned char* zs = ring + stages * kStageBytes;
  unsigned char* scratch = zs + k_blocks * kZBlockBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(scratch + kConsumerWarps * kWarpBytes);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int u_begin = (int)((int64_t)blockIdx.x * units / gridDim.x);
  const int u_end = (int)((int64_t)(blockIdx.x + 1) * units / gridDim.x);
  if (tid == 0) init_barriers(full, empty, stages, kConsumerWarps);
  __syncthreads();

  if (tid >= 2 * kWarpgroup) {  // the producer warpgroup: one thread issues every copy
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == 2 * kWarpgroup) {
      int s = 0;
      uint32_t phase = 0;
      int64_t issued = 0;
      for (int u = u_begin; u < u_end; ++u) {
        const int rt = u / n_chunks, nc = u % n_chunks;
        if (u == u_begin || nc == 0) {  // the row tile's y2, for z
          for (int kb = 0; kb < k_blocks; ++kb, ++issued) {
            if (issued >= stages) sm90::mbar_wait(empty + s, phase ^ 1);
            sm90::mbar_expect_tx(full + s, kStageBytes);
            sm90::tma_load(ring + s * kStageBytes, &map_y2, full + s, kb * kBlockCols, rt * kRows);
            if (++s == stages) s = 0, phase ^= 1;
          }
        }
        for (int c = 0; c < w_chunks; ++c, ++issued) {  // the chunk's columns of bf16(w)
          if (issued >= stages) sm90::mbar_wait(empty + s, phase ^ 1);
          sm90::mbar_expect_tx(full + s, kWBytes);
          unsigned char* st = ring + s * kStageBytes;
#pragma unroll
          for (int b = 0; b < kPieces; ++b)
            sm90::tma_load(st + b * kDepth * kRowBytes, &map_wb, full + s,
                           nc * kBN + b * kBlockCols, c * kDepth);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int g = tid / kWarpgroup, t128 = tid % kWarpgroup, warp = t128 / 32, lane = tid % 32;
  // a thread's 16-byte groups in the prologue all hold the same 8 columns of a box
  const int cg = sm90::swizzled_col(t128);
  unsigned char* wscr = scratch + (g * 4 + warp) * kWarpBytes;
  const float* slots = reinterpret_cast<const float*>(scratch + g * 4 * kWarpBytes);
  // this warpgroup's row of partial sums [s1 N | s2 N].  Thread t128 owns
  // the entries (stat, n0 + col) for i = t128 + 128x, i = stat·kBN + col, of
  // every chunk n0: it zeroes them here, reads them at the start of each
  // unit (the load lands while the unit's products run) and writes them
  // back with the unit's sums added, so the row needs no barrier and no
  // atomics
  constexpr int kOwned = 2 * kBN / kWarpgroup;
  float* prow = part + (int64_t)(2 * blockIdx.x + g) * 2 * N;
  auto owned = [&](int n0, int x) {  // offset in prow of entry x of chunk n0, or -1 past N
    const int i = t128 + kWarpgroup * x, n = n0 + i % kBN;
    return n < N ? (i / kBN) * N + n : -1;
  };
  for (int n0 = 0; n0 < N; n0 += kBN)
#pragma unroll
    for (int x = 0; x < kOwned; ++x)
      if (owned(n0, x) >= 0) prow[owned(n0, x)] = 0.f;
  const uint32_t z_addr = sm90::smem_addr(zs) + g * 64 * kRowBytes;
  const int grp = lane & 7;                                  // epilogue: this lane's column group
  const bool hi = (lane & 16) != 0, mid = (lane & 8) != 0;   // the sums this lane keeps
  float acc[kBN / 2];
  int s = 0;
  uint32_t phase = 0;
  for (int u = u_begin; u < u_end; ++u) {
    const int rt = u / n_chunks, nc = u % n_chunks;
    const int n0 = nc * kBN;
    float sums[kOwned];
#pragma unroll
    for (int x = 0; x < kOwned; ++x) sums[x] = owned(n0, x) >= 0 ? prow[owned(n0, x)] : 0.f;
    if (u == u_begin || nc == 0) {
      // z of this warpgroup's 64 rows, one 64-channel box at a time
      for (int kb = 0; kb < k_blocks; ++kb) {
        sm90::mbar_wait(full + s, phase);
        const uint4* yt = reinterpret_cast<const uint4*>(ring + s * kStageBytes + g * 64 * kRowBytes);
        uint4* zt = reinterpret_cast<uint4*>(zs + kb * kZBlockBytes + g * 64 * kRowBytes);
        // this thread's 8 channels' scale and shift (K % 8 == 0: all in or all out)
        const int k = kb * kBlockCols + cg;
        float sc[8] = {}, sh[8] = {};
        if (k < K) {
          load8_global(scale + k, sc);
          load8_global(shift + k, sh);
        }
        uint4 y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = yt[t128 + kWarpgroup * i];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int v = t128 + kWarpgroup * i;
          uint4 out = make_uint4(0u, 0u, 0u, 0u);
          if (rt * kRows + 64 * g + sm90::swizzled_row(v) < M) {
            float f[8], z[8];
            unpack8(y[i], f);
#pragma unroll
            for (int e = 0; e < 8; ++e) z[e] = fmaxf(bn_apply(f[e], sc[e], sh[e]), 0.f);
            out = pack8(z);
          }
          zt[v] = out;
        }
        sm90::fence_proxy_async();
        release(empty + s, lane);
        if (++s == stages) s = 0, phase ^= 1;
      }
      sm90::named_barrier(1 + g, kWarpgroup);  // the warpgroup's z is complete
    }

    // y3 tile = z · bf16(w)[:, chunk], over the staged chunks of K
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    int pending = -1;
    for (int c = 0; c < w_chunks; ++c) {
      sm90::mbar_wait(full + s, phase);
      sm90::wgmma_fence();
      const uint32_t a_addr =
          z_addr + (c * kDepth / kBlockCols) * kZBlockBytes + (c * kDepth % kBlockCols) / 16 * 32;
      const uint32_t b_addr = sm90::smem_addr(ring + s * kStageBytes);
#pragma unroll
      for (int k = 0; k < kDepth / 16; ++k)
        sm90::wgmma_bf16<0, 1>(acc, sm90::wgmma_desc(a_addr + 32 * k, 16, kAtomBytes),
                               sm90::wgmma_desc(b_addr + 16 * kRowBytes * k, kDepth * kRowBytes,
                                                kAtomBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (pending >= 0) release(empty + pending, lane);
      pending = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    sm90::wgmma_wait<0>();
    sm90::wgmma_fence_operands(acc);
    release(empty + pending, lane);

    // epilogue: per 64-column piece, round, stage, store 16 bytes a lane and sum
    const int64_t m0 = (int64_t)rt * kRows + 64 * g + 16 * warp;  // the warp's first row
    float kept[kPieces][4];
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (lane >> 2) + 8 * h, j = 8 * q + jj;
          *reinterpret_cast<uint32_t*>(wscr + r * kRowBytes + ((jj ^ (r & 7)) << 4) + 4 * (lane & 3)) =
              pack2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      __syncwarp();
      const int n = n0 + q * kBlockCols + 8 * grp;
      float s1[8] = {}, s2[8] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * i + (lane >> 3);
        const uint4 v = *reinterpret_cast<const uint4*>(wscr + r * kRowBytes + ((grp ^ (r & 7)) << 4));
        if (m0 + r < M && n < N) *reinterpret_cast<uint4*>(y3 + (m0 + r) * N + n) = v;
        float f[8];
        unpack8(v, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s1[e] += f[e];
          s2[e] += f[e] * f[e];
        }
      }
      __syncwarp();  // the next piece reuses the scratch
      // the 4 lanes of column group grp (lane bits 3, 4) add up: a lane keeps
      // s2 (hi) or s1, of its group's columns 4..7 (mid) or 0..3
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        t[e] = (hi ? s2[e] : s1[e]) + __shfl_xor_sync(0xffffffffu, hi ? s1[e] : s2[e], 16);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kept[q][e] = (mid ? t[e + 4] : t[e]) + __shfl_xor_sync(0xffffffffu, mid ? t[e] : t[e + 4], 8);
    }
    // the warp's sums [s1 kBN | s2 kBN] into its scratch, then the
    // warpgroup's, in warp order, into its partial sums
    float* slot = reinterpret_cast<float*>(wscr);
#pragma unroll
    for (int q = 0; q < kPieces; ++q)
      *reinterpret_cast<float4*>(slot + (hi ? kBN : 0) + q * kBlockCols + 8 * grp + (mid ? 4 : 0)) =
          make_float4(kept[q][0], kept[q][1], kept[q][2], kept[q][3]);
    sm90::named_barrier(1 + g, kWarpgroup);
    constexpr int kSlot = kWarpBytes / 4;
#pragma unroll
    for (int x = 0; x < kOwned; ++x) {
      const int i = t128 + kWarpgroup * x;
      const float v = ((slots[i] + slots[kSlot + i]) + slots[2 * kSlot + i]) + slots[3 * kSlot + i];
      if (owned(n0, x) >= 0) prow[owned(n0, x)] = sums[x] + v;
    }
    sm90::named_barrier(1 + g, kWarpgroup);  // the scratch is free again
  }
}

// stats[i] for i in [0, 2N) (s1 then s2) = the sum of part[r][i] over the
// `rows` rows of partial sums, in row order: warp w of a block adds rows
// [w·rows / 32, (w + 1)·rows / 32) for 32 columns, then the 32 warps' sums
// are added in warp order
__global__ void __launch_bounds__(1024)
fused_bn_fwd_stats(const float* __restrict__ part, float* __restrict__ stats, int rows, int n2) {
  __shared__ float sums[32][33];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (i < n2) {
    const int r1 = (warp + 1) * rows / 32;
#pragma unroll 4
    for (int r = warp * rows / 32; r < r1; ++r) v += part[(int64_t)r * n2 + i];
  }
  sums[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && i < n2) {
    float t = sums[0][lane];
#pragma unroll
    for (int w = 1; w < 32; ++w) t += sums[w][lane];
    stats[i] = t;
  }
}

template <int kBN>
int launch_main(const CUtensorMap& y2, const bf16* wb, const float* scale, const float* shift,
                bf16* y3, float* part, int M, int K, int N, int grid, int stages,
                cudaStream_t stream) {
  CUtensorMap wmap;
  if (!sm90::encode_tile_map(&wmap, wb, K, N, w_depth(kBN))) return kErrTensorMap;
  const int smem = fwd_smem((K + kBlockCols - 1) / kBlockCols, stages);
  auto kernel = fused_bn_fwd_main<kBN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (N + kBN - 1) / kBN;
  const int units = (M + kRows - 1) / kRows * n_chunks;
  if (grid < 1 || grid > units) return kErrPlan;
  kernel<<<grid, 3 * kWarpgroup, smem, stream>>>(y2, wmap, scale, shift, y3, part, M, K, N,
                                                 n_chunks, units, stages);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// y2 [M, K] bf16, scale/shift [K] f32, w [K, N] f32 -> y3 [M, N] bf16 and
// stats [2][N] f32 (s1, then s2); workspace: bf16(w) (2·K·N bytes), then
// 2·grid rows of 2N f32 partial sums.  All contiguous and 16-byte aligned,
// on the device of `stream`; K and N multiples of 8, K <= 640, 1 <= M <
// 2^31.  The launch plan (experiments/fused_bn.py:_fwd_plan): the unit
// width (64, 128, 256 columns of N), the grid and the ring's stages.
// Returns 0, a CUDA error code, or a negative code of this launcher
// (fused_bn_fwd_error_string).
int fused_bn_fwd(const void* y2, const float* scale, const float* shift, const float* w,
                 void* y3, float* stats, void* workspace, long long M, int K, int N, int width,
                 int grid, int stages, void* stream) {
  if (M < 1 || M > INT_MAX || K < 8 || N < 8 || K % 8 || N % 8) return kErrShape;
  const void* ptrs[] = {y2, scale, shift, w, y3, stats, workspace};
  for (const void* p : ptrs)
    if (!aligned16(p)) return kErrShape;
  if (stages < 3 || stages > kMaxStages || fwd_smem((K + kBlockCols - 1) / kBlockCols, stages) > kSmemLimit)
    return kErrPlan;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* wb = static_cast<bf16*>(workspace);
  float* part = reinterpret_cast<float*>(static_cast<unsigned char*>(workspace) + 2 * (int64_t)K * N);
  CUtensorMap y2map;
  if (!sm90::encode_tile_map(&y2map, y2, M, K, kRows)) return kErrTensorMap;

  int err = launch_prep(w, wb, nullptr, nullptr, nullptr, K, N, st);
  if (err != 0) return err;
  bf16* out = static_cast<bf16*>(y3);
  err = kErrPlan;
  if (width == 64) err = launch_main<64>(y2map, wb, scale, shift, out, part, (int)M, K, N, grid, stages, st);
  if (width == 128) err = launch_main<128>(y2map, wb, scale, shift, out, part, (int)M, K, N, grid, stages, st);
  if (width == 256) err = launch_main<256>(y2map, wb, scale, shift, out, part, (int)M, K, N, grid, stages, st);
  if (err != 0) return err;
  fused_bn_fwd_stats<<<(2 * N + 31) / 32, 1024, 0, st>>>(part, stats, 2 * grid, 2 * N);
  return (int)cudaGetLastError();
}

const char* fused_bn_fwd_error_string(int code) {
  switch (code) {
    case kErrPlan: return "launch plan not supported by the kernels (width, grid or stages)";
    case kErrShape: return "shape or alignment not supported (K, N multiples of 8, K <= 640, M < 2^31, 16-byte aligned)";
    case kErrTensorMap: return "cuTensorMapEncodeTiled unavailable or failed";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
