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
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s; chip_smoke.py's
// tail_bounds): 4MKN operations against 4MK + 4MN + 8KN bytes, so bytes at
// ResNet-50's tail shapes (M, K, N) = (270000, 64, 256), (69312, 128, 512)
// and (17328, 256, 1024): 0.103, 0.053 and 0.027 ms; operations at (4800,
// 512, 2048): 0.020 ms.
//
// The design.  The two products contract over different axes (dz over N,
// per row; dW over M, the long axis).  A call launches fused_bn_prep
// (fused_bn_tail.cuh, shared with K3), which writes bf16(w) once into the
// caller's workspace and zeroes dscale, dshift and dW, then either two
// passes or, where K <= 64 and N <= 256, one:
//  * fused_bn_bwd_dz, the dz pass: persistent blocks walk output tiles of
//    128 rows (64 when M <= 64) x all of K up to 256 (two 256-wide tiles at
//    K = 512), so y3 and gy3 are read once per row while K <= 256.  Its
//    epilogue reads y2 (prefetched into registers before the tile's
//    products where K <= 128), writes dy2 and sums the columns of dz·mask·y2
//    and dz·mask per warp in shared memory; each block adds its sums into
//    dscale / dshift once;
//  * fused_bn_bwd_dw, the dW pass: output tiles of 64 or 128 channels x up
//    to 256 columns of N, and the (tile, 32-row chunk) units split evenly
//    over one wave of blocks, so every SM works and y2 is read N / 256
//    times.  A block adds its partial sum of each tile it touches into dW
//    with f32 atomics (pairs of columns);
//  * fused_bn_bwd_fused (K <= 64, N <= 256: ResNet-50's layer 1): 64-row
//    tiles; per tile z is computed once from the staged y2, per 64-column
//    chunk G once, and both products take that G, so every input is read
//    once; each block keeps dW's 64 x N sums in registers across its tiles
//    and adds them into dW once.
// The passes stream 16-byte-aligned boxes of y3, gy3 and bf16(w) or y2 with
// TMA (cp.async.bulk.tensor), and slices of gs1, gs2, scale and shift with
// bulk copies, into a ring of 3 to 8 shared-memory stages (as many as fit
// in 227 KB), filled by one producer thread a block and released by
// mbarriers, so the copies of the next stages overlap the products of this
// one.  One or two consumer warpgroups compute, per staged chunk, the
// operand tiles in place: G and in the dW pass z = bf16(relu(y2·scale +
// shift)), rows past M zero, with 16-byte shared-memory accesses and each
// thread's parameters loaded once a chunk.  a and G are rounded after each
// product and each sum (__fmul_rn, __fadd_rn; no fma), so the mask, z and
// G agree bit for bit with the plain version.  Then they fence the stores
// to the async proxy and issue wgmma m64nNk16 (bf16 in, f32 sums) with both
// operands in shared memory, keeping one chunk's products in flight while
// the next chunk's operands are computed: dz = G·wbᵀ takes both operands
// K-major (rows of G and of bf16(w) along N), dW = zᵀ·G both MN-major (rows
// of z and G along K and N, contracted down M), so neither needs a
// transposing stage (wgmma_tma.cuh).  Two consumer warpgroups take 232
// registers from the producer warpgroup (setmaxnreg).  Tile widths, the
// row tiles, the splits and the stage counts come from the caller's launch
// plan (experiments/fused_bn.py:_bwd_plan), which this launcher checks.
// K and N must be multiples of 8 (TMA's 16-byte row stride): the wrapper
// pads other shapes.  Offsets into y2 / dy2 / dW are 64-bit; M < 2^31 (TMA
// coordinates).  Column sums and dW use f32 atomics across blocks, so their
// order varies from run to run within the tolerance of
// fused_bn.grad_errors.
// Launches: one call (two or three kernels) per BottleneckTail backward.

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

constexpr int kDwRows = 32;           // rows of M in one stage of the dW pass

// launcher errors beside CUDA's own (fused_bn_bwd_error_string)
constexpr int kErrPlan = -1;
constexpr int kErrShape = -2;
constexpr int kErrTensorMap = -3;

__device__ __forceinline__ float cotangent(float y3, float gy3, float gs1, float gs2) {
  return __fadd_rn(__fadd_rn(gy3, gs1), __fmul_rn(__fmul_rn(2.f, y3), gs2));
}

// adds part (dscale at columns k, k + 1, dshift at k, k + 1) summed over the
// warp's 8 lanes that hold those columns into the warp's slots at ws
// (dscale) and ws + width (dshift); the lanes 0-3 own the slots
__device__ __forceinline__ void warp_column_sums(float (&part)[4], float* ws, int lane, int width) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[q] += __shfl_xor_sync(0xffffffffu, part[q], o);
  if (lane < 4) {
    ws[0] += part[0];
    ws[1] += part[1];
    ws[width] += part[2];
    ws[width + 1] += part[3];
  }
}

// Rewrites in place the 16-byte groups of kBlocks column blocks of a staged
// dW chunk (32 rows each), spread over kThreads threads so that each thread
// keeps one column group (8 columns) per block it visits: its rows are 8 or
// 16 apart, so the swizzle puts them at one position.  For each block b and
// column offset col (from the chunk's first column) of its groups, a
// thread calls setup(b, col) once, which loads that column group's
// parameters and returns use(row, group, other), called for each of its
// rows with the group and the group at the same offset in `other` (if
// given); use returns the group to store.  A warp's loads cover 4 rows x
// 128 bytes, free of bank conflicts.
template <int kBlocks, int kThreads, typename Setup>
__device__ __forceinline__ void prologue_groups(int tid, Setup setup, unsigned char* tile,
                                                const unsigned char* other) {
  constexpr int kGroups = kBlocks * kDwRows * 8 / kThreads;  // a thread's groups
  constexpr int kRows = kGroups < 4 ? kGroups : 4;           // its rows, kSpace apart
  constexpr int kVisits = kGroups / kRows;                   // its column blocks
  constexpr int kSpace = kDwRows / kRows;
  const int p = tid & 7, q = tid >> 3, r0 = q % kSpace, b0 = q / kSpace;
  const int col = (p ^ (r0 & 7)) << 3;
#pragma unroll
  for (int j = 0; j < kVisits; ++j) {
    const int b = b0 + j * (kBlocks / kVisits);
    auto use = setup(b, b * kBlockCols + col);
    uint4 y[kRows], o[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int v = b * (kDwRows * 8) + (r0 + i * kSpace) * 8 + p;
      y[i] = reinterpret_cast<const uint4*>(tile)[v];
      o[i] = other ? reinterpret_cast<const uint4*>(other)[v] : y[i];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      reinterpret_cast<uint4*>(tile)[b * (kDwRows * 8) + (r0 + i * kSpace) * 8 + p] =
          use(r0 + i * kSpace, y[i], o[i]);
  }
}

// The dz pass.  kC consumer warpgroups (64 rows each) and a producer warpgroup;
// tile t = (row tile t / k_tiles, K tile t % k_tiles), block b takes tiles b,
// b + grid, ...  The grid is a multiple of k_tiles, so a block keeps one K
// tile: its scale and shift sit in shared memory, and each warp sums its
// columns there, in slots of its own.
//
// Shared memory: the ring (stages x [y3 | gy3 | bf16(w)] chunks), the
// stages' slices of gs1 and gs2 (64 each), the K tile's scale and shift,
// the warps' column sums, the barriers.
template <int kC, int kBK>
__global__ void __launch_bounds__((kC + 1) * kWarpgroup, 1)
fused_bn_bwd_dz(const __grid_constant__ CUtensorMap map_y3, const __grid_constant__ CUtensorMap map_gy3,
                const __grid_constant__ CUtensorMap map_wb, const bf16* __restrict__ y2,
                const float* __restrict__ scale, const float* __restrict__ shift,
                const float* __restrict__ gs1, const float* __restrict__ gs2,
                bf16* __restrict__ dy2, float* __restrict__ dscale, float* __restrict__ dshift,
                int M, int K, int N, int k_tiles, int tiles, int stages) {
  constexpr int kBM = 64 * kC;
  constexpr int kWarps = 4 * kC;
  constexpr int kYBytes = kBM * kRowBytes;  // a chunk of y3 (and of gy3): kBM rows x 64 columns
  constexpr int kStageBytes = 2 * kYBytes + kBK * kRowBytes;  // + bf16(w): kBK rows x 64 columns
  // loads a thread issues before it uses any: 16-byte groups in the
  // prologue, y2 pairs in the epilogue (fewer beside 128 accumulators)
  constexpr int kLoads = kBK <= 128 ? 4 : 2;
  constexpr int kBatch = kBK <= 128 ? kBK / 8 : 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  float* gsl = reinterpret_cast<float*>(ring + stages * kStageBytes);  // [stages][gs1 64 | gs2 64]
  float* bn = gsl + stages * 2 * kBlockCols;                           // [scale kBK | shift kBK]
  float* csum = bn + 2 * kBK;                     // [kWarps][dscale kBK | dshift kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(csum + kWarps * 2 * kBK);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int k0 = (blockIdx.x % k_tiles) * kBK;
  const int chunks = (N + kBlockCols - 1) / kBlockCols;
  if (tid == 0) init_barriers(full, empty, stages, kWarps);
  for (int i = tid; i < 2 * kBK; i += blockDim.x) {
    const int k = k0 + i % kBK;
    bn[i] = k < K ? (i < kBK ? scale : shift)[k] : 0.f;
  }
  for (int i = tid; i < kWarps * 2 * kBK; i += blockDim.x) csum[i] = 0.f;
  __syncthreads();

  if (tid >= kC * kWarpgroup) {  // the producer warpgroup: one thread issues every copy
    if (kC == 2) sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kC * kWarpgroup) {
      int s = 0;
      uint32_t phase = 0;
      int64_t u = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / k_tiles) * kBM;
        for (int c = 0; c < chunks; ++c, ++u) {
          const int n0 = c * kBlockCols;
          const uint32_t gs_bytes = 4u * min(kBlockCols, N - n0);
          if (u >= stages) sm90::mbar_wait(empty + s, phase ^ 1);
          sm90::mbar_expect_tx(full + s, kStageBytes + 2 * gs_bytes);
          unsigned char* st = ring + s * kStageBytes;
          sm90::tma_load(st, &map_y3, full + s, n0, row0);
          sm90::tma_load(st + kYBytes, &map_gy3, full + s, n0, row0);
          sm90::tma_load(st + 2 * kYBytes, &map_wb, full + s, n0, k0);
          sm90::bulk_load(gsl + s * 2 * kBlockCols, gs1 + n0, gs_bytes, full + s);
          sm90::bulk_load(gsl + s * 2 * kBlockCols + kBlockCols, gs2 + n0, gs_bytes, full + s);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  if (kC == 2) sm90::setmaxnreg_inc<kConsumerRegs>();
  const int g = tid / kWarpgroup, t128 = tid % kWarpgroup, warp = t128 / 32, lane = tid % 32;
  // a thread's 16-byte groups in the prologue all hold the same 8 columns of a chunk
  const int cg = sm90::swizzled_col(t128);
  float* wsum = csum + (g * 4 + warp) * 2 * kBK;
  float acc[kBK / 2];
  // where K <= 128 a thread holds its tile's y2 pairs from before the
  // mainloop (their loads land while it runs), else it loads them in
  // batches after it; at K = 64 it also keeps its column sums across tiles,
  // else it sums each tile's columns over the warp at once (registers: 168
  // a thread beside the accumulators)
  constexpr bool kHold = kBK <= 128, kKeep = kBK == 64;
  constexpr int kHeld = kHold ? kBK / 8 : 1, kKept = kKeep ? kBK / 8 : 1;
  __nv_bfloat162 held[kHeld][2];
  float colsum[kKept][4] = {};  // dscale at k, k + 1; dshift at k, k + 1
  const int cl = 2 * (lane & 3);
  int s = 0, pending = -1;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = (t / k_tiles) * kBM + 64 * g;  // this warpgroup's 64 rows
    const int64_t ra = row0 + warp * 16 + (lane >> 2);  // the thread's epilogue rows ra, ra + 8
    if (kHold) {
#pragma unroll
      for (int j = 0; j < kHeld; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = k0 + 8 * j + cl;
          const int64_t m = ra + 8 * h;
          held[j][h] = (k < K && m < M)
                           ? __ldg(reinterpret_cast<const __nv_bfloat162*>(y2 + m * K + k))
                           : __floats2bfloat162_rn(0.f, 0.f);
        }
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      sm90::mbar_wait(full + s, phase);
      unsigned char* st = ring + s * kStageBytes;
      unsigned char* gt = st + g * 64 * kRowBytes;  // G is written over this warpgroup's y3 rows
      const unsigned char* gyt = gt + kYBytes;
      if (c * kBlockCols + cg < N) {  // N % 8 == 0: a group is in or out as a whole
        float a[8], b[8];
        load8(gsl + s * 2 * kBlockCols + cg, a);
        load8(gsl + s * 2 * kBlockCols + kBlockCols + cg, b);
        // 512 groups of 8 values (64 rows x 64 columns), kLoads at a time
#pragma unroll
        for (int i0 = 0; i0 < 4; i0 += kLoads) {
          uint4 y[kLoads], gy[kLoads];
#pragma unroll
          for (int i = 0; i < kLoads; ++i) {
            y[i] = *reinterpret_cast<const uint4*>(gt + 16 * (t128 + kWarpgroup * (i0 + i)));
            gy[i] = *reinterpret_cast<const uint4*>(gyt + 16 * (t128 + kWarpgroup * (i0 + i)));
          }
#pragma unroll
          for (int i = 0; i < kLoads; ++i) {
            float fy[8], fg[8], o[8];
            unpack8(y[i], fy);
            unpack8(gy[i], fg);
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] = cotangent(fy[e], fg[e], a[e], b[e]);
            *reinterpret_cast<uint4*>(gt + 16 * (t128 + kWarpgroup * (i0 + i))) = pack8(o);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint4*>(gt + 16 * (t128 + kWarpgroup * i)) = make_uint4(0u, 0u, 0u, 0u);
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(1 + g, kWarpgroup);
      sm90::wgmma_fence();
      const uint32_t a_addr = sm90::smem_addr(gt), b_addr = sm90::smem_addr(st + 2 * kYBytes);
#pragma unroll
      for (int k = 0; k < kBlockCols / 16; ++k)
        sm90::wgmma_bf16<0, 0>(acc, sm90::wgmma_desc(a_addr + 32 * k, 16, kAtomBytes),
                               sm90::wgmma_desc(b_addr + 32 * k, 16, kAtomBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (pending >= 0) release(empty + pending, lane);
      pending = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    sm90::wgmma_wait<0>();
    sm90::wgmma_fence_operands(acc);
    if (pending >= 0) release(empty + pending, lane);
    pending = -1;

    // epilogue: columns k0 + 8j + cl and + 1 of rows ra and ra + 8
#pragma unroll
    for (int j0 = 0; j0 < kBK / 8; j0 += kBatch) {
      __nv_bfloat162 yv[kHold ? 1 : kBatch][2];
      if (!kHold) {
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = k0 + 8 * (j0 + jj) + cl;
            const int64_t m = ra + 8 * h;
            yv[jj][h] = (k < K && m < M)
                            ? __ldg(reinterpret_cast<const __nv_bfloat162*>(y2 + m * K + k))
                            : __floats2bfloat162_rn(0.f, 0.f);
          }
      }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        const int j = j0 + jj;
        const int kc = 8 * j + cl, k = k0 + kc;
        const float2 sc = make_float2(bn[kc], bn[kc + 1]);
        const float2 sh = make_float2(bn[kBK + kc], bn[kBK + kc + 1]);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t m = ra + 8 * h;
          const float2 y = __bfloat1622float2(kHold ? held[kHold ? j : 0][h] : yv[kHold ? 0 : jj][h]);
          const float d0 = bn_apply(y.x, sc.x, sh.x) > 0.f ? acc[4 * j + 2 * h] : 0.f;
          const float d1 = bn_apply(y.y, sc.y, sh.y) > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;
          if (m < M && k < K) {
            *reinterpret_cast<__nv_bfloat162*>(dy2 + m * K + k) =
                __floats2bfloat162_rn(__fmul_rn(d0, sc.x), __fmul_rn(d1, sc.y));
            part[0] += d0 * y.x;
            part[1] += d1 * y.y;
            part[2] += d0;
            part[3] += d1;
          }
        }
        if (kKeep) {
#pragma unroll
          for (int q = 0; q < 4; ++q) colsum[kKeep ? j : 0][q] += part[q];
        } else {
          warp_column_sums(part, wsum + kc, lane, kBK);
        }
      }
    }
  }
  if (kKeep) {
#pragma unroll
    for (int j = 0; j < kKept; ++j) warp_column_sums(colsum[j], wsum + 8 * j + cl, lane, kBK);
  }
  sm90::named_barrier(1 + kC, kC * kWarpgroup);  // every warp's column sums are in
  for (int i = tid; i < 2 * kBK; i += kC * kWarpgroup) {
    const int k = k0 + i % kBK;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += csum[w * 2 * kBK + i];
    if (k < K) atomicAdd((i < kBK ? dscale : dshift) + k, sum);
  }
}

// The dW pass.  kC consumer warpgroups (64 channels each) and a producer
// warpgroup.  Work unit u = (tile u / chunks, 32-row chunk u % chunks), tile =
// (K tile tile / n_tiles, N tile tile % n_tiles); block b takes the units
// [b·units / grid, (b + 1)·units / grid) in order and adds its partial sum of
// each tile it touches into dW.
//
// Shared memory: the ring (stages x [y2 | y3 | gy3] chunks), the stages'
// slices of scale, shift (kBK each), gs1 and gs2 (kBN each), the barriers.
template <int kC, int kBN>
__global__ void __launch_bounds__((kC + 1) * kWarpgroup, 1)
fused_bn_bwd_dw(const __grid_constant__ CUtensorMap map_y2, const __grid_constant__ CUtensorMap map_y3,
                const __grid_constant__ CUtensorMap map_gy3, const float* __restrict__ scale,
                const float* __restrict__ shift, const float* __restrict__ gs1,
                const float* __restrict__ gs2, float* __restrict__ dw, int M, int K, int N,
                int n_tiles, int chunks, int64_t units, int stages) {
  constexpr int kBK = 64 * kC;
  constexpr int kBlockBytes = kDwRows * kRowBytes;  // one column block of a chunk: 32 rows x 64
  constexpr int kZBytes = kC * kBlockBytes;         // y2, then z: kBK channels
  constexpr int kGBytes = (kBN / kBlockCols) * kBlockBytes;  // y3 (then G), gy3: kBN columns
  constexpr int kStageBytes = kZBytes + 2 * kGBytes;
  constexpr int kSlice = 2 * kBK + 2 * kBN;  // floats of a stage's scale, shift, gs1, gs2
  constexpr int kThreads = kC * kWarpgroup;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  float* slices = reinterpret_cast<float*>(ring + stages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(slices + stages * kSlice);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int64_t u_begin = (int64_t)blockIdx.x * units / gridDim.x;
  const int64_t u_end = (int64_t)(blockIdx.x + 1) * units / gridDim.x;
  if (tid == 0) init_barriers(full, empty, stages, 4 * kC);
  __syncthreads();

  if (tid >= kThreads) {  // the producer warpgroup: one thread issues every copy
    if (kC == 2) sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kThreads) {
      int s = 0;
      uint32_t phase = 0;
      for (int64_t u = u_begin; u < u_end; ++u) {
        const int tile = (int)(u / chunks), m0 = (int)(u % chunks) * kDwRows;
        const int c0 = (tile / n_tiles) * kBK, n0 = (tile % n_tiles) * kBN;
        const uint32_t k_bytes = 4u * min(kBK, K - c0), n_bytes = 4u * min(kBN, N - n0);
        if (u - u_begin >= stages) sm90::mbar_wait(empty + s, phase ^ 1);
        sm90::mbar_expect_tx(full + s, kStageBytes + 2 * (k_bytes + n_bytes));
        unsigned char* st = ring + s * kStageBytes;
#pragma unroll
        for (int b = 0; b < kC; ++b)
          sm90::tma_load(st + b * kBlockBytes, &map_y2, full + s, c0 + b * kBlockCols, m0);
#pragma unroll
        for (int b = 0; b < kBN / kBlockCols; ++b) {
          sm90::tma_load(st + kZBytes + b * kBlockBytes, &map_y3, full + s,
                         n0 + b * kBlockCols, m0);
          sm90::tma_load(st + kZBytes + kGBytes + b * kBlockBytes, &map_gy3, full + s,
                         n0 + b * kBlockCols, m0);
        }
        float* sl = slices + s * kSlice;
        sm90::bulk_load(sl, scale + c0, k_bytes, full + s);
        sm90::bulk_load(sl + kBK, shift + c0, k_bytes, full + s);
        sm90::bulk_load(sl + 2 * kBK, gs1 + n0, n_bytes, full + s);
        sm90::bulk_load(sl + 2 * kBK + kBN, gs2 + n0, n_bytes, full + s);
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  if (kC == 2) sm90::setmaxnreg_inc<kConsumerRegs>();
  const int g = tid / kWarpgroup, warp = (tid % kWarpgroup) / 32, lane = tid % 32;
  float acc[kBN / 2];
  int s = 0;
  uint32_t phase = 0;
  // one segment per tile that the block's units touch: the accumulators are
  // zeroed before it and added into dW after it, outside the product loop
  for (int64_t u = u_begin; u < u_end;) {
    const int tile = (int)(u / chunks);
    const int64_t seg_end = (int64_t)(tile + 1) * chunks < u_end ? (int64_t)(tile + 1) * chunks : u_end;
    const int c0 = (tile / n_tiles) * kBK, n0 = (tile % n_tiles) * kBN;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    int pending = -1;
    for (; u < seg_end; ++u) {
      const int m0 = (int)(u % chunks) * kDwRows;
      sm90::mbar_wait(full + s, phase);
      unsigned char* st = ring + s * kStageBytes;
      const float* sl = slices + s * kSlice;
      // z over y2's column blocks and G over y3's, in place (prologue_groups)
      prologue_groups<kC, kThreads>(tid, [&](int, int kc) {  // z: channels c0 + kc
        const bool in = c0 + kc < K;
        float sc[8], sh[8];
        load8(sl + kc, sc);
        load8(sl + kBK + kc, sh);
        return [=](int r, uint4 y, uint4) {
          if (!in || m0 + r >= M) return make_uint4(0u, 0u, 0u, 0u);
          float f[8], z[8];
          unpack8(y, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) z[e] = fmaxf(bn_apply(f[e], sc[e], sh[e]), 0.f);
          return pack8(z);
        };
      }, st, nullptr);
      prologue_groups<kBN / kBlockCols, kThreads>(tid, [&](int, int nc) {  // G: columns n0 + nc
        const bool in = n0 + nc < N;
        float a[8], bb[8];
        load8(sl + 2 * kBK + nc, a);
        load8(sl + 2 * kBK + kBN + nc, bb);
        return [=](int r, uint4 y, uint4 gy) {
          if (!in || m0 + r >= M) return make_uint4(0u, 0u, 0u, 0u);
          float fy[8], fg[8], o[8];
          unpack8(y, fy);
          unpack8(gy, fg);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = cotangent(fy[e], fg[e], a[e], bb[e]);
          return pack8(o);
        };
      }, st + kZBytes, st + kZBytes + kGBytes);
      sm90::fence_proxy_async();
      sm90::named_barrier(1, kThreads);  // G is every warpgroup's B operand
      sm90::wgmma_fence();
      const uint32_t a_addr = sm90::smem_addr(st + g * kBlockBytes);
      const uint32_t b_addr = sm90::smem_addr(st + kZBytes);
#pragma unroll
      for (int k = 0; k < kDwRows / 16; ++k)
        sm90::wgmma_bf16<1, 1>(acc, sm90::wgmma_desc(a_addr + 16 * kRowBytes * k, kBlockBytes, kAtomBytes),
                               sm90::wgmma_desc(b_addr + 16 * kRowBytes * k, kBlockBytes, kAtomBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pending >= 0) release(empty + pending, lane);
      pending = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    sm90::wgmma_wait<0>();
    sm90::wgmma_fence_operands(acc);
    release(empty + pending, lane);

    // this block's share of the tile, into dW: pairs of neighbouring columns
    const int kr = c0 + 64 * g + warp * 16 + (lane >> 2);
    const int cl = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int n = n0 + 8 * j + cl;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kr + 8 * h;
        if (k < K && n < N)
          atomicAdd(reinterpret_cast<float2*>(dw + (int64_t)k * N + n),
                    make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
      }
    }
  }
}

// The fused pass, for K <= 64 and N <= kBN (ResNet-50's layer 1): dz and
// dW from one staged G tile, so every input is read once.  One consumer
// warpgroup (64-row tiles) and a producer warpgroup; block b takes tiles b,
// b + grid, ...  Chunk 0 of a tile also brings its y2 [64 rows x 64
// channels]: the warpgroup writes z = bf16(relu(y2·scale + shift)) into a
// buffer of its own, kept for the tile's dW products, and holds its y2 pairs
// for the epilogue.  Per 64-column chunk of N: G in place, then dz += G·wbᵀ
// (both K-major) and dW[:, chunk] += zᵀ·G (both MN-major).  dW's 64 x kBN
// sums stay in registers across the block's tiles and go into dW once.
//
// Shared memory: the ring (stages x [y3 | gy3 | bf16(w) | y2] chunks; y2
// only in a tile's chunk 0), z, the stages' gs1 / gs2 slices, scale and
// shift, the warps' column sums, the barriers.
template <int kBN>
__global__ void __launch_bounds__(2 * kWarpgroup, 1)
fused_bn_bwd_fused(const __grid_constant__ CUtensorMap map_y3,
                   const __grid_constant__ CUtensorMap map_gy3,
                   const __grid_constant__ CUtensorMap map_wb,
                   const __grid_constant__ CUtensorMap map_y2, const float* __restrict__ scale,
                   const float* __restrict__ shift, const float* __restrict__ gs1,
                   const float* __restrict__ gs2, bf16* __restrict__ dy2,
                   float* __restrict__ dscale, float* __restrict__ dshift, float* __restrict__ dw,
                   int M, int K, int N, int tiles, int stages) {
  constexpr int kChunks = kBN / kBlockCols;
  constexpr int kTileBytes = 64 * kRowBytes;  // 64 rows x 64 columns
  constexpr int kStageBytes = 4 * kTileBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_ring(smem_raw);
  unsigned char* zt = ring + stages * kStageBytes;                      // z: 64 rows x 64 channels
  float* gsl = reinterpret_cast<float*>(zt + kTileBytes);               // [stages][gs1 64 | gs2 64]
  float* bn = gsl + stages * 2 * kBlockCols;                            // [scale 64 | shift 64]
  float* csum = bn + 2 * kBlockCols;                                    // [4 warps][dscale 64 | dshift 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(csum + 4 * 2 * kBlockCols);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int chunks = (N + kBlockCols - 1) / kBlockCols;  // <= kChunks
  if (tid == 0) init_barriers(full, empty, stages, 4);
  for (int i = tid; i < 2 * kBlockCols; i += blockDim.x) {
    const int k = i % kBlockCols;
    bn[i] = k < K ? (i < kBlockCols ? scale : shift)[k] : 0.f;
  }
  for (int i = tid; i < 4 * 2 * kBlockCols; i += blockDim.x) csum[i] = 0.f;
  __syncthreads();

  if (tid >= kWarpgroup) {  // the producer warpgroup: one thread issues every copy
    if (tid == kWarpgroup) {
      int s = 0;
      uint32_t phase = 0;
      int64_t u = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = t * 64;
        for (int c = 0; c < chunks; ++c, ++u) {
          const int n0 = c * kBlockCols;
          const uint32_t gs_bytes = 4u * min(kBlockCols, N - n0);
          if (u >= stages) sm90::mbar_wait(empty + s, phase ^ 1);
          sm90::mbar_expect_tx(full + s, 3 * kTileBytes + (c == 0 ? kTileBytes : 0) + 2 * gs_bytes);
          unsigned char* st = ring + s * kStageBytes;
          sm90::tma_load(st, &map_y3, full + s, n0, row0);
          sm90::tma_load(st + kTileBytes, &map_gy3, full + s, n0, row0);
          sm90::tma_load(st + 2 * kTileBytes, &map_wb, full + s, n0, 0);
          if (c == 0) sm90::tma_load(st + 3 * kTileBytes, &map_y2, full + s, 0, row0);
          sm90::bulk_load(gsl + s * 2 * kBlockCols, gs1 + n0, gs_bytes, full + s);
          sm90::bulk_load(gsl + s * 2 * kBlockCols + kBlockCols, gs2 + n0, gs_bytes, full + s);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32, cl = 2 * (lane & 3);
  const int cg = sm90::swizzled_col(tid);  // the column group of all this thread's prologue groups
  float* wsum = csum + warp * 2 * kBlockCols;
  float accd[32];           // dz: 64 rows x 64 channels
  float accw[kChunks][32];  // dW: 64 channels x 64 columns of each chunk
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) accw[c][i] = 0.f;
  int s = 0, pending = -1;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * 64;
    const int64_t ra = row0 + warp * 16 + (lane >> 2);  // the thread's epilogue rows ra, ra + 8
    __nv_bfloat162 held[8][2];
#pragma unroll
    for (int i = 0; i < 32; ++i) accd[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c >= chunks) break;
      sm90::mbar_wait(full + s, phase);
      unsigned char* st = ring + s * kStageBytes;
      if (c == 0) {
        // z over the tile's y2, into its own buffer; then this thread's y2
        // pairs (accumulator positions) for the epilogue
        const unsigned char* yt = st + 3 * kTileBytes;
        const bool in = cg < K;
        float sc[8], sh[8];
        load8(bn + cg, sc);
        load8(bn + kBlockCols + cg, sh);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int v = tid + kWarpgroup * i;
          uint4 out = make_uint4(0u, 0u, 0u, 0u);
          if (in && row0 + sm90::swizzled_row(v) < M) {
            float y[8], z[8];
            unpack8(reinterpret_cast<const uint4*>(yt)[v], y);
#pragma unroll
            for (int e = 0; e < 8; ++e) z[e] = fmaxf(bn_apply(y[e], sc[e], sh[e]), 0.f);
            out = pack8(z);
          }
          reinterpret_cast<uint4*>(zt)[v] = out;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + (lane >> 2) + 8 * h, col = 8 * j + cl;
            held[j][h] = *reinterpret_cast<const __nv_bfloat162*>(
                yt + r * kRowBytes + ((j ^ (r & 7)) << 4) + 2 * (col & 7));
          }
      }
      // G over the chunk's y3, in place
      unsigned char* gt = st;
      if (c * kBlockCols + cg < N) {
        float a[8], b[8];
        load8(gsl + s * 2 * kBlockCols + cg, a);
        load8(gsl + s * 2 * kBlockCols + kBlockCols + cg, b);
        uint4 y[4], gy[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          y[i] = reinterpret_cast<const uint4*>(gt)[tid + kWarpgroup * i];
          gy[i] = reinterpret_cast<const uint4*>(gt + kTileBytes)[tid + kWarpgroup * i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float fy[8], fg[8], o[8];
          unpack8(y[i], fy);
          unpack8(gy[i], fg);
#pragma unroll
          for (int e = 0; e < 8; ++e) o[e] = cotangent(fy[e], fg[e], a[e], b[e]);
          reinterpret_cast<uint4*>(gt)[tid + kWarpgroup * i] = pack8(o);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          reinterpret_cast<uint4*>(gt)[tid + kWarpgroup * i] = make_uint4(0u, 0u, 0u, 0u);
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(1, kWarpgroup);
      sm90::wgmma_fence();
      const uint32_t g_addr = sm90::smem_addr(gt), w_addr = sm90::smem_addr(st + 2 * kTileBytes);
      const uint32_t z_addr = sm90::smem_addr(zt);
#pragma unroll
      for (int k = 0; k < kBlockCols / 16; ++k)  // dz: contract over the chunk's columns
        sm90::wgmma_bf16<0, 0>(accd, sm90::wgmma_desc(g_addr + 32 * k, 16, kAtomBytes),
                               sm90::wgmma_desc(w_addr + 32 * k, 16, kAtomBytes));
#pragma unroll
      for (int k = 0; k < 64 / 16; ++k)  // dW: contract over the tile's rows
        sm90::wgmma_bf16<1, 1>(accw[c],
                               sm90::wgmma_desc(z_addr + 16 * kRowBytes * k, kTileBytes, kAtomBytes),
                               sm90::wgmma_desc(g_addr + 16 * kRowBytes * k, kTileBytes, kAtomBytes));
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (pending >= 0) release(empty + pending, lane);
      pending = s;
      if (++s == stages) s = 0, phase ^= 1;
    }
    sm90::wgmma_wait<0>();
    sm90::wgmma_fence_operands(accd);
    if (pending >= 0) release(empty + pending, lane);
    pending = -1;

    // epilogue: columns 8j + cl and + 1 of rows ra and ra + 8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * j + cl;
      const float2 sc = make_float2(bn[k], bn[k + 1]);
      const float2 sh = make_float2(bn[kBlockCols + k], bn[kBlockCols + k + 1]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = ra + 8 * h;
        const float2 y = __bfloat1622float2(held[j][h]);
        const float d0 = bn_apply(y.x, sc.x, sh.x) > 0.f ? accd[4 * j + 2 * h] : 0.f;
        const float d1 = bn_apply(y.y, sc.y, sh.y) > 0.f ? accd[4 * j + 2 * h + 1] : 0.f;
        if (m < M && k < K) {
          *reinterpret_cast<__nv_bfloat162*>(dy2 + m * K + k) =
              __floats2bfloat162_rn(__fmul_rn(d0, sc.x), __fmul_rn(d1, sc.y));
          part[0] += d0 * y.x;
          part[1] += d1 * y.y;
          part[2] += d0;
          part[3] += d1;
        }
      }
      warp_column_sums(part, wsum + k, lane, kBlockCols);
    }
  }

  // this block's dW, pairs of neighbouring columns
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    sm90::wgmma_fence_operands(accw[c]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = warp * 16 + (lane >> 2) + 8 * h, n = c * kBlockCols + 8 * j + cl;
        if (k < K && n < N)
          atomicAdd(reinterpret_cast<float2*>(dw + (int64_t)k * N + n),
                    make_float2(accw[c][4 * j + 2 * h], accw[c][4 * j + 2 * h + 1]));
      }
  }
  sm90::named_barrier(1, kWarpgroup);  // every warp's column sums are in
  for (int i = tid; i < 2 * kBlockCols; i += kWarpgroup) {
    const int k = i % kBlockCols;
    const float sum = csum[i] + csum[2 * kBlockCols + i] + csum[4 * kBlockCols + i] +
                      csum[6 * kBlockCols + i];
    if (k < K) atomicAdd((i < kBlockCols ? dscale : dshift) + k, sum);
  }
}

constexpr int fused_smem(int stages) {
  return kAtomBytes + stages * (4 * 64 * kRowBytes + 8 * kBlockCols) + 64 * kRowBytes +
         8 * kBlockCols + 4 * 8 * kBlockCols + kBarrierBytes;
}

constexpr int dz_smem(int rows, int cols, int stages) {
  return kAtomBytes + stages * ((2 * rows + cols) * kRowBytes + 8 * kBlockCols) + 8 * cols +
         (rows / 16) * 8 * cols + kBarrierBytes;
}

constexpr int dw_smem(int cols, int width, int stages) {
  return kAtomBytes +
         stages * ((cols + 2 * width) / kBlockCols * kDwRows * kRowBytes + 8 * (cols + width)) +
         kBarrierBytes;
}

struct Args {
  const bf16 *y2, *y3, *gy3;
  const float *scale, *shift, *w, *gs1, *gs2;
  bf16 *dy2, *wb;
  float *dscale, *dshift, *dw;
  int M, K, N;
  cudaStream_t stream;
};

template <int kC, int kBK>
int launch_dz(const Args& a, int grid, int stages) {
  CUtensorMap y3, gy3, wb;
  if (!sm90::encode_tile_map(&y3, a.y3, a.M, a.N, 64 * kC) ||
      !sm90::encode_tile_map(&gy3, a.gy3, a.M, a.N, 64 * kC) ||
      !sm90::encode_tile_map(&wb, a.wb, a.K, a.N, kBK))
    return kErrTensorMap;
  const int smem = dz_smem(64 * kC, kBK, stages);
  auto kernel = fused_bn_bwd_dz<kC, kBK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int k_tiles = (a.K + kBK - 1) / kBK;
  const int tiles = (int)(((int64_t)a.M + 64 * kC - 1) / (64 * kC)) * k_tiles;
  if (grid < 1 || grid % k_tiles != 0 || grid > tiles) return kErrPlan;
  kernel<<<grid, (kC + 1) * kWarpgroup, smem, a.stream>>>(y3, gy3, wb, a.y2, a.scale, a.shift,
                                                        a.gs1, a.gs2, a.dy2, a.dscale, a.dshift,
                                                        a.M, a.K, a.N, k_tiles, tiles, stages);
  return (int)cudaGetLastError();
}

template <int kBN>
int launch_fused(const Args& a, int grid, int stages) {
  CUtensorMap y3, gy3, wb, y2;
  if (!sm90::encode_tile_map(&y3, a.y3, a.M, a.N, 64) ||
      !sm90::encode_tile_map(&gy3, a.gy3, a.M, a.N, 64) ||
      !sm90::encode_tile_map(&wb, a.wb, a.K, a.N, 64) ||
      !sm90::encode_tile_map(&y2, a.y2, a.M, a.K, 64))
    return kErrTensorMap;
  const int smem = fused_smem(stages);
  auto kernel = fused_bn_bwd_fused<kBN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.M + 63) / 64;
  if (grid < 1 || grid > tiles || a.K > 64 || a.N > kBN) return kErrPlan;
  kernel<<<grid, 2 * kWarpgroup, smem, a.stream>>>(y3, gy3, wb, y2, a.scale, a.shift, a.gs1, a.gs2,
                                                   a.dy2, a.dscale, a.dshift, a.dw, a.M, a.K, a.N,
                                                   tiles, stages);
  return (int)cudaGetLastError();
}

template <int kC, int kBN>
int launch_dw(const Args& a, int grid, int stages) {
  CUtensorMap y2, y3, gy3;
  if (!sm90::encode_tile_map(&y2, a.y2, a.M, a.K, kDwRows) ||
      !sm90::encode_tile_map(&y3, a.y3, a.M, a.N, kDwRows) ||
      !sm90::encode_tile_map(&gy3, a.gy3, a.M, a.N, kDwRows))
    return kErrTensorMap;
  const int smem = dw_smem(64 * kC, kBN, stages);
  auto kernel = fused_bn_bwd_dw<kC, kBN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (a.N + kBN - 1) / kBN;
  const int chunks = (a.M + kDwRows - 1) / kDwRows;
  const int64_t units = (int64_t)((a.K + 64 * kC - 1) / (64 * kC)) * n_tiles * chunks;
  if (grid < 1 || grid > units) return kErrPlan;
  kernel<<<grid, (kC + 1) * kWarpgroup, smem, a.stream>>>(y2, y3, gy3, a.scale, a.shift, a.gs1,
                                                        a.gs2, a.dw, a.M, a.K, a.N, n_tiles,
                                                        chunks, units, stages);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Forward inputs y2 [M, K] bf16, scale/shift [K] f32, w [K, N] f32, the
// forward's y3 [M, N] bf16, the cotangents gy3 [M, N] bf16, gs1/gs2 [N] f32
// -> dy2 [M, K] bf16, dscale/dshift [K] f32, dw [K, N] f32; wb is a
// workspace of K·N bf16 values.  All contiguous and 16-byte aligned, on the
// device of `stream`; K and N multiples of 8, 1 <= M < 2^31.  The launch
// plan (experiments/fused_bn.py:_bwd_plan): the dz pass's rows (64, 128)
// and K width (64, 128, 256) of a tile, its grid and stages; the dW pass's
// channels (64, 128) and N width (64, 128, 256) of a tile, its grid and
// stages.  Launches the prep, dz and dW kernels, or with `fused` (K <= 64,
// N <= dw_width) the prep kernel and the fused pass on the dz pass's grid
// and stages; returns 0, a CUDA error code, or a negative code of this
// launcher (fused_bn_bwd_error_string).
int fused_bn_bwd(const void* y2, const float* scale, const float* shift, const float* w,
                 const void* y3, const void* gy3, const float* gs1, const float* gs2, void* dy2,
                 float* dscale, float* dshift, float* dw, void* wb, long long M, int K, int N,
                 int fused, int dz_rows, int dz_cols, int dz_grid, int dz_stages, int dw_cols,
                 int dw_width, int dw_grid, int dw_stages, void* stream) {
  if (M < 1 || M > INT_MAX || K < 8 || N < 8 || K % 8 || N % 8) return kErrShape;
  const void* ptrs[] = {y2, scale, shift, w, y3, gy3, gs1, gs2, dy2, dscale, dshift, dw, wb};
  for (const void* p : ptrs)
    if (!aligned16(p)) return kErrShape;
  if (dz_stages < 3 || dz_stages > kMaxStages)
    return kErrPlan;
  if (fused ? fused_smem(dz_stages) > kSmemLimit
            : dw_stages < 3 || dw_stages > kMaxStages ||
                  dz_smem(dz_rows, dz_cols, dz_stages) > kSmemLimit ||
                  dw_smem(dw_cols, dw_width, dw_stages) > kSmemLimit)
    return kErrPlan;
  const Args a{static_cast<const bf16*>(y2), static_cast<const bf16*>(y3),
               static_cast<const bf16*>(gy3), scale, shift, w, gs1, gs2,
               static_cast<bf16*>(dy2), static_cast<bf16*>(wb), dscale, dshift, dw,
               (int)M, K, N, static_cast<cudaStream_t>(stream)};

  // bf16(w) into the workspace; dscale, dshift and dW zeroed (the passes add into them)
  int err = launch_prep(w, a.wb, dw, dscale, dshift, K, N, a.stream);
  if (err != 0) return err;

  if (fused) {
    if (dw_width == 64) return launch_fused<64>(a, dz_grid, dz_stages);
    if (dw_width == 128) return launch_fused<128>(a, dz_grid, dz_stages);
    if (dw_width == 256) return launch_fused<256>(a, dz_grid, dz_stages);
    return kErrPlan;
  }
  err = kErrPlan;
  if (dz_rows == 64 && dz_cols == 64) err = launch_dz<1, 64>(a, dz_grid, dz_stages);
  if (dz_rows == 64 && dz_cols == 128) err = launch_dz<1, 128>(a, dz_grid, dz_stages);
  if (dz_rows == 64 && dz_cols == 256) err = launch_dz<1, 256>(a, dz_grid, dz_stages);
  if (dz_rows == 128 && dz_cols == 64) err = launch_dz<2, 64>(a, dz_grid, dz_stages);
  if (dz_rows == 128 && dz_cols == 128) err = launch_dz<2, 128>(a, dz_grid, dz_stages);
  if (dz_rows == 128 && dz_cols == 256) err = launch_dz<2, 256>(a, dz_grid, dz_stages);
  if (err != 0) return err;

  // (64 channels by N <= 128 takes the fused pass)
  err = kErrPlan;
  if (dw_cols == 64 && dw_width == 256) err = launch_dw<1, 256>(a, dw_grid, dw_stages);
  if (dw_cols == 128 && dw_width == 64) err = launch_dw<2, 64>(a, dw_grid, dw_stages);
  if (dw_cols == 128 && dw_width == 128) err = launch_dw<2, 128>(a, dw_grid, dw_stages);
  if (dw_cols == 128 && dw_width == 256) err = launch_dw<2, 256>(a, dw_grid, dw_stages);
  return err;
}

const char* fused_bn_bwd_error_string(int code) {
  switch (code) {
    case kErrPlan: return "launch plan not supported by the kernels (tile widths, grid or stages)";
    case kErrShape: return "shape or alignment not supported (K, N multiples of 8, M < 2^31, 16-byte aligned)";
    case kErrTensorMap: return "cuTensorMapEncodeTiled unavailable or failed";
    default: return cudaGetErrorString((cudaError_t)code);
  }
}

}  // extern "C"
