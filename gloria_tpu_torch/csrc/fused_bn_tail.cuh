// What the fused bottleneck tail's two kernels share: fused_bn_fwd.cu (K3)
// and fused_bn_bwd.cu (K4).  Both stream 16-byte-aligned boxes with TMA
// into a ring of shared-memory stages (wgmma_tma.cuh), filled by one
// producer thread a block and released by mbarriers, and rewrite staged
// bf16 tiles in place with 16-byte shared-memory accesses; both start with
// fused_bn_prep, which writes bf16(w) once into the caller's workspace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tma.cuh"

namespace fused_tail {

using bf16 = __nv_bfloat16;

constexpr int kWarpgroup = 128;
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr int kBarrierBytes = 2 * kMaxStages * 8;

// registers a thread of the producer warpgroup keeps, and of a consumer
// warpgroup takes, in the kernels with two consumer warpgroups (168 each at
// launch: 384 threads share the SM's 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// y * scale + shift with each step rounded (no fma), as the plain version
// computes it, so that z and the relu mask agree bit for bit
__device__ __forceinline__ float bn_apply(float y, float scale, float shift) {
  return __fadd_rn(__fmul_rn(y, scale), shift);
}

// the eight bf16 values of a 16-byte group as f32 (exact: the bits move up)
__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// eight f32 values from a 32-byte-aligned shared-memory address, two 16-byte loads
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// eight f32 values from a 32-byte-aligned global address, through the read-only cache
__device__ __forceinline__ void load8_global(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// the ring and its barriers start on a 1024-byte boundary (the swizzle's period)
__device__ __forceinline__ unsigned char* align_ring(unsigned char* raw) {
  const uint32_t a = sm90::smem_addr(raw);
  return raw + (((a + sm90::kAtomBytes - 1) & ~uint32_t(sm90::kAtomBytes - 1)) - a);
}

// a consumer warp's release of a stage (empty barriers count one per consumer warp)
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(bar);
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int stages,
                                              int consumer_warps) {
  for (int s = 0; s < stages; ++s) {
    sm90::mbar_init(full + s, 1);
    sm90::mbar_init(empty + s, consumer_warps);
  }
  sm90::mbar_init_fence();
}

// bf16(w) into wb (kn4 groups of four values); where given, dw (as many
// floats as w) and c0, c1 (K floats each) zeroed, for passes that add into them
__global__ void __launch_bounds__(256)
fused_bn_prep(const float* __restrict__ w, bf16* __restrict__ wb, float* __restrict__ dw,
              float* __restrict__ c0, float* __restrict__ c1, int64_t kn4, int K) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < kn4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(w) + i);
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y), __floats2bfloat162_rn(v.z, v.w)};
    reinterpret_cast<uint2*>(wb)[i] = *reinterpret_cast<const uint2*>(h);
    if (dw != nullptr) reinterpret_cast<float4*>(dw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (c0 == nullptr) return;
  for (int64_t i = first; i < K; i += stride) {
    c0[i] = 0.f;
    c1[i] = 0.f;
  }
}

// launches fused_bn_prep on `stream` over K x N values of w (K·N a multiple of 4)
inline int launch_prep(const float* w, bf16* wb, float* dw, float* c0, float* c1, int K, int N,
                       cudaStream_t stream) {
  const int64_t kn4 = (int64_t)K * N / 4;
  const int blocks = (int)((kn4 + 255) / 256 < 1024 ? (kn4 + 255) / 256 : 1024);
  fused_bn_prep<<<blocks, 256, 0, stream>>>(w, wb, dw, c0, c1, kn4, K);
  return (int)cudaGetLastError();
}

}  // namespace fused_tail
