// Fused pairwise word-region local similarity, backward (pretraining).
//
// Replaces gloria_tpu/ops/pallas/local_sim.py:_bwd_kernel (launched by
// _sims_bwd_impl, wired to the forward by the custom_vjp
// fused_local_similarities).
//
// For every image b and text t the forward (see local_sim_fwd.cu) is
//   raw[s,j] = ctx[b,s] . w[j]            (w[j] = words[t, j-th valid word])
//   a1[s,:]  = softmax_j raw[s,:]          (over the valid words)
//   a2[:,j]  = softmax_s temp1 a1[:,j]     (over the regions)
//   dot[j]   = sum_s a2 raw,  V[j] = sum_s a2[s,j] ctx[b,s],  cn2[j] = |V[j]|^2
//   cos[j]   = dot / max(|w[j]| sqrt(max(cn2, 1e-12)), 1e-8)
//   out[b,t] = log(max(agg_j exp(temp2 cos[j]), 1e-8))
// and this kernel chain-rules g[b,t] = dL/dout[b,t] back to dwords [T,W,D]
// and dregions [B,S,D]:
//   p[j]   = e/max(sum e, 1e-8) (sum, mean) or the argmax split over ties (max)
//   drow   = g temp2 p;  ddot = drow/denom;  ddenom = -drow dot/denom^2
//   dcn2   = ddenom |w| / (2 cn);  dwn = ddenom cn
//   da2    = ddot raw + 2 dcn2 (ctx . V[j])             (G a2 = ctx V^T)
//   da1    = temp1 a2 (da2 - c[j]),  c[j] = sum_s a2 da2 = ddot dot + 2 dcn2 cn2
//   draw   = a1 (da1 - sum_j a1 da1) + ddot a2
//   dregions[b] += draw w + (2 dcn2 a2) V                 (sum over j)
//   dwords[t,j] += draw^T ctx + (dwn/|w|) w               (sum over s)
// c[j] needs no pass of its own: sum_s a2 (G a2) = |V|^2 = cn2.
//
// Design:
//  * Each block walks the (b, t) pairs with a stride of gridDim.x; the
//    wrapper launches BWD_BLOCKS_PER_SM blocks per SM.  A block first
//    compacts its text's valid words, so all work scales with them.
//  * Every product is the same tiled block product (64 x 64 output tiles,
//    16-deep chunks staged in shared memory, 4 x 4 outputs per thread),
//    with operand loads and the epilogue passed in as lambdas.  Six
//    products of 2 S nv D operations each: raw, V, ctx V^T, the two dctx
//    terms (one product of depth 2 nv) and dwords.
//  * The [S, nv] arrays (raw, then a1; e2; a1 da1, then draw) and V [nv, D]
//    live in a per-block scratch slice in device memory that the wrapper
//    allocates: at nv = 96 one [S, nv] f32 array is 139 KB, so two do not
//    fit the 227 KB of shared memory a block may use.  Shared memory holds
//    the staged tiles and the per-region and per-word statistics only
//    (about 22 KB at S = 362, nv = 96).
//  * a1 lies in [0, 1], so the region-softmax logits need no running max:
//    e2 = exp(temp1 a1 - max(temp1, 0)), as in the forward kernel.
//  * dregions[b] sums over texts and dwords[t] over images, and blocks run
//    in no order: both are f32 atomicAdd into outputs the wrapper zeroes,
//    so the summation order changes from run to run.  Pair p maps to
//    b = p % B so the blocks in flight at one time mostly add into
//    different images.
//  * Everything is f32 on the CUDA cores: no tensor cores yet.
// What bounds it on an H100: operations.  This kernel's six products cost
// 12 S D per valid word of each pair.  The TPU kernel's Gram route costs less
// when S < D: raw, G a2 and dG = sum_j dcn2 a2 a2^T per valid word of each
// pair (6 S D + 4 S^2), and per image the Gram G = ctx ctx^T and
// (dG + dG^T) ctx (4 S^2 D).  At the pretrain shape (B = T = 48, S = 361,
// D = 768) the synthetic batch of seed 0 has sum_pairs nv = 48 sum_t nv_t =
// 1.04e5, so the Gram route needs 2.46e11 operations, 3.67 ms at the
// 67 TFLOP/s f32 peak (this kernel's route: 3.45e11).  The bytes (inputs
// once, outputs once) are about 0.15 GB, 0.05 ms at 3.35 TB/s.
// chip_smoke.py computes the bound from each run's own mask, by the cheaper
// route.
// Launches: one per GLoRIA train step (the backward of the local loss).
// No single PyTorch call computes this function, so it has no library
// yardstick.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;  // output rows per tile
constexpr int kBN = 64;  // output columns per tile
constexpr int kBK = 16;  // depth of one staged chunk
constexpr int kLdA = kBM + 1;
constexpr int kLdB = kBN + 1;
constexpr int kStage = kBK * kLdA + kBK * kLdB;
// per-word statistics kept in shared memory, each [ncap]
constexpr int kWordStats = 9;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// C[M, N] = sum_k A(m, k) B(k, n), delivered element by element to
// epi(m, n, value).  Operands come through load_a(m, k) and load_b(k, n),
// which read only in bounds.  kAKFast: consecutive k of A are adjacent in
// memory (else consecutive m); kBNFast: consecutive n of B are adjacent
// (else consecutive k).  Thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of each 64 x 64 tile.  Ends with a barrier.
template <bool kAKFast, bool kBNFast, class LoadA, class LoadB, class Epi>
__device__ __forceinline__ void block_product(int M, int N, int K, LoadA load_a, LoadB load_b,
                                              Epi epi, float* stage) {
  float* as = stage;              // [kBK][kLdA]
  float* bs = stage + kBK * kLdA; // [kBK][kLdB]
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int n0 = 0; n0 < N; n0 += kBN) {
      float acc[4][4] = {};
      for (int k0 = 0; k0 < K; k0 += kBK) {
        for (int i = tid; i < kBM * kBK; i += kThreads) {
          const int mm = kAKFast ? i / kBK : i % kBM;
          const int kk = kAKFast ? i % kBK : i / kBM;
          const int m = m0 + mm, k = k0 + kk;
          as[kk * kLdA + mm] = (m < M && k < K) ? load_a(m, k) : 0.f;
        }
        for (int i = tid; i < kBN * kBK; i += kThreads) {
          const int nn = kBNFast ? i % kBN : i / kBK;
          const int kk = kBNFast ? i / kBN : i % kBK;
          const int n = n0 + nn, k = k0 + kk;
          bs[kk * kLdB + nn] = (n < N && k < K) ? load_b(k, n) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = as[kk * kLdA + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = bs[kk * kLdB + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + tx + 16 * j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// Dynamic shared memory, in order (floats unless noted):
//   stage[kStage]                  staged operand chunks
//   row_m[S], row_iz[S]            per region: max and 1/sum of the word softmax
//   part_z, part_n[kWarps * ncap]  per-warp partial sums of e2 and e2 raw
//   wn, iz2, dot, cn2, ev, ddot, dcn2x2, cc, dwn [ncap]   per-word statistics
//   wl[ncap] (int)                 compacted valid-word indices
// Scratch slice of this block in device memory (floats):
//   raw[S * ncap] (raw, then a1), e2[S * ncap], u[S * ncap] (a1 da1, then
//   draw), each row-major [s][j] with row length nv; vbuf[ncap * D] (V).
__global__ void __launch_bounds__(kThreads)
local_sim_bwd_kernel(const float* __restrict__ words, const float* __restrict__ ctx_all,
                     const float* __restrict__ mask, const float* __restrict__ gsims,
                     float* dwords, float* dregions, float* scratch, size_t scratch_per_block,
                     int B, int T, int S, int W, int D, int ncap,
                     float temp1, float temp2, int agg) {
  extern __shared__ float smem[];
  float* stage = smem;
  float* row_m = stage + kStage;
  float* row_iz = row_m + S;
  float* part_z = row_iz + S;
  float* part_n = part_z + kWarps * ncap;
  float* wn = part_n + kWarps * ncap;
  float* iz2 = wn + ncap;
  float* dot = iz2 + ncap;
  float* cn2 = dot + ncap;
  float* ev = cn2 + ncap;
  float* ddot = ev + ncap;
  float* dcn2x2 = ddot + ncap;
  float* cc = dcn2x2 + ncap;
  float* dwn = cc + ncap;
  int* wl = reinterpret_cast<int*>(dwn + ncap);
  __shared__ int nv_s;

  float* raw = scratch + blockIdx.x * scratch_per_block;
  float* e2 = raw + (size_t)S * ncap;
  float* u = e2 + (size_t)S * ncap;
  float* vbuf = u + (size_t)S * ncap;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float shift = fmaxf(temp1, 0.f);

  for (int pair = blockIdx.x; pair < B * T; pair += gridDim.x) {
    const int b = pair % B;
    const int t = pair / B;
    const float g = gsims[(size_t)b * T + t];
    const float* ctx = ctx_all + (size_t)b * S * D;
    const float* wt = words + (size_t)t * W * D;
    const float* mk = mask + (size_t)t * W;

    // ---- compact the valid words ---------------------------------------
    if (tid == 0) {
      int n = 0;
      for (int w = 0; w < W; ++w)
        if (mk[w] > 0.f && n < ncap) wl[n++] = w;
      nv_s = n;
    }
    __syncthreads();
    const int nv = nv_s;
    if (nv == 0) {  // sims = log(1e-8) whatever the inputs: no gradient
      __syncthreads();
      continue;
    }
    for (int i = tid; i < kWarps * ncap; i += kThreads) {
      part_z[i] = 0.f;
      part_n[i] = 0.f;
    }
    for (int j = warp; j < nv; j += kWarps) {  // word norms, one warp per word
      const float* row = wt + (size_t)wl[j] * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc += row[d] * row[d];
      acc = warp_sum(acc);
      if (lane == 0) wn[j] = sqrtf(fmaxf(acc, 1e-12f));
    }

    // ---- 1. raw[s][j] = ctx[s] . w[j] ------------------------------------
    block_product<true, false>(
        S, nv, D, [&](int s, int d) { return ctx[(size_t)s * D + d]; },
        [&](int d, int j) { return wt[(size_t)wl[j] * D + d]; },
        [&](int s, int j, float v) { raw[(size_t)s * nv + j] = v; }, stage);

    // ---- word softmax per region; e2; column sums Z2 = sum_s e2, N = sum_s e2 raw
    for (int s = warp; s < S; s += kWarps) {
      const float* r = raw + (size_t)s * nv;
      float m = -INFINITY;
      for (int j = lane; j < nv; j += 32) m = fmaxf(m, r[j]);
      m = warp_max(m);
      float z = 0.f;
      for (int j = lane; j < nv; j += 32) z += expf(r[j] - m);
      const float iz = 1.f / warp_sum(z);
      if (lane == 0) {
        row_m[s] = m;
        row_iz[s] = iz;
      }
      for (int j = lane; j < nv; j += 32) {
        const float x = r[j];
        const float e = expf(temp1 * (expf(x - m) * iz) - shift);
        e2[(size_t)s * nv + j] = e;
        part_z[warp * ncap + j] += e;
        part_n[warp * ncap + j] += e * x;
      }
    }
    __syncthreads();
    for (int j = tid; j < nv; j += kThreads) {
      float z = 0.f, n = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        z += part_z[w * ncap + j];
        n += part_n[w * ncap + j];
      }
      iz2[j] = 1.f / z;
      dot[j] = n / z;
    }
    __syncthreads();

    // ---- 2. V[j][d] = sum_s a2[s][j] ctx[s][d] -----------------------------
    block_product<false, true>(
        nv, D, S, [&](int j, int s) { return e2[(size_t)s * nv + j]; },
        [&](int s, int d) { return ctx[(size_t)s * D + d]; },
        [&](int j, int d, float v) { vbuf[(size_t)j * D + d] = v * iz2[j]; }, stage);
    for (int j = warp; j < nv; j += kWarps) {
      const float* row = vbuf + (size_t)j * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32) acc += row[d] * row[d];
      acc = warp_sum(acc);
      if (lane == 0) cn2[j] = acc;
    }
    __syncthreads();

    // ---- per word: forward values, then the chain back to dot, cn2, |w| (warp 0)
    if (warp == 0) {
      float esum = 0.f, emax = 0.f;
      for (int j = lane; j < nv; j += 32) {
        const float den = fmaxf(wn[j] * sqrtf(fmaxf(cn2[j], 1e-12f)), 1e-8f);
        const float e = expf(temp2 * (dot[j] / den));
        ev[j] = e;
        esum += e;
        emax = fmaxf(emax, e);
      }
      esum = warp_sum(esum);
      emax = warp_max(emax);
      float hits = 0.f;
      for (int j = lane; j < nv; j += 32) hits += (ev[j] == emax) ? 1.f : 0.f;
      hits = fmaxf(warp_sum(hits), 1.f);
      for (int j = lane; j < nv; j += 32) {
        const float p = (agg == 1) ? ((ev[j] == emax) ? 1.f / hits : 0.f)
                                   : ev[j] / fmaxf(esum, 1e-8f);
        const float drow = g * temp2 * p;
        const float cn = sqrtf(fmaxf(cn2[j], 1e-12f));
        const float den = fmaxf(wn[j] * cn, 1e-8f);
        const float dd = drow / den;
        const float dden = -drow * dot[j] / (den * den);
        const float dc2 = dden * wn[j] / (2.f * cn);
        ddot[j] = dd;
        dcn2x2[j] = 2.f * dc2;
        cc[j] = dd * dot[j] + 2.f * dc2 * cn2[j];
        dwn[j] = dden * cn / fmaxf(wn[j], 1e-12f);
      }
    }
    __syncthreads();

    // ---- 3. GA[s][j] = ctx[s] . V[j]; epilogue: a1 in place of raw, u = a1 da1
    block_product<true, false>(
        S, nv, D, [&](int s, int d) { return ctx[(size_t)s * D + d]; },
        [&](int d, int j) { return vbuf[(size_t)j * D + d]; },
        [&](int s, int j, float ga) {
          const size_t o = (size_t)s * nv + j;
          const float x = raw[o];
          const float a1 = expf(x - row_m[s]) * row_iz[s];
          const float a2 = e2[o] * iz2[j];
          const float da1 = temp1 * a2 * (ddot[j] * x + dcn2x2[j] * ga - cc[j]);
          raw[o] = a1;
          u[o] = a1 * da1;
        },
        stage);

    // ---- draw = a1 da1 - a1 sum_j a1 da1 + ddot a2, in place of u --------
    for (int s = warp; s < S; s += kWarps) {
      float rs = 0.f;
      for (int j = lane; j < nv; j += 32) rs += u[(size_t)s * nv + j];
      rs = warp_sum(rs);
      for (int j = lane; j < nv; j += 32) {
        const size_t o = (size_t)s * nv + j;
        u[o] = u[o] - raw[o] * rs + ddot[j] * e2[o] * iz2[j];
      }
    }
    __syncthreads();

    // ---- 4. dregions[b][s] += sum_j draw[s][j] w[j] + (2 dcn2 a2)[s][j] V[j]
    block_product<true, true>(
        S, D, 2 * nv,
        [&](int s, int k) {
          const size_t row = (size_t)s * nv;
          return k < nv ? u[row + k] : dcn2x2[k - nv] * e2[row + k - nv] * iz2[k - nv];
        },
        [&](int k, int d) {
          return k < nv ? wt[(size_t)wl[k] * D + d] : vbuf[(size_t)(k - nv) * D + d];
        },
        [&](int s, int d, float v) { atomicAdd(dregions + ((size_t)b * S + s) * D + d, v); },
        stage);

    // ---- 5. dwords[t][w_j] += sum_s draw[s][j] ctx[s] + (dwn / |w|) w[j] -----
    block_product<false, true>(
        nv, D, S, [&](int j, int s) { return u[(size_t)s * nv + j]; },
        [&](int s, int d) { return ctx[(size_t)s * D + d]; },
        [&](int j, int d, float v) {
          const size_t o = (size_t)wl[j] * D + d;
          atomicAdd(dwords + (size_t)t * W * D + o, v + dwn[j] * wt[o]);
        },
        stage);
  }
}

size_t smem_bytes(int S, int ncap) {
  return sizeof(float) * ((size_t)kStage + 2 * (size_t)S + 2 * (size_t)kWarps * ncap +
                          (size_t)kWordStats * ncap) +
         sizeof(int) * (size_t)ncap;
}

}  // namespace

extern "C" {

// Floats of device scratch one block needs; the wrapper allocates
// grid * this many.
size_t local_sim_bwd_scratch_floats(int S, int D, int ncap) {
  return 3 * (size_t)S * ncap + (size_t)ncap * D;
}

// words [T, W, D], ctx [B, S, D], mask [T, W] (float, > 0 = valid), g [B, T];
// dwords [T, W, D] and dregions [B, S, D] zeroed by the caller; scratch of
// grid * local_sim_bwd_scratch_floats(S, D, ncap) floats.  All f32,
// contiguous, on the device of `stream`.  ncap >= 1 and >= the largest count
// of valid words in any mask row.  agg: 0 sum, 1 max, 2 mean.
// Returns cudaGetLastError() after the launch.
int local_sim_bwd(const float* words, const float* ctx, const float* mask, const float* g,
                  float* dwords, float* dregions, float* scratch, int grid,
                  int B, int T, int S, int W, int D, int ncap,
                  float temp1, float temp2, int agg, void* stream) {
  const size_t smem = smem_bytes(S, ncap);
  cudaError_t err = cudaFuncSetAttribute(
      local_sim_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  local_sim_bwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      words, ctx, mask, g, dwords, dregions, scratch, local_sim_bwd_scratch_floats(S, D, ncap),
      B, T, S, W, D, ncap, temp1, temp2, agg);
  return (int)cudaGetLastError();
}

const char* local_sim_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
