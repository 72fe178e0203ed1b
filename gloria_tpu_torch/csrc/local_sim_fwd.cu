// Fused pairwise word-region local similarity, forward (eval and zero-shot).
//
// Replaces gloria_tpu/ops/pallas/local_sim.py:_fwd_kernel (launched by
// pallas_local_similarities, math in _forward_tile / _sims_from_tile).
//
// For every image b and text t (regions ctx[b] in [S, D] with the sink, if
// any, already prepended as region 0; words[t] in [W, D]; mask[t] in [W]):
//   raw[s,w] = ctx[b,s] . words[t,w]
//   a1[s,:]  = softmax over the valid words of raw[s,:]   (0 at masked words)
//   a2[:,w]  = softmax over the regions of temp1 * a1[:,w]
//   dot[w]   = sum_s a2[s,w] raw[s,w]
//   cn2[w]   = |sum_s a2[s,w] ctx[b,s]|^2
//   cos[w]   = dot[w] / max(|words[t,w]| sqrt(max(cn2[w], 1e-12)), 1e-8)
//   e[w]     = exp(temp2 cos[w]) on valid words, 0 elsewhere
//   out[b,t] = log(max(sum_w e | max_w e | sum_w e / n_valid, 1e-8))
// with |words[t,w]| = sqrt(max(sum_d words^2, 1e-12)).
//
// Design (one block of 256 threads per (b, t) pair, B*T blocks):
//  * Masked words never touch the result, so each block first compacts the
//    valid words of its text into a list and does all work on those alone.
//    Zero-shot prompts fill about a tenth of the 97-word axis.
//  * raw is one [S x nv] product (nv = valid words) tiled 64 x 32 through
//    shared memory, kept whole in dynamic shared memory as f32.  The host
//    sizes that buffer by the largest nv over the texts.
//  * a1 lies in [0, 1], so the region-softmax logits temp1*a1 are bounded:
//    e2 = exp(temp1*a1 - max(temp1, 0)) lies in [exp(-|temp1|), 1] and needs
//    no running max (the wrapper rejects |temp1| > 80, where it could
//    underflow).  One pass over the rows turns raw into e2 in place and
//    accumulates Z[w] = sum_s e2 and N[w] = sum_s e2 raw, so dot = N / Z.
//  * cn2 = |sum_s e2[s,w] ctx[b,s]|^2 / Z^2: a second [nv x S] x [S x D]
//    product, tiled 32 x 64, whose squares are summed on the fly.  This
//    costs 2 S nv D operations per pair, against 2 S^2 D / T + 2 S^2 nv for
//    the TPU kernel's Gram-matrix route; fewer at zero-shot shapes.
//  * Everything is f32 on the CUDA cores: no tensor cores yet.
// What bounds it on an H100: operations.  At the serving shape (B=64,
// T=25, S=362, D=768, W=97) the TPU kernel's route over the whole word axis
// costs 2BTSWD (raw, 86.3 GFLOP) + 2BS^2D (Gram, 12.9) + 2BTS^2W (G a2,
// 40.7) = 140 GFLOP, 2.1 ms at the 67 TFLOP/s f32 peak.  Over the valid
// words only, this kernel's two products cost 2 * 2 * B * S * D * sum_t nv_t:
// the CheXpert prompts hold sum_t nv_t = 185, so 13.2 GFLOP, 0.20 ms.  The
// f32 inputs are 79 MB, 0.02 ms at 3.35 TB/s.  With many valid words the
// Gram route is the cheaper one (2 S D + 2 S^2 per valid word of each pair,
// plus 2 S^2 D per image): at the pretrain shape (B = T = 48, S = 361, 2160
// valid words) 9.41e10 operations, 1.40 ms, against 1.15e11 for this
// kernel's route.  chip_smoke.py computes the bound from each run's own
// mask, by the cheaper route.
// Launches: one per InferenceEngine.classify chunk of at most max_batch
// images, one per class in GloriaModel.zero_shot_classification, and one per
// GLoRIA train or eval step (the local loss's similarity matrix).  No single
// PyTorch call computes this function, so it has no library yardstick.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileS = 64;   // product 1: regions per tile
constexpr int kTileW = 32;   // product 1: words per tile; product 2: words per tile
constexpr int kTileK = 32;   // depth of one staged chunk
constexpr int kTileD = 64;   // product 2: features per tile
constexpr int kPad = kTileK + 1;
// the staging area holds product 1's two chunks or product 2's ctx chunk
constexpr int kStage = kTileS * kPad + kTileW * kPad;
static_assert(kTileK * kTileD <= kStage, "product 2 chunk must fit the staging area");

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dynamic shared memory, in order (floats unless noted):
//   e[S * nw_cap]            raw, then e2, row-major [s][j]
//   stage[kStage]            staged operand chunks
//   part_z, part_n[kWarps * nw_cap]   per-warp partial Z, N
//   z, n, cn2, wn[nw_cap]
//   wl[nw_cap] (int)         compacted valid-word indices
__global__ void __launch_bounds__(kThreads)
local_sim_fwd_kernel(const float* __restrict__ words, const float* __restrict__ ctx_all,
                     const float* __restrict__ mask, float* __restrict__ out,
                     int T, int S, int W, int D, int nw_cap,
                     float temp1, float temp2, int agg) {
  extern __shared__ float smem[];
  const int pair = blockIdx.x;
  const int b = pair / T;
  const int t = pair - b * T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float* e = smem;
  float* stage = e + (size_t)S * nw_cap;
  float* part_z = stage + kStage;
  float* part_n = part_z + kWarps * nw_cap;
  float* zs = part_n + kWarps * nw_cap;
  float* ns = zs + nw_cap;
  float* cn2 = ns + nw_cap;
  float* wn = cn2 + nw_cap;
  int* wl = reinterpret_cast<int*>(wn + nw_cap);
  __shared__ int nv_s;

  const float* ctx = ctx_all + (size_t)b * S * D;
  const float* wt = words + (size_t)t * W * D;
  const float* mk = mask + (size_t)t * W;

  // ---- compact the valid words -----------------------------------------
  if (tid == 0) {
    int n = 0;
    for (int w = 0; w < W; ++w)
      if (mk[w] > 0.f && n < nw_cap) wl[n++] = w;
    nv_s = n;
  }
  __syncthreads();
  const int nv = nv_s;
  for (int i = tid; i < kWarps * nw_cap; i += kThreads) {
    part_z[i] = 0.f;
    part_n[i] = 0.f;
  }
  for (int j = tid; j < nw_cap; j += kThreads) cn2[j] = 0.f;

  // ---- word norms: one warp per valid word -------------------------------
  for (int j = warp; j < nv; j += kWarps) {
    const float* row = wt + (size_t)wl[j] * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += row[d] * row[d];
    acc = warp_sum(acc);
    if (lane == 0) wn[j] = sqrtf(fmaxf(acc, 1e-12f));
  }

  // ---- product 1: e[s][j] = ctx[s] . words[wl[j]] ------------------------
  float* as = stage;                 // [kTileS][kPad]
  float* bs = stage + kTileS * kPad; // [kTileW][kPad]
  for (int s0 = 0; s0 < S; s0 += kTileS) {
    for (int j0 = 0; j0 < nv; j0 += kTileW) {
      float acc[4][2] = {};
      for (int d0 = 0; d0 < D; d0 += kTileK) {
        for (int i = tid; i < kTileS * kTileK; i += kThreads) {
          const int r = i / kTileK, k = i - r * kTileK;
          const int s = s0 + r, d = d0 + k;
          as[r * kPad + k] = (s < S && d < D) ? ctx[(size_t)s * D + d] : 0.f;
        }
        for (int i = tid; i < kTileW * kTileK; i += kThreads) {
          const int r = i / kTileK, k = i - r * kTileK;
          const int j = j0 + r, d = d0 + k;
          bs[r * kPad + k] = (j < nv && d < D) ? wt[(size_t)wl[j] * D + d] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kTileK; ++k) {
          float a[4], bv[2];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) a[ii] = as[(ty + 16 * ii) * kPad + k];
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) bv[jj] = bs[(tx + 16 * jj) * kPad + k];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) acc[ii][jj] = fmaf(a[ii], bv[jj], acc[ii][jj]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int s = s0 + ty + 16 * ii;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + tx + 16 * jj;
          if (s < S && j < nv) e[(size_t)s * nv + j] = acc[ii][jj];
        }
      }
    }
  }
  __syncthreads();

  // ---- word softmax per region, then e2 in place; partial Z and N --------
  const float shift = fmaxf(temp1, 0.f);
  for (int s = warp; s < S; s += kWarps) {
    float* row = e + (size_t)s * nv;
    float m = -INFINITY;
    for (int j = lane; j < nv; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < nv; j += 32) sum += expf(row[j] - m);
    sum = warp_sum(sum);
    for (int j = lane; j < nv; j += 32) {
      const float r = row[j];
      const float a1 = expf(r - m) / sum;
      const float e2 = expf(temp1 * a1 - shift);
      row[j] = e2;
      part_z[warp * nw_cap + j] += e2;
      part_n[warp * nw_cap + j] += e2 * r;
    }
  }
  __syncthreads();
  for (int j = tid; j < nv; j += kThreads) {
    float z = 0.f, n = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      z += part_z[w * nw_cap + j];
      n += part_n[w * nw_cap + j];
    }
    zs[j] = z;
    ns[j] = n;
  }

  // ---- product 2: cn2[j] += |sum_s e[s][j] ctx[s]|^2 ---------------------
  float* cs = stage;  // [kTileK][kTileD]
  for (int j0 = 0; j0 < nv; j0 += kTileW) {
    int jr[2];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) jr[ii] = min(j0 + ty + 16 * ii, nv - 1);
    for (int d0 = 0; d0 < D; d0 += kTileD) {
      float acc[2][4] = {};
      for (int s0 = 0; s0 < S; s0 += kTileK) {
        for (int i = tid; i < kTileK * kTileD; i += kThreads) {
          const int k = i / kTileD, c = i - k * kTileD;
          const int s = s0 + k, d = d0 + c;
          cs[i] = (s < S && d < D) ? ctx[(size_t)s * D + d] : 0.f;
        }
        __syncthreads();
        const int kmax = min(kTileK, S - s0);
        for (int k = 0; k < kmax; ++k) {
          const float* erow = e + (size_t)(s0 + k) * nv;
          float a[2], bv[4];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) a[ii] = erow[jr[ii]];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = cs[k * kTileD + tx + 16 * jj];
#pragma unroll
          for (int ii = 0; ii < 2; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], bv[jj], acc[ii][jj]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        float sq = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sq += acc[ii][jj] * acc[ii][jj];
        // the 16 threads of one ty hold one word's 64 features: reduce them
        for (int o = 8; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
        const int j = j0 + ty + 16 * ii;
        if (tx == 0 && j < nv) cn2[j] += sq;
      }
    }
  }
  __syncthreads();

  // ---- cosine, exp and aggregation over the valid words (warp 0) ---------
  if (warp == 0) {
    float esum = 0.f, emax = 0.f;
    for (int j = lane; j < nv; j += 32) {
      const float z = zs[j];
      const float dot = ns[j] / z;
      const float c2 = fmaxf(cn2[j] / (z * z), 1e-12f);
      const float denom = fmaxf(wn[j] * sqrtf(c2), 1e-8f);
      const float ev = expf(temp2 * (dot / denom));
      esum += ev;
      emax = fmaxf(emax, ev);
    }
    esum = warp_sum(esum);
    emax = warp_max(emax);
    if (lane == 0) {
      float v;
      if (agg == 0) v = esum;
      else if (agg == 1) v = emax;
      else v = esum / (float)max(nv, 1);
      out[(size_t)b * T + t] = logf(fmaxf(v, 1e-8f));
    }
  }
}

size_t smem_bytes(int S, int nw_cap) {
  return sizeof(float) * ((size_t)S * nw_cap + kStage + 2 * kWarps * nw_cap + 4 * nw_cap)
         + sizeof(int) * (size_t)nw_cap;
}

}  // namespace

extern "C" {

// words [T, W, D], ctx [B, S, D], mask [T, W] (float, > 0 = valid), out [B, T];
// all f32, contiguous, on the device of `stream`.  nw_cap >= the largest
// count of valid words in any mask row.  agg: 0 sum, 1 max, 2 mean.
// Returns cudaGetLastError() after the launch.
int local_sim_fwd(const float* words, const float* ctx, const float* mask, float* out,
                  int B, int T, int S, int W, int D, int nw_cap,
                  float temp1, float temp2, int agg, void* stream) {
  const int cap = nw_cap > 0 ? nw_cap : 1;
  const size_t smem = smem_bytes(S, cap);
  cudaError_t err = cudaFuncSetAttribute(
      local_sim_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  local_sim_fwd_kernel<<<(unsigned)B * (unsigned)T, kThreads, smem, (cudaStream_t)stream>>>(
      words, ctx, mask, out, T, S, W, D, cap, temp1, temp2, agg);
  return (int)cudaGetLastError();
}

const char* local_sim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
