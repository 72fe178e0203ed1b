// Fused pairwise word-region local similarity, forward (serving, zero-shot,
// and the local loss of a train step).
//
// Replaces gloria_tpu/ops/pallas/local_sim.py:_fwd_kernel (launched by
// pallas_local_similarities, math in _forward_tile / _sims_from_tile), and
// takes its Gram route.
//
// For every image b (regions ctx[b] in [S, D], the sink, if any, already
// prepended as region 0) and text t (its valid words):
//   raw[s,w] = ctx[b,s] . words[t,w]
//   a1[s,:]  = softmax over t's valid words of raw[s,:]
//   a2[:,w]  = softmax over the regions of temp1 a1[:,w]
//   dot[w]   = sum_s a2 raw,  cn2[w] = sum_s a2 (G a2),  G = ctx[b] ctx[b]^T
//   cos[w]   = dot / max(|words[t,w]| sqrt(max(cn2, 1e-12)), 1e-8)
//   out[b,t] = log(max(sum_w e | max_w e | sum_w e / n_valid, 1e-8)),  e = exp(temp2 cos)
// with |w| = sqrt(max(sum_d w^2, 1e-12)); a text with no valid word gets
// log(1e-8), as the plain version does for sum, max and mean alike.
//
// The wrapper (ops/local_sim.py) packs the valid words of all texts, text by
// text, into Wc [N, D] (N = sum_t nv_t); text t owns columns
// [text_start[t], text_start[t + 1]), and each text's softmax is a segment
// of a row.  Passes, in launch order (kernel names as the profiler shows
// them); the first six are local_sim_fwd_passes.cuh, shared with K2:
//   k1w_word_norms   |Wc[n]|
//   k1p_gram         G[b] = ctx ctx^T            [S, S], K = D      (product)
//   k1p_raw          raw[b] = ctx Wc^T           [S, N], K = D      (product)
//   k1w_row_softmax  per segment: max, 1/sum; e2 = exp(temp1 a1 - max(temp1, 0))
//   k1w_col_softmax  per column: a2 = e2 / sum_s e2 (in place), dot
//   k1p_ga2          G[b] a2, into raw's buffer  [S, N], K = S      (product)
//   k1w_pair_out     one warp per (image, text): cn2 and e per column, the
//                    aggregation, log(max(., 1e-8)) into out[b, t]
// The three products are one routine, tf32x3_mma.cuh: tensor cores
// (mma.sync m16n8k8 TF32, a 3-stage cp.async ring) at f32 accuracy by the
// 3xTF32 split.  Two [B, S, N] work arrays, not three: once k1w_col_softmax
// has read raw for dot, raw is dead, and G a2 is written into its buffer.
//
// What bounds it on an H100: operations.  This design's products cost
// 2 S D N + 2 S^2 N per image plus the Gram's 2 S^2 D: at the pretrain step
// (B = T = 48, S = 361, D = 768, N = 2160 for the synthetic batch of seed 0)
// 9.41e10 operations, 1.40 ms at the 67 TFLOP/s f32 CUDA-core peak, or, as
// 3xTF32 does them (three TF32 products each), 0.57 ms at the 495 TFLOP/s
// TF32 peak.  At the serving shape (B = 64, T = 25 prompts, S = 362 with the
// sink, N = 185) the same route costs 2.26e10 (the Gram 1.29e10 of it), where
// the direct route (the weighted context V = a2^T ctx, 4 S D per valid word
// of each pair) would cost 1.32e10: 0.196 ms at the f32 peak, 0.080 ms at
// the 3xTF32 rate.  The bytes (inputs read once, the output written once)
// are 8-79 MB, 0.002-0.024 ms at 3.35 TB/s.  The two [B, S, N] work arrays
// (150 MB each at the pretrain shape) are written or read about 11 times
// in all by the passes, about 1.6 GB, 0.5 ms: the floor of this design's
// elementwise work there.  chip_smoke.py computes both bounds from
// each run's own mask, by the cheaper route.
//
// What the design does about the per-pair kernel it replaces (one block of
// 256 threads per (image, text) pair, f32 CUDA cores):
//  * At the serving shape a block's 32-word tile held about 7 valid words,
//    and each image's regions were re-read from L2 by all 25 of its text
//    blocks.  Now the valid words of all texts are one matrix: each product
//    is as wide as all of them (N = 185 serving, 2160 training), and ctx[b]
//    is read once per 128-wide column tile.
//  * Scalar FMA loops over padded shared-memory tiles become tensor-core
//    products at f32 accuracy, fed by cp.async.
//  * One thread compacted each text's valid words serially; now the wrapper
//    packs them once per call on the device (nonzero + index_select), and a
//    train step packs once for its forward and backward.
//  * The wrapper read the largest valid-word count back to the host every
//    call to size shared memory; the one device-to-host read left is N, the
//    size of the packed matrix and of the workspace.
// No atomics: two calls give the same bits.
// Launches: one per InferenceEngine.classify chunk of at most max_batch
// images, one per class in GloriaModel.zero_shot_classification, and one per
// GLoRIA train or eval step (the local loss's similarity matrix).  No single
// PyTorch call computes this function, so it has no library yardstick.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#define LSIM_PREFIX k1
#include "local_sim_fwd_passes.cuh"

namespace {

// One warp per (image, text) pair: cn2 and e = exp(temp2 cos) per column, then
// the aggregation over the text's columns.  The max is taken over the very
// values the sum is; a text with no column writes log(1e-8).
__global__ void __launch_bounds__(kThreads) k1w_pair_out(
    const float* __restrict__ a2, const float* __restrict__ ga2, const float* __restrict__ wn,
    const float* __restrict__ dot, const int* __restrict__ text_start, float* __restrict__ out,
    Shape sh, float temp2, int agg) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (t >= sh.T) return;
  const int c0 = text_start[t], c1 = text_start[t + 1];
  const size_t base = (size_t)b * sh.S * sh.np;
  const size_t col = (size_t)b * sh.N;
  float esum = 0.f, emax = 0.f;
  for (int n = c0 + lane; n < c1; n += 32) {
    const float e = column_exp(wn[n], column_cn2(a2, ga2, base, n, sh), dot[col + n], temp2);
    esum += e;
    emax = fmaxf(emax, e);
  }
  esum = warp_sum(esum);
  emax = warp_max(emax);
  if (lane == 0) {
    const float v = agg == 0 ? esum : agg == 1 ? emax : esum / (float)max(c1 - c0, 1);
    out[(size_t)b * sh.T + t] = logf(fmaxf(v, 1e-8f));
  }
}

// The workspace, carved in this order (each piece a multiple of 4 floats).
size_t carve(float* base, const Shape& sh, FwdBuffers* f) {
  const size_t big = (size_t)sh.B * sh.S * sh.np;
  const size_t sizes[] = {big, big, (size_t)sh.B * sh.S * sh.sp, (size_t)sh.B * sh.S * sh.T,
                          (size_t)sh.B * sh.S * sh.T, (size_t)sh.N, (size_t)sh.B * sh.N};
  float** slots[] = {&f->raw, &f->a2, &f->gram, &f->row_m, &f->row_iz, &f->wn, &f->dot};
  size_t off = 0;
  for (int i = 0; i < 7; ++i) {
    if (base != nullptr) *slots[i] = base + off;
    off += round4(sizes[i]);
  }
  f->ga2 = f->raw;  // raw is dead once k1w_col_softmax has read it
  return off;
}

}  // namespace

extern "C" {

// Floats of workspace one call needs; the wrapper allocates them.
size_t local_sim_fwd_workspace_floats(int B, int T, int S, int N) {
  const Shape sh{B, T, S, 0, 0, N, (int)round4(N), (int)round4(S), 0};
  FwdBuffers sizes_only;
  return carve(nullptr, sh, &sizes_only);
}

// ctx [B, S, dp] (the first D of each row used), wc [N, dp] (the packed valid
// words, text by text), text_start [T + 1] (int); out [B, T] is written in
// full; workspace of local_sim_fwd_workspace_floats(B, T, S, N) floats.  All
// f32 unless noted, contiguous, on the device of `stream`; ctx, wc and the
// workspace 16-byte aligned, dp a multiple of 4.  N = 0 (no valid word in
// any text) launches k1w_pair_out alone.  agg: 0 sum, 1 max, 2 mean.
// Returns the first launch error, or 0.
int local_sim_fwd(const float* ctx, const float* wc, const int* text_start, float* out,
                  float* workspace, int B, int T, int S, int D, int dp, int N, float temp1,
                  float temp2, int agg, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Shape sh{B, T, S, 0, D, N, (int)round4(N), (int)round4(S), dp};
  cudaError_t err;
  FwdBuffers f{};
  if (N > 0) {
    carve(workspace, sh, &f);
    if ((err = launch_fwd_passes(ctx, wc, text_start, f, sh, temp1, stream)) != cudaSuccess)
      return (int)err;
  }
  k1w_pair_out<<<dim3((T + kWarps - 1) / kWarps, B), kThreads, 0, stream>>>(
      f.a2, f.ga2, f.wn, f.dot, text_start, out, sh, temp2, agg);
  return (int)cudaGetLastError();
}

const char* local_sim_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
