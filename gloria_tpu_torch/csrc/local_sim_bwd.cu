// Fused pairwise word-region local similarity, backward (pretraining).
//
// Replaces gloria_tpu/ops/pallas/local_sim.py:_bwd_kernel (launched by
// _sims_bwd_impl, wired to the forward by the custom_vjp
// fused_local_similarities), and takes its Gram route.
//
// The wrapper (ops/local_sim.py) packs the valid words of all texts, text by
// text, into Wc [N, D] (N = sum_t nv_t); text t owns columns
// [text_start[t], text_start[t + 1]).  For every image b, over all columns
// at once (a "segment" is one text's columns in one row):
//   raw[s,n] = ctx[b,s] . Wc[n]
//   a1[s,:]  = softmax over each segment of raw[s,:]      (the word softmax)
//   a2[:,n]  = softmax_s temp1 a1[:,n]                    (the region softmax)
//   dot[n]   = sum_s a2 raw,  cn2[n] = sum_s a2 (G a2),  G = ctx[b] ctx[b]^T
//   cos[n]   = dot / max(|Wc[n]| sqrt(max(cn2, 1e-12)), 1e-8)
//   out[b,t] = log(max(agg over t's columns of exp(temp2 cos), 1e-8))
// and g[b,t] = dL/dout[b,t] goes back to dwords [T,W,D] and dregions [B,S,D]:
//   p[n]   = e/max(sum e, 1e-8) (sum, mean) or the argmax split over ties (max)
//   drow   = g temp2 p;  ddot = drow/den;  dden = -drow dot/den^2
//   dcn2   = dden |w| / (2 cn);  dwn = dden cn
//   da2    = ddot raw + 2 dcn2 (G a2)
//   da1    = temp1 a2 (da2 - c[n]),  c[n] = sum_s a2 da2 = ddot dot + 2 dcn2 cn2
//   draw   = a1 (da1 - sum over the segment of a1 da1) + ddot a2
//   dG     = a2 diag(2 dcn2) a2^T   (symmetric: the Gram's two sides give 2 dG)
//   dregions[b] = draw Wc + dG ctx[b]
//   dwords[t,w] = sum_b (draw[b]^T ctx[b])[n] + (sum_b dwn / |w|) w   (n = t, w's column)
//
// Passes, in launch order (kernel names as the profiler shows them):
//   k2w_word_norms   |Wc[n]|
//   k2p_gram         G[b] = ctx ctx^T            [S, S], K = D      (product)
//   k2p_raw          raw[b] = ctx Wc^T           [S, N], K = D      (product)
//   k2w_row_softmax  per segment: max, 1/sum; e2 = exp(temp1 a1 - max(temp1, 0))
//   k2w_col_softmax  per column: a2 = e2 / sum_s e2 (in place), dot
//   k2p_ga2          G[b] a2                     [S, N], K = S      (product)
//   k2w_pair_stats   per (image, text): cn2, the aggregation, ddot, 2 dcn2, c, dwn
//   k2w_row_draw     per segment: draw (in place of raw), 2 dcn2 a2 (in place of G a2)
//   k2p_dgram        dG[b] = (2 dcn2 a2) a2^T    [S, S], K = N      (product, into G)
//   k2p_dreg_words   dregions[b] = draw Wc       [S, D], K = N      (product)
//   k2p_dreg_gram    dregions[b] += dG ctx       [S, D], K = S      (product)
//   k2p_dwords       part[z] = draw^T ctx over images z*ipb.. [N, D], K = ipb*S (product)
//   k2w_scatter      dwords[t,w] = sum_z part[z][n] + (sum_b dwn[b,n] / |w|) w, 0 elsewhere
// All seven products are one routine, tf32x3_mma.cuh: tensor cores (mma.sync
// m16n8k8 TF32) at f32 accuracy by the 3xTF32 split.
//
// What bounds it on an H100: operations.  The products cost, over the packed
// columns, 2 S D N + 2 S^2 N + 2 S^2 N + 2 S D N + 2 S D N per image plus
// 2 S^2 D + 2 S^2 D per image = B (6 S D N + 4 S^2 N + 4 S^2 D): the TPU
// kernel's Gram route.  At the pretrain shape (B = T = 48, S = 361, D = 768,
// N = 2160 for the synthetic batch of seed 0) that is 2.46e11 operations:
// 3.67 ms at the 67 TFLOP/s f32 CUDA-core peak, or, as 3xTF32 does them
// (three TF32 products each), 1.49 ms at the 495 TFLOP/s TF32 peak
// (165 TFLOP/s of f32-accurate products).  The bytes: inputs read once and
// outputs written once are about 0.15 GB (0.05 ms at 3.35 TB/s).  The three
// [B, S, N] f32 work arrays (150 MB each at that shape) are read or written
// about 20 times in all by the passes below, about 3 GB, 0.9 ms: the floor
// of this design's elementwise work.  chip_smoke.py computes both bounds
// from each run's own mask.
//
// What the design does about the per-pair kernel it replaces:
//  * One block per (image, text) pair, each product about nv = 45 words
//    wide, becomes seven dense products batched over the images, as wide as
//    all texts' valid words together (N = 2160 at the pretrain shape).
//  * f32 on the CUDA cores becomes tensor-core products at f32 accuracy.
//  * The [S, nv] arrays in a per-block scratch slice become three [B, S, N]
//    arrays in a workspace the wrapper allocates once per call, read and
//    written by coalesced elementwise passes.
//  * f32 atomics into dregions and dwords are gone: dregions[b] is the sum
//    of two products written by one block per tile in launch order, and the
//    sum of dwords over the images is the contraction of k2p_dwords (split
//    into a few image ranges, added in order by k2w_scatter).  The result is
//    the same bit for bit from run to run.
// Launches: one call per GLoRIA train step (the backward of the local loss).
// No single PyTorch call computes this function, so it has no library
// yardstick.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "tf32x3_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The shapes every pass reads.  np, sp, dp: leading dimensions (multiples
// of 4) of the [B, S, N] work arrays, the Gram [B, S, S] and ctx / Wc.
struct Shape {
  int B, T, S, W, D, N, np, sp, dp;
};

// ---- products: one named kernel per pass, all the same routine ----------
#define K2_PRODUCT(name, a_k, b_k)                                                         \
  __global__ void __launch_bounds__(tf32x3::kThreads, 2) name(tf32x3::Args p) {            \
    tf32x3::product<a_k, b_k>(p);                                                           \
  }
K2_PRODUCT(k2p_gram, true, true)        // ctx [S][D] . ctx [S][D]^T
K2_PRODUCT(k2p_raw, true, true)         // ctx [S][D] . Wc [N][D]^T
K2_PRODUCT(k2p_ga2, true, false)        // G [S][S] . a2 [S][N]
K2_PRODUCT(k2p_dgram, true, true)       // wa2 [S][N] . a2 [S][N]^T
K2_PRODUCT(k2p_dreg_words, true, false) // draw [S][N] . Wc [N][D]
K2_PRODUCT(k2p_dreg_gram, true, false)  // dG [S][S] . ctx [S][D]
K2_PRODUCT(k2p_dwords, false, false)    // draw [BS][N]^T . ctx [BS][D]
#undef K2_PRODUCT

// ---- elementwise and reduction passes --------------------------------------

// wn[n] = sqrt(max(|Wc[n]|^2, 1e-12)), one warp per column.
__global__ void __launch_bounds__(kThreads) k2w_word_norms(const float* __restrict__ wc,
                                                           float* __restrict__ wn, Shape sh) {
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= sh.N) return;
  const float* row = wc + (size_t)n * sh.dp;
  float acc = 0.f;
  for (int d = lane; d < sh.D; d += 32) acc += row[d] * row[d];
  acc = warp_sum(acc);
  if (lane == 0) wn[n] = sqrtf(fmaxf(acc, 1e-12f));
}

// One block per row (b, s); warp w takes segments w, w + 8, ...  Writes the
// segment's max and 1/sum of the word softmax and e2 = exp(temp1 a1 - shift).
__global__ void __launch_bounds__(kThreads) k2w_row_softmax(
    const float* __restrict__ raw, float* __restrict__ e2, float* __restrict__ row_m,
    float* __restrict__ row_iz, const int* __restrict__ text_start, Shape sh, float temp1) {
  const int row = blockIdx.x;  // b * S + s
  const int lane = threadIdx.x & 31;
  const float shift = fmaxf(temp1, 0.f);
  const float* r = raw + (size_t)row * sh.np;
  float* e = e2 + (size_t)row * sh.np;
  for (int t = threadIdx.x >> 5; t < sh.T; t += kWarps) {
    const int c0 = text_start[t], c1 = text_start[t + 1];
    if (c0 == c1) continue;
    float m = -INFINITY;
    for (int n = c0 + lane; n < c1; n += 32) m = fmaxf(m, r[n]);
    m = warp_max(m);
    float z = 0.f;
    for (int n = c0 + lane; n < c1; n += 32) z += expf(r[n] - m);
    const float iz = 1.f / warp_sum(z);
    if (lane == 0) {
      row_m[(size_t)row * sh.T + t] = m;
      row_iz[(size_t)row * sh.T + t] = iz;
    }
    for (int n = c0 + lane; n < c1; n += 32) e[n] = expf(temp1 * (expf(r[n] - m) * iz) - shift);
  }
}

// One thread per column (b, n): a2 = e2 / sum_s e2 in place; dot = sum_s a2 raw.
__global__ void __launch_bounds__(kThreads) k2w_col_softmax(const float* __restrict__ raw,
                                                            float* __restrict__ a2,
                                                            float* __restrict__ dot, Shape sh) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= sh.N) return;
  const size_t base = (size_t)b * sh.S * sh.np + n;
  float z = 0.f;
  for (int s = 0; s < sh.S; ++s) z += a2[base + (size_t)s * sh.np];
  const float iz = 1.f / z;
  float acc = 0.f;
  for (int s = 0; s < sh.S; ++s) {
    const size_t o = base + (size_t)s * sh.np;
    const float v = a2[o] * iz;
    a2[o] = v;
    acc += v * raw[o];
  }
  dot[(size_t)b * sh.N + n] = acc;
}

// Per-column statistics of one image, each [B, N].
struct ColStats {
  float* dot;
  float* cn2;
  float* ddot;
  float* dcn2x2;
  float* cc;
  float* dwn;
};

// One warp per (image, text) pair: cn2 = sum_s a2 (G a2) per column, then
// the aggregation over the text's columns and the chain back to dot, cn2
// and |w|.
__global__ void __launch_bounds__(kThreads) k2w_pair_stats(
    const float* __restrict__ a2, const float* __restrict__ ga2, const float* __restrict__ wn,
    const float* __restrict__ gsims, const int* __restrict__ text_start, ColStats st, Shape sh,
    float temp2, int agg) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  if (t >= sh.T) return;
  const int c0 = text_start[t], c1 = text_start[t + 1];
  if (c0 == c1) return;  // sims = log(1e-8) whatever the inputs: no gradient
  const size_t base = (size_t)b * sh.S * sh.np;
  const size_t col = (size_t)b * sh.N;
  for (int n = c0 + lane; n < c1; n += 32) {
    float acc = 0.f;
    for (int s = 0; s < sh.S; ++s) {
      const size_t o = base + (size_t)s * sh.np + n;
      acc += a2[o] * ga2[o];
    }
    st.cn2[col + n] = acc;
  }
  __syncwarp();
  // e = exp(temp2 cos) waits in ddot until the last loop, so the max's ties
  // compare the very values the sum and the max were taken over
  float esum = 0.f, emax = 0.f;
  for (int n = c0 + lane; n < c1; n += 32) {
    const float den = fmaxf(wn[n] * sqrtf(fmaxf(st.cn2[col + n], 1e-12f)), 1e-8f);
    const float e = expf(temp2 * (st.dot[col + n] / den));
    st.ddot[col + n] = e;
    esum += e;
    emax = fmaxf(emax, e);
  }
  esum = warp_sum(esum);
  emax = warp_max(emax);
  float hits = 0.f;
  for (int n = c0 + lane; n < c1; n += 32) hits += (st.ddot[col + n] == emax) ? 1.f : 0.f;
  hits = fmaxf(warp_sum(hits), 1.f);
  const float g = gsims[(size_t)b * sh.T + t];
  for (int n = c0 + lane; n < c1; n += 32) {
    const float cn2 = st.cn2[col + n], dotv = st.dot[col + n], w = wn[n];
    const float cn = sqrtf(fmaxf(cn2, 1e-12f));
    const float den = fmaxf(w * cn, 1e-8f);
    const float e = st.ddot[col + n];
    const float p = (agg == 1) ? ((e == emax) ? 1.f / hits : 0.f) : e / fmaxf(esum, 1e-8f);
    const float drow = g * temp2 * p;
    const float dd = drow / den;
    const float dden = -drow * dotv / (den * den);
    const float dc2 = dden * w / (2.f * cn);
    st.ddot[col + n] = dd;
    st.dcn2x2[col + n] = 2.f * dc2;
    st.cc[col + n] = dd * dotv + 2.f * dc2 * cn2;
    st.dwn[col + n] = dden * cn;
  }
}

// One block per row (b, s), warps over segments: draw in place of raw, and
// wa2 = 2 dcn2 a2 in place of G a2.
__global__ void __launch_bounds__(kThreads) k2w_row_draw(
    float* __restrict__ raw_draw, const float* __restrict__ a2, float* __restrict__ ga2_wa2,
    const float* __restrict__ row_m, const float* __restrict__ row_iz,
    const int* __restrict__ text_start, ColStats st, Shape sh, float temp1) {
  const int row = blockIdx.x;  // b * S + s
  const int b = row / sh.S;
  const int lane = threadIdx.x & 31;
  const size_t o0 = (size_t)row * sh.np;
  const size_t col = (size_t)b * sh.N;
  for (int t = threadIdx.x >> 5; t < sh.T; t += kWarps) {
    const int c0 = text_start[t], c1 = text_start[t + 1];
    if (c0 == c1) continue;
    const float m = row_m[(size_t)row * sh.T + t];
    const float iz = row_iz[(size_t)row * sh.T + t];
    float rs = 0.f;  // sum over the segment of a1 da1
    for (int n = c0 + lane; n < c1; n += 32) {
      const float x = raw_draw[o0 + n], v = a2[o0 + n];
      const float a1 = expf(x - m) * iz;
      rs += a1 * temp1 * v * (st.ddot[col + n] * x + st.dcn2x2[col + n] * ga2_wa2[o0 + n]
                              - st.cc[col + n]);
    }
    rs = warp_sum(rs);
    for (int n = c0 + lane; n < c1; n += 32) {
      const float x = raw_draw[o0 + n], v = a2[o0 + n];
      const float a1 = expf(x - m) * iz;
      const float dd = st.ddot[col + n], d2 = st.dcn2x2[col + n];
      const float u = a1 * temp1 * v * (dd * x + d2 * ga2_wa2[o0 + n] - st.cc[col + n]);
      raw_draw[o0 + n] = u - a1 * rs + dd * v;
      ga2_wa2[o0 + n] = d2 * v;
    }
  }
}

// One block per word slot (t, w): the column's parts summed in order plus
// the norm term, or 0 for a padded slot.
__global__ void __launch_bounds__(kThreads) k2w_scatter(
    const float* __restrict__ part, const float* __restrict__ dwn, const float* __restrict__ wn,
    const float* __restrict__ words, const int* __restrict__ col_of, float* __restrict__ dwords,
    Shape sh, int splits) {
  const int slot = blockIdx.x;  // t * W + w
  const int n = col_of[slot];
  float* out = dwords + (size_t)slot * sh.D;
  if (n < 0) {
    for (int d = threadIdx.x; d < sh.D; d += kThreads) out[d] = 0.f;
    return;
  }
  __shared__ float scale;
  if (threadIdx.x < 32) {
    float acc = 0.f;
    for (int b = threadIdx.x; b < sh.B; b += 32) acc += dwn[(size_t)b * sh.N + n];
    acc = warp_sum(acc);
    if (threadIdx.x == 0) scale = acc / fmaxf(wn[n], 1e-12f);
  }
  __syncthreads();
  const float* w = words + (size_t)slot * sh.D;
  for (int d = threadIdx.x; d < sh.D; d += kThreads) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[((size_t)z * sh.N + n) * sh.D + d];
    out[d] = acc + scale * w[d];
  }
}

__global__ void __launch_bounds__(kThreads) k2w_zero(float* __restrict__ x, size_t count) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < count;
       i += (size_t)gridDim.x * kThreads)
    x[i] = 0.f;
}

size_t round4(size_t x) { return (x + 3) / 4 * 4; }

// The workspace, carved in this order (each piece a multiple of 4 floats).
struct Workspace {
  float *x0, *x1, *x2, *gram, *part, *row_m, *row_iz, *wn;
  ColStats st;
};

size_t carve(float* base, const Shape& sh, int splits, Workspace* ws) {
  const size_t big = (size_t)sh.B * sh.S * sh.np;
  const size_t sizes[] = {big, big, big, (size_t)sh.B * sh.S * sh.sp,
                          (size_t)splits * sh.N * sh.D, (size_t)sh.B * sh.S * sh.T,
                          (size_t)sh.B * sh.S * sh.T, (size_t)sh.N,
                          (size_t)sh.B * sh.N, (size_t)sh.B * sh.N, (size_t)sh.B * sh.N,
                          (size_t)sh.B * sh.N, (size_t)sh.B * sh.N, (size_t)sh.B * sh.N};
  float** slots[] = {&ws->x0, &ws->x1, &ws->x2, &ws->gram, &ws->part, &ws->row_m, &ws->row_iz,
                     &ws->wn, &ws->st.dot, &ws->st.cn2, &ws->st.ddot, &ws->st.dcn2x2,
                     &ws->st.cc, &ws->st.dwn};
  size_t off = 0;
  for (int i = 0; i < 14; ++i) {
    if (base != nullptr) *slots[i] = base + off;
    off += round4(sizes[i]);
  }
  return off;
}

template <class Kernel>
cudaError_t launch_product(Kernel kernel, const tf32x3::Args& p, int batch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         tf32x3::kSmemBytes);
  if (err != cudaSuccess) return err;
  // all of the SM's 228 KB to shared memory, so two blocks fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<tf32x3::grid_of(p, batch), tf32x3::kThreads, tf32x3::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

tf32x3::Args args(const float* a, int lda, long long sa, const float* b, int ldb, long long sb,
                  float* c, int ldc, long long sc, int m, int n, int k, float alpha = 1.f,
                  int accumulate = 0) {
  return tf32x3::Args{a, b, c, m, n, k, k, lda, ldb, ldc, sa, sb, sc, alpha, accumulate};
}

}  // namespace

extern "C" {

// Floats of workspace one call needs; the wrapper allocates them.
size_t local_sim_bwd_workspace_floats(int B, int T, int S, int D, int N, int splits) {
  const Shape sh{B, T, S, 0, D, N, (int)round4(N), (int)round4(S), 0};
  Workspace sizes_only;
  return carve(nullptr, sh, splits, &sizes_only);
}

// ctx [B, S, dp] (the first D of each row used), wc [N, dp] (the packed valid
// words, text by text), words [T, W, D], text_start [T + 1] (int), col_of
// [T * W] (int, the column of each word slot or -1), g [B, T]; dwords
// [T, W, D] and dregions [B, S, D] are written in full; workspace of
// local_sim_bwd_workspace_floats(B, T, S, D, N, splits) floats.  All f32
// unless noted, contiguous, on the device of `stream`; ctx, wc and the
// workspace 16-byte aligned, dp a multiple of 4.  k2p_dwords splits the
// images into `splits` ranges of `ipb` images (the last one shorter).
// agg: 0 sum, 1 max, 2 mean.  Returns the first launch error, or 0.
int local_sim_bwd(const float* ctx, const float* wc, const float* words, const int* text_start,
                  const int* col_of, const float* g, float* dwords, float* dregions,
                  float* workspace, int B, int T, int S, int W, int D, int dp, int N, int splits,
                  int ipb, float temp1, float temp2, int agg, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Shape sh{B, T, S, W, D, N, (int)round4(N), (int)round4(S), dp};
  cudaError_t err;
  if (N == 0) {  // every caption empty: the similarities are constant
    const size_t counts[] = {(size_t)T * W * D, (size_t)B * S * D};
    float* outs[] = {dwords, dregions};
    for (int i = 0; i < 2; ++i) {
      const int blocks = (int)((counts[i] + kThreads - 1) / kThreads < 4096
                                   ? (counts[i] + kThreads - 1) / kThreads : 4096);
      if (blocks == 0) continue;
      k2w_zero<<<blocks, kThreads, 0, stream>>>(outs[i], counts[i]);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return 0;
  }
  Workspace ws;
  carve(workspace, sh, splits, &ws);
  const long long s_ctx = (long long)S * dp, s_x = (long long)S * sh.np,
                  s_g = (long long)S * sh.sp;

  k2w_word_norms<<<(N + kWarps - 1) / kWarps, kThreads, 0, stream>>>(wc, ws.wn, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_product(k2p_gram, args(ctx, dp, s_ctx, ctx, dp, s_ctx, ws.gram, sh.sp, s_g,
                                           S, S, D), B, stream)) != cudaSuccess)
    return (int)err;
  if ((err = launch_product(k2p_raw, args(ctx, dp, s_ctx, wc, dp, 0, ws.x0, sh.np, s_x, S, N, D),
                            B, stream)) != cudaSuccess)
    return (int)err;
  k2w_row_softmax<<<B * S, kThreads, 0, stream>>>(ws.x0, ws.x1, ws.row_m, ws.row_iz, text_start,
                                                  sh, temp1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k2w_col_softmax<<<dim3((N + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      ws.x0, ws.x1, ws.st.dot, sh);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_product(k2p_ga2, args(ws.gram, sh.sp, s_g, ws.x1, sh.np, s_x, ws.x2, sh.np,
                                          s_x, S, N, S), B, stream)) != cudaSuccess)
    return (int)err;
  k2w_pair_stats<<<dim3((T + kWarps - 1) / kWarps, B), kThreads, 0, stream>>>(
      ws.x1, ws.x2, ws.wn, g, text_start, ws.st, sh, temp2, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k2w_row_draw<<<B * S, kThreads, 0, stream>>>(ws.x0, ws.x1, ws.x2, ws.row_m, ws.row_iz,
                                               text_start, ws.st, sh, temp1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = launch_product(k2p_dgram, args(ws.x2, sh.np, s_x, ws.x1, sh.np, s_x, ws.gram, sh.sp,
                                            s_g, S, S, N), B, stream)) != cudaSuccess)
    return (int)err;
  if ((err = launch_product(k2p_dreg_words, args(ws.x0, sh.np, s_x, wc, dp, 0, dregions, D,
                                                 (long long)S * D, S, D, N), B, stream))
      != cudaSuccess)
    return (int)err;
  if ((err = launch_product(k2p_dreg_gram, args(ws.gram, sh.sp, s_g, ctx, dp, s_ctx, dregions, D,
                                                (long long)S * D, S, D, S, 1.f, 1), B, stream))
      != cudaSuccess)
    return (int)err;
  tf32x3::Args pw = args(ws.x0, sh.np, (long long)ipb * s_x, ctx, dp, (long long)ipb * s_ctx,
                         ws.part, D, (long long)N * D, N, D, ipb * S);
  pw.k_last = (B - (splits - 1) * ipb) * S;
  if ((err = launch_product(k2p_dwords, pw, splits, stream)) != cudaSuccess) return (int)err;
  k2w_scatter<<<T * W, kThreads, 0, stream>>>(ws.part, ws.st.dwn, ws.wn, words, col_of, dwords,
                                              sh, splits);
  return (int)cudaGetLastError();
}

const char* local_sim_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
