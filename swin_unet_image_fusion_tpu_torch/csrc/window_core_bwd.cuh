// Backward device code shared by the window-attention kernel (K3 bwd, window_attention.cu)
// and the fused Swin block (K1/K4 bwd, fused_block.cu), for Hopper (sm_90a). The
// arithmetic is fp32; the block's input x and the output gradient g may be fp32 or bf16
// (a bf16 element is upcast as it is loaded, as the JAX backward bodies upcast theirs) and
// the input gradient is written in x's type, rounded once on the store:
//
//   wgrad_kernel            weight gradients W = A^T @ B over all M token rows, with a row
//                           of ones appended to A so that the last output row is B's
//                           column sum (the bias gradient). M is split into chunks, each
//                           block writes the partial of one output tile over one chunk;
//   ln_fwd_kernel           LayerNorm of token rows, keeping each row's mean and 1/std;
//   ln_bwd_kernel           its backward, g_a = rstd (g_xhat - mean(g_xhat)
//                           - xhat mean(g_xhat xhat)) with g_xhat = g * gamma, plus a
//                           residual gradient, and per-block partial column sums of
//                           g * xhat and g (the gamma and beta gradients); under kSplit a
//                           second gradient g2 of the same LayerNorm (the k/v side under
//                           cross) gets its own g_a, rounded apart: out = rnd(rnd(res + g_a)
//                           + rnd(g2_a)), the sum of the JAX kernels' gx and gkv outputs;
//   window_core_bwd_kernel  the backward of window_core_kernel, one block per (group of
//                           windows, stream*batch, head): recomputes P, then
//                           g_v = P^T g_o, g_P = g_o v^T, g_S = P (g_P - rowsum(g_P P)),
//                           g_q = scale g_S k, g_k = g_S^T q_scaled, and sums g_S over its
//                           windows into a (T, T) partial of the relative-position bias grad;
//                           under kDrop with the forward's attention mask: g_P' = mask(g_P),
//                           g_S = P (g_P' - rowsum(g_P' P)) with the unmasked P, and
//                           g_v = mask(P)^T g_o (JAX _win64_attention_grads l.466-480);
//   reduce_chunks_kernel    sums the partials of every job above in a fixed order;
//   store_rounded_kernel    out = rnd(a), or rnd(rnd(a) + rnd(b)): K3's input gradient in
//                           bf16 from its fp32 q-side (a) and, under cross, k/v-side (b) sums.
//
// Why two passes. The TPU kernels accumulate weight gradients across their sequential
// grid (gw_ref[0] += mm_tn(...)). Hopper's blocks run in parallel and in no order, and
// the reductions run over up to 250,880 tokens per stream into outputs as small as
// 24 x 25, so a grid over output tiles would be one block. Every block writes its own
// partial; a second pass sums the partials in chunk order. No atomics: the result is
// the same bit for bit from run to run.
//
// The formulas are the JAX kernels' (pallas_block.py::_block_bwd_body, _ln_bwd,
// _act_and_grad; pallas_attention.py::_attention_bwd_body): the softmax clamp at 80 is
// not differentiated, and masked scores give exactly 0 because P is 0 there.

#pragma once

#include <algorithm>

#include "window_core.cuh"

namespace swin {

// ---- host-side scratch carving: the same walk sizes the workspace (base == nullptr) ----
struct Arena {
  float* base;
  size_t used = 0;
  float* take(size_t n) {
    float* r = base ? base + used : nullptr;
    used += (n + 31) / 32 * 32;  // 128-byte aligned pieces
    return r;
  }
};

// ---- weight gradients: partial[z][chunk] (Ka + 1, Nb) = [A | 1]^T @ B over the chunk ----
// TA, TB: the element types of A and B (float or bf16).
template <typename TA = float, typename TB = float>
struct WgradBatchT {
  const TA* a[kMaxBatch];  // (M, Ka)
  const TB* b[kMaxBatch];  // (M, Nb)
  float* part[kMaxBatch];  // (chunks, Ka + 1, Nb)
};
using WgradBatch = WgradBatchT<>;

template <int kTileA, int kTileB, typename TA, typename TB>
__global__ void __launch_bounds__((kTileA / 4) * (kTileB / 4))
    wgrad_kernel(WgradBatchT<TA, TB> p, int M, int Ka, int Nb, int chunk_rows) {
  constexpr int kThreads = (kTileA / 4) * (kTileB / 4);
  __shared__ float as[kBK][kTileA];
  __shared__ float bs[kBK][kTileB];
  const int z = blockIdx.z, chunk = blockIdx.y;
  const int R = Ka + 1;
  const int tiles_b = (Nb + kTileB - 1) / kTileB;
  const int i0 = (blockIdx.x / tiles_b) * kTileA, j0 = (blockIdx.x % tiles_b) * kTileB;
  const int m_begin = chunk * chunk_rows;
  const int m_end = min(M, m_begin + chunk_rows);
  const int tid = threadIdx.x;
  const int ty = tid / (kTileB / 4), tx = tid % (kTileB / 4);
  const TA* __restrict__ a = p.a[z];
  const TB* __restrict__ b = p.b[z];

  float acc[4][4] = {};
  for (int m0 = m_begin; m0 < m_end; m0 += kBK) {
    for (int e = tid; e < kBK * kTileA; e += kThreads) {
      const int kk = e / kTileA, i = e % kTileA;  // consecutive threads walk along a row
      const int m = m0 + kk, gi = i0 + i;
      float val = 0.0f;
      if (m < m_end) {
        if (gi < Ka) val = to_float(a[static_cast<size_t>(m) * Ka + gi]);
        else if (gi == Ka) val = 1.0f;
      }
      as[kk][i] = val;
    }
    for (int e = tid; e < kBK * kTileB; e += kThreads) {
      const int kk = e / kTileB, j = e % kTileB;
      const int m = m0 + kk, gj = j0 + j;
      bs[kk][j] = (m < m_end && gj < Nb) ? to_float(b[static_cast<size_t>(m) * Nb + gj]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* part = p.part[z] + static_cast<size_t>(chunk) * R * Nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty * 4 + i;
    if (gi >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx * 4 + j;
      if (gj < Nb) part[static_cast<size_t>(gi) * Nb + gj] = acc[i][j];
    }
  }
}

// Blocks of 32 or 64 output rows/columns, and M cut into chunks so that the launch holds
// about kWgradTargetThreads threads (a quarter of the card's resident threads).
constexpr int kWgradTargetThreads = 132 * 512;

struct WgradPlan {
  int tile_a, tile_b, tiles, chunk_rows, chunks;
};

inline WgradPlan wgrad_plan(int M, int Ka, int Nb, int batch) {
  WgradPlan w;
  const int R = Ka + 1;
  w.tile_a = R <= 32 ? 32 : 64;
  w.tile_b = Nb <= 32 ? 32 : 64;
  w.tiles = ((R + w.tile_a - 1) / w.tile_a) * ((Nb + w.tile_b - 1) / w.tile_b);
  const int threads = (w.tile_a / 4) * (w.tile_b / 4);
  const int want = std::max(1, kWgradTargetThreads / (threads * w.tiles * batch));
  const int chunks = std::max(1, std::min(want, (M + 63) / 64));
  w.chunk_rows = ((M + chunks - 1) / chunks + kBK - 1) / kBK * kBK;
  w.chunks = (M + w.chunk_rows - 1) / w.chunk_rows;
  return w;
}

template <typename TA, typename TB>
void launch_wgrad(const WgradBatchT<TA, TB>& p, const WgradPlan& w, int M, int Ka, int Nb,
                  int batch, cudaStream_t st) {
  const dim3 grid(w.tiles, w.chunks, batch);
  if (w.tile_a == 32 && w.tile_b == 32)
    wgrad_kernel<32, 32, TA, TB><<<grid, 64, 0, st>>>(p, M, Ka, Nb, w.chunk_rows);
  else if (w.tile_a == 32)
    wgrad_kernel<32, 64, TA, TB><<<grid, 128, 0, st>>>(p, M, Ka, Nb, w.chunk_rows);
  else if (w.tile_b == 32)
    wgrad_kernel<64, 32, TA, TB><<<grid, 128, 0, st>>>(p, M, Ka, Nb, w.chunk_rows);
  else
    wgrad_kernel<64, 64, TA, TB><<<grid, 256, 0, st>>>(p, M, Ka, Nb, w.chunk_rows);
}

// ---- fixed-order sums of partials ------------------------------------------------------
constexpr int kMaxJobs = 24;
constexpr int kReduceThreads = 256;

struct ReduceJobs {
  const float* src[kMaxJobs];  // (chunks, n)
  float* dst_a[kMaxJobs];      // sums 0 .. n_a - 1
  float* dst_b[kMaxJobs];      // sums n_a .. n - 1
  int chunks[kMaxJobs], n[kMaxJobs], n_a[kMaxJobs];
  int count;
  int max_n;

  // adds a job; returns false when the list is full
  bool add(const float* s, int c, int total, int split, float* a, float* b) {
    if (count >= kMaxJobs) return false;
    src[count] = s;
    chunks[count] = c;
    n[count] = total;
    n_a[count] = split;
    dst_a[count] = a;
    dst_b[count] = b;
    ++count;
    max_n = std::max(max_n, total);
    return true;
  }
};

__global__ void __launch_bounds__(kReduceThreads) reduce_chunks_kernel(ReduceJobs p) {
  const int job = blockIdx.y;
  const int j = blockIdx.x * kReduceThreads + threadIdx.x;
  const int n = p.n[job];
  if (j >= n) return;
  const float* __restrict__ src = p.src[job];
  float s = 0.0f;
  for (int c = 0; c < p.chunks[job]; ++c) s += src[static_cast<size_t>(c) * n + j];
  if (j < p.n_a[job]) p.dst_a[job][j] = s;
  else p.dst_b[job][j - p.n_a[job]] = s;
}

inline void launch_reduce(const ReduceJobs& jobs, cudaStream_t st) {
  const dim3 grid((jobs.max_n + kReduceThreads - 1) / kReduceThreads, jobs.count);
  reduce_chunks_kernel<<<grid, kReduceThreads, 0, st>>>(jobs);
}

// ---- LayerNorm of token rows, forward and backward -------------------------------------
constexpr int kLnWarps = 8;
constexpr int kLnThreads = kLnWarps * 32;
constexpr int kLnRowsPerBlock = 128;
constexpr int kLnMaxPerLane = 12;  // C <= 384
constexpr int kLnMaxC = 32 * kLnMaxPerLane;

// TX: the element type of x (float or bf16); out and the statistics are fp32.
template <typename TX = float>
struct LnBatchT {
  const TX* x[kMaxBatch];         // (M, C)
  const float* gamma[kMaxBatch];  // (C)
  const float* beta[kMaxBatch];   // (C)
  float* out[kMaxBatch];          // (M, C)
  float* stats[kMaxBatch];        // (M, 2): mean, 1/std
};
using LnBatch = LnBatchT<>;

// one warp per row: the mean, then the biased variance about it (as the GEMM prologue)
template <typename TX>
__global__ void __launch_bounds__(kLnThreads) ln_fwd_kernel(LnBatchT<TX> p, int M, int C) {
  const int z = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnWarps + warp;
  if (row >= M) return;
  const TX* __restrict__ x = p.x[z] + static_cast<size_t>(row) * C;
  float sum = 0.0f;
  for (int k = lane; k < C; k += 32) sum += to_float(x[k]);
  const float mean = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int k = lane; k < C; k += 32) {
    const float dev = to_float(x[k]) - mean;
    sq = fmaf(dev, dev, sq);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(sq) / C + kLnEps);
  float* out = p.out[z] + static_cast<size_t>(row) * C;
  for (int k = lane; k < C; k += 32)
    out[k] = (to_float(x[k]) - mean) * rstd * p.gamma[z][k] + p.beta[z][k];
  if (lane == 0) {
    p.stats[z][2 * static_cast<size_t>(row)] = mean;
    p.stats[z][2 * static_cast<size_t>(row) + 1] = rstd;
  }
}

template <typename TX>
void launch_ln_fwd(const LnBatchT<TX>& p, int M, int C, int batch, cudaStream_t st) {
  const dim3 grid((M + kLnWarps - 1) / kLnWarps, batch);
  ln_fwd_kernel<TX><<<grid, kLnThreads, 0, st>>>(p, M, C);
}

// TX, TR, TO: the element types of x, res and gx (float or bf16).
template <typename TX = float, typename TR = float, typename TO = float>
struct LnBwdBatchT {
  const float* g[kMaxBatch];      // (M, C) gradient of the LayerNorm's output
  const float* g2[kMaxBatch];     // (M, C) a second gradient of it, rounded apart (kSplit)
  const TX* x[kMaxBatch];         // (M, C) its input
  const float* stats[kMaxBatch];  // (M, 2) from ln_fwd_kernel
  const float* gamma[kMaxBatch];  // (C)
  const TR* res[kMaxBatch];       // (M, C) gradient added to the input gradient
  TO* gx[kMaxBatch];              // (M, C)
  float* part[kMaxBatch];         // (blocks, 2C): column sums of g * xhat, then of g
};
using LnBwdBatch = LnBwdBatchT<>;

template <typename TX, typename TR, typename TO, bool kSplit>
__global__ void __launch_bounds__(kLnThreads) ln_bwd_kernel(LnBwdBatchT<TX, TR, TO> p, int M, int C) {
  extern __shared__ float red[];  // [kLnWarps][2C]
  const int z = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* __restrict__ g = p.g[z];
  const float* __restrict__ g2 = kSplit ? p.g2[z] : nullptr;
  const TX* __restrict__ x = p.x[z];
  const float* __restrict__ gamma = p.gamma[z];
  float pg[kLnMaxPerLane] = {}, pb[kLnMaxPerLane] = {};
  const int row0 = blockIdx.x * kLnRowsPerBlock;
  const int row_end = min(M, row0 + kLnRowsPerBlock);
  for (int r = row0 + warp; r < row_end; r += kLnWarps) {
    const float mean = p.stats[z][2 * static_cast<size_t>(r)];
    const float rstd = p.stats[z][2 * static_cast<size_t>(r) + 1];
    const size_t off = static_cast<size_t>(r) * C;
    float xh[kLnMaxPerLane], gh[kLnMaxPerLane], gh2[kLnMaxPerLane];
    float s1 = 0.0f, s2 = 0.0f, t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int e = 0; e < kLnMaxPerLane; ++e) {
      const int c = lane + 32 * e;
      xh[e] = gh[e] = 0.0f;
      if (kSplit) gh2[e] = 0.0f;
      if (c < C) {
        float gv = g[off + c];
        xh[e] = (to_float(x[off + c]) - mean) * rstd;
        gh[e] = gv * gamma[c];
        s1 += gh[e];
        s2 = fmaf(gh[e], xh[e], s2);
        if (kSplit) {
          const float gv2 = g2[off + c];
          gh2[e] = gv2 * gamma[c];
          t1 += gh2[e];
          t2 = fmaf(gh2[e], xh[e], t2);
          gv += gv2;  // the gamma and beta gradients take both sides' sum
        }
        pg[e] = fmaf(gv, xh[e], pg[e]);
        pb[e] += gv;
      }
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    if (kSplit) {
      t1 = warp_sum(t1) / C;
      t2 = warp_sum(t2) / C;
    }
#pragma unroll
    for (int e = 0; e < kLnMaxPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c < C) {
        const float v = to_float(p.res[z][off + c]) + rstd * (gh[e] - s1 - xh[e] * s2);
        if (kSplit) {
          const float v2 = rstd * (gh2[e] - t1 - xh[e] * t2);
          p.gx[z][off + c] = from_float<TO>(round_bf16(v) + round_bf16(v2));
        } else {
          p.gx[z][off + c] = from_float<TO>(v);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kLnMaxPerLane; ++e) {
    const int c = lane + 32 * e;
    if (c < C) {
      red[warp * 2 * C + c] = pg[e];
      red[warp * 2 * C + C + c] = pb[e];
    }
  }
  __syncthreads();
  float* part = p.part[z] + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kLnThreads) {
    float s = 0.0f;
    for (int w = 0; w < kLnWarps; ++w) s += red[w * 2 * C + c];
    part[c] = s;
  }
}

inline int ln_bwd_blocks(int M) { return (M + kLnRowsPerBlock - 1) / kLnRowsPerBlock; }

// kSplit: p.g2 holds a second gradient whose input gradient is rounded to bf16 apart
// (only with a bf16 gx).
template <bool kSplit = false, typename TX, typename TR, typename TO>
void launch_ln_bwd(const LnBwdBatchT<TX, TR, TO>& p, int M, int C, int batch, cudaStream_t st) {
  const dim3 grid(ln_bwd_blocks(M), batch);
  const size_t smem = static_cast<size_t>(kLnWarps) * 2 * C * sizeof(float);
  ln_bwd_kernel<TX, TR, TO, kSplit><<<grid, kLnThreads, smem, st>>>(p, M, C);
}

// ---- K3's bf16 input gradient: rnd(a), or rnd(rnd(a) + rnd(b)) under cross --------------
constexpr int kStoreThreads = 256;

__global__ void __launch_bounds__(kStoreThreads)
    store_rounded_kernel(const float* a, const float* b, bf16* out, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kStoreThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = from_float<bf16>(b != nullptr ? round_bf16(a[i]) + round_bf16(b[i]) : a[i]);
}

inline void launch_store_rounded(const float* a, const float* b, bf16* out, size_t n,
                                 cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((n + kStoreThreads - 1) / kStoreThreads);
  store_rounded_kernel<<<blocks, kStoreThreads, 0, st>>>(a, b, out, n);
}

// ---- attention core backward -----------------------------------------------------------
constexpr int kCoreBwdWindows = 16;  // windows per block, summed into one bias partial

template <bool kWindows, bool kDrop = false>
__global__ void __launch_bounds__(kCoreThreads) window_core_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ go, const float* __restrict__ bias, float* __restrict__ gq,
    float* __restrict__ gk, float* __restrict__ gv, float* __restrict__ gbias_part, int B,
    int H, int W, int heads, int d, int wh, int ww, int top, int left, float scale,
    int groups, DropSite drop) {
  extern __shared__ float smem[];
  const int T = wh * ww;
  const int inner = heads * d;
  const int nw = W / ww;
  const int n_win = (H / wh) * nw;
  const int grp = blockIdx.x;
  const int n = blockIdx.y;  // s * B + b
  const int s = n / B;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  float* qs = smem;            // [T][d] q, scale folded in
  float* ks = qs + T * d;      // [T][d]
  float* vs = ks + T * d;      // [T][d]
  float* gos = vs + T * d;     // [T][d] gradient of AV
  float* ps = gos + T * d;     // [T][T] probabilities
  float* gs = ps + T * T;      // [T][T] g_P, then g_S
  float* acc = gs + T * T;     // [T][T] sum of g_S over this block's windows
  int* pix = reinterpret_cast<int*>(acc + T * T);  // [T]
  int* region = pix + T;                           // [T]
  uint32_t* phs = reinterpret_cast<uint32_t*>(region + T);  // [T] unit hash (kDrop)
  int* slots = reinterpret_cast<int*>(phs + T);              // [T] slot (kDrop)

  for (int i = tid; i < T * T; i += kCoreThreads) acc[i] = 0.0f;
  const size_t base = static_cast<size_t>(n) * H * W * inner + static_cast<size_t>(h) * d;
  const float* __restrict__ bias_s = bias + static_cast<size_t>(s) * T * T;

  for (int win = grp * kCoreBwdWindows; win < min(n_win, (grp + 1) * kCoreBwdWindows); ++win) {
    const int wr = win / nw, wc = win % nw;
    for (int t = tid; t < T; t += kCoreThreads) {
      const int rr = wr * wh + t / ww;
      const int rc = wc * ww + t % ww;
      pix[t] = kWindows ? win * T + t : ((rr - top + H) % H) * W + (rc - left + W) % W;
      region[t] = ((rr < top) << 1) | (rc < left);
      if (kDrop) phs[t] = token_hash(drop, n, pix[t], &slots[t]);
    }
    __syncthreads();
    for (int i = tid; i < T * d; i += kCoreThreads) {
      const size_t at = base + static_cast<size_t>(pix[i / d]) * inner + i % d;
      qs[i] = q[at];
      ks[i] = k[at];
      vs[i] = v[at];
      gos[i] = go[at];
    }
    __syncthreads();
    // exp of the clamped, masked scores, and g_P = g_o v^T
    for (int i = tid; i < T * T; i += kCoreThreads) {
      const int t = i / T, u = i % T;
      float sc = 0.0f, gp = 0.0f;
      for (int j = 0; j < d; ++j) {
        sc = fmaf(qs[t * d + j], ks[u * d + j], sc);
        gp = fmaf(gos[t * d + j], vs[u * d + j], gp);
      }
      sc += bias_s[i];
      if (region[t] != region[u]) sc = kMaskFill;
      ps[i] = expf(fminf(sc, kSoftmaxClamp));
      gs[i] = gp;
    }
    __syncthreads();
    // one warp per row: normalise P, then g_S = P (g_P - sum_u g_P P); under kDrop g_P is
    // masked first, and P, once g_S has used it, becomes the masked P that g_v needs (the
    // lane's keep bits ride in a register between the two passes)
    for (int t = warp; t < T; t += kCoreThreads / 32) {
      float sum = 0.0f;
      for (int u = lane; u < T; u += 32) sum += ps[t * T + u];
      const float r = 1.0f / (warp_sum(sum) + 1e-30f);
      float dot = 0.0f;
      uint32_t keep_bits = 0;
      for (int u = lane, it = 0; u < T; u += 32, ++it) {
        const float pv = ps[t * T + u] * r;
        ps[t * T + u] = pv;
        float gp = gs[t * T + u];
        if (kDrop) {
          const bool keep =
              hash_keep(phs[t], attn_intra(drop, h, slots[t], slots[u], heads), drop.threshold);
          keep_bits |= static_cast<uint32_t>(keep) << it;
          gp = keep ? gp * drop.scale : 0.0f;
          gs[t * T + u] = gp;
        }
        dot = fmaf(gp, pv, dot);
      }
      dot = warp_sum(dot);
      for (int u = lane, it = 0; u < T; u += 32, ++it) {
        const float pv = ps[t * T + u];
        const float g_s = pv * (gs[t * T + u] - dot);
        gs[t * T + u] = g_s;
        acc[t * T + u] += g_s;  // this (warp, lane) owns the entry in every window
        if (kDrop) ps[t * T + u] = (keep_bits >> it) & 1u ? pv * drop.scale : 0.0f;
      }
    }
    __syncthreads();
    // g_v = P^T g_o, g_q = scale g_S k, g_k = g_S^T q_scaled
    for (int i = tid; i < T * d; i += kCoreThreads) {
      const int t = i / d, j = i % d;
      float a_v = 0.0f, a_q = 0.0f, a_k = 0.0f;
      for (int u = 0; u < T; ++u) {
        a_v = fmaf(ps[u * T + t], gos[u * d + j], a_v);
        a_q = fmaf(gs[t * T + u], ks[u * d + j], a_q);
        a_k = fmaf(gs[u * T + t], qs[u * d + j], a_k);
      }
      const size_t at = base + static_cast<size_t>(pix[t]) * inner + j;
      gq[at] = a_q * scale;
      gk[at] = a_k;
      gv[at] = a_v;
    }
    __syncthreads();  // the next window overwrites every buffer
  }
  float* part = gbias_part + (static_cast<size_t>(n * heads + h) * groups + grp) * T * T;
  for (int i = tid; i < T * T; i += kCoreThreads) part[i] = acc[i];
}

inline size_t core_bwd_smem_bytes(int d, int wh, int ww, bool drop = false) {
  const size_t T = static_cast<size_t>(wh) * ww;
  return (4 * T * d + 3 * T * T) * sizeof(float) + (drop ? 4 : 2) * T * sizeof(int);
}

inline int core_bwd_groups(int H, int W, int wh, int ww) {
  const int n_win = (H / wh) * (W / ww);
  return (n_win + kCoreBwdWindows - 1) / kCoreBwdWindows;
}

// Launches the core backward over every window group, stream*batch and head; the bias
// partials are (S*B*heads*groups, T, T), those of stream s contiguous. Returns the
// attribute call's error (0 = ok).
template <bool kWindows, bool kDrop = false>
cudaError_t launch_core_bwd(const float* q, const float* k, const float* v, const float* go,
                            const float* bias, float* gq, float* gk, float* gv, float* part,
                            int S, int B, int H, int W, int heads, int d, int wh, int ww,
                            bool shift, float scale, cudaStream_t st,
                            const DropSite& drop = DropSite{}) {
  const size_t smem = core_bwd_smem_bytes(d, wh, ww, kDrop);
  const cudaError_t err = cudaFuncSetAttribute(
      window_core_bwd_kernel<kWindows, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = core_bwd_groups(H, W, wh, ww);
  const dim3 grid(groups, S * B, heads);
  window_core_bwd_kernel<kWindows, kDrop><<<grid, kCoreThreads, smem, st>>>(
      q, k, v, go, bias, gq, gk, gv, part, B, H, W, heads, d, wh, ww,
      shift ? wh - wh / 2 : 0, shift ? ww - ww / 2 : 0, scale, groups, drop);
  return cudaSuccess;
}

// ---- the attention half of a backward, shared by K3 and K1/K4 --------------------------
// Inputs per stream s (token rows, M per stream): `in` the rows the q/k/v projections
// read (LN1(x) in the block, x in K3; TIn fp32 or bf16), q (scaled), k, v, o = AV, and
// g_out (TG), the gradient of the projection's output. Writes g_in[r] = g_q[r] wq[r]^T +
// g_k[kv(r)] wk[kv(r)]^T + g_v[kv(r)] wv[kv(r)]^T, where kv(r) is the stream whose k/v
// were made from r's rows (the other stream under cross), and queues the reductions of
// the q/k/v/proj weight and bias gradients and of the relative-position bias gradient.
// With g_in_kv, the k/v terms go there instead and g_in holds the q term alone. With the
// attention site of `drop` on, q/k/v/o must be the forward's recompute with the same mask
// (o = mask(P) v).
struct AttnBwdScratch {
  float *go, *gq, *gk, *gv, *bias_part;
  float *wp_part, *qkv_part;
  WgradPlan wp_plan, qkv_plan;
};

inline AttnBwdScratch carve_attn_bwd(Arena& ar, int S, int B, int H, int W, int C, int heads,
                                     int d, int wh, int ww) {
  AttnBwdScratch sc;
  const int inner = heads * d;
  const size_t M = static_cast<size_t>(B) * H * W;
  const size_t T = static_cast<size_t>(wh) * ww;
  sc.go = ar.take(S * M * inner);
  sc.gq = ar.take(S * M * inner);
  sc.gk = ar.take(S * M * inner);
  sc.gv = ar.take(S * M * inner);
  sc.bias_part = ar.take(static_cast<size_t>(S) * B * heads * core_bwd_groups(H, W, wh, ww) * T * T);
  sc.wp_plan = wgrad_plan(static_cast<int>(M), inner, C, S);
  sc.wp_part = ar.take(static_cast<size_t>(S) * sc.wp_plan.chunks * (inner + 1) * C);
  sc.qkv_plan = wgrad_plan(static_cast<int>(M), C, inner, 3 * S);
  sc.qkv_part = ar.take(static_cast<size_t>(3 * S) * sc.qkv_plan.chunks * (C + 1) * inner);
  return sc;
}

// Gradient pointers of the attention's weights, per the forward's argument order.
struct AttnGrads {
  float *wq, *bq, *wk, *bk, *wv, *bv, *wp, *bp, *bias;
};

template <bool kWindows, typename TIn, typename TG>
cudaError_t attention_bwd(const AttnBwdScratch& sc, const TIn* in, const float* q,
                          const float* k, const float* v, const float* o, const TG* g_out,
                          const float* wq, const float* wk, const float* wv, const float* wp,
                          const float* bias, float* g_in, float* g_in_kv, const AttnGrads& gr,
                          ReduceJobs& jobs, int S, int B, int H, int W, int C, int heads, int d,
                          int wh, int ww, bool shift, bool cross, float scale, cudaStream_t st,
                          const DropArgs* drop = nullptr) {
  const int inner = heads * d;
  const int M = B * H * W;
  const size_t x_stream = static_cast<size_t>(M) * C;
  const size_t h_stream = static_cast<size_t>(M) * inner;
  const size_t T = static_cast<size_t>(wh) * ww;

  // g_o = g_out @ wp^T
  GemmBatchT<TG> gop = {};
  for (int s = 0; s < S; ++s) {
    gop.a[s] = g_out + s * x_stream;
    gop.b[s] = wp + static_cast<size_t>(s) * inner * C;
    gop.c[s] = sc.go + s * h_stream;
    gop.alpha[s] = 1.0f;
  }
  launch_gemm<false, false, false, false, true>(gop, M, inner, C, S, st);

  const cudaError_t err =
      drop_on(drop, kSiteAttn)
          ? launch_core_bwd<kWindows, true>(q, k, v, sc.go, bias, sc.gq, sc.gk, sc.gv,
                                            sc.bias_part, S, B, H, W, heads, d, wh, ww, shift,
                                            scale, st, drop_site(drop, kSiteAttn, H * W, B))
          : launch_core_bwd<kWindows>(q, k, v, sc.go, bias, sc.gq, sc.gk, sc.gv, sc.bias_part,
                                      S, B, H, W, heads, d, wh, ww, shift, scale, st);
  if (err != cudaSuccess) return err;

  // g_in[r]: the q side of stream r, then the k and v sides of the stream that read r
  // (into g_in_kv when it is given, the k side starting the sum there)
  const float* gsrc[3] = {sc.gq, sc.gk, sc.gv};
  const float* wsrc[3] = {wq, wk, wv};
  for (int part = 0; part < 3; ++part) {
    float* dst = part > 0 && g_in_kv != nullptr ? g_in_kv : g_in;
    GemmBatch gin = {};
    for (int r = 0; r < S; ++r) {
      const int s = part == 0 ? r : (cross ? S - 1 - r : r);
      gin.a[r] = gsrc[part] + s * h_stream;
      gin.b[r] = wsrc[part] + static_cast<size_t>(s) * C * inner;
      gin.res[r] = dst + r * x_stream;
      gin.c[r] = dst + r * x_stream;
      gin.alpha[r] = 1.0f;
    }
    if (part == 0 || (part == 1 && g_in_kv != nullptr))
      launch_gemm<false, false, false, false, true>(gin, M, C, inner, S, st);
    else
      launch_gemm<false, false, true, false, true>(gin, M, C, inner, S, st);
  }

  // weight gradients: wp from o and g_out; wq/wk/wv from the rows each projection read
  WgradBatchT<float, TG> wpb = {};
  for (int s = 0; s < S; ++s) {
    wpb.a[s] = o + s * h_stream;
    wpb.b[s] = g_out + s * x_stream;
    wpb.part[s] = sc.wp_part + static_cast<size_t>(s) * sc.wp_plan.chunks * (inner + 1) * C;
  }
  launch_wgrad(wpb, sc.wp_plan, M, inner, C, S, st);
  WgradBatchT<TIn, float> qkvb = {};
  for (int s = 0; s < S; ++s) {
    const int s_kv = cross ? S - 1 - s : s;
    for (int part = 0; part < 3; ++part) {
      const int z = s * 3 + part;
      qkvb.a[z] = in + (part == 0 ? s : s_kv) * x_stream;
      qkvb.b[z] = gsrc[part] + s * h_stream;
      qkvb.part[z] = sc.qkv_part + static_cast<size_t>(z) * sc.qkv_plan.chunks * (C + 1) * inner;
    }
  }
  launch_wgrad(qkvb, sc.qkv_plan, M, C, inner, 3 * S, st);

  const int bias_chunks = B * heads * core_bwd_groups(H, W, wh, ww);
  float* gw[3] = {gr.wq, gr.wk, gr.wv};
  float* gb[3] = {gr.bq, gr.bk, gr.bv};
  bool ok = true;
  for (int s = 0; s < S; ++s) {
    ok &= jobs.add(wpb.part[s], sc.wp_plan.chunks, (inner + 1) * C, inner * C,
                   gr.wp + static_cast<size_t>(s) * inner * C, gr.bp + static_cast<size_t>(s) * C);
    for (int part = 0; part < 3; ++part)
      ok &= jobs.add(qkvb.part[s * 3 + part], sc.qkv_plan.chunks, (C + 1) * inner, C * inner,
                     gw[part] + static_cast<size_t>(s) * C * inner,
                     gb[part] + static_cast<size_t>(s) * inner);
    ok &= jobs.add(sc.bias_part + static_cast<size_t>(s) * bias_chunks * T * T, bias_chunks,
                   static_cast<int>(T * T), static_cast<int>(T * T), gr.bias + s * T * T, nullptr);
  }
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace swin
