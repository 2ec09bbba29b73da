// The fused block's forward kernels and layouts that fused_block_fwd.cu (K4 and K1, with and
// without dropout) and the split backward route of fused_block_bwd.cu (its recompute) share: the
// block's shared-memory layouts and arguments, the GEMM sums in registers (fp32 tiles or mma
// fragments), and the split route's kernels (the LN passes, the projection / fc2 rows kernel
// and the streamed fc1). fused_block_fwd.cu's header says what bounds them and why the design
// is so.

#pragma once

#include "window_fwd.cuh"

namespace k4fwd {

using namespace wfwd;

// Columns one GEMM of a block takes at most: 7 x 36 fp32 tiles of 8x4 on 256 threads, or
// three 8-column mma tiles per warp.
__host__ __device__ constexpr int max_cols(bool bf16) { return bf16 ? kMaxNTilesB * kWarps * 8 : 36 * kTileN; }
// A GEMM's column count padded to its tiles.
__host__ __device__ constexpr int pad_cols(bool bf16, int n) { return round_up(n, bf16 ? 8 : kTileN); }

enum Kind { kFused = 0, kAttn = 1, kRows = 2, kFc1 = 3, kLn = 4 };  // kLn: no dynamic shared memory

// Byte offsets of one block's dynamic shared memory, per kernel (ops/fused_block.py mirrors
// them in block_fwd_plan). ring: the cp.async rings (bf16: the core's P after them); xs: x,
// then y, fp32 [49][C]; a0/a1: resident operands (LN1(x), then AV, then LN2(y); LN1(kv));
// q..zero_end: q/k/v, zero-filled before the q/k/v GEMM; the same space holds the raw kv rows
// before it and the MLP's hidden chunk after the core; tabs: rows, regions, q/k/v columns
// and biases, and the LN statistics (the row kernels and fc1: their row tables). keep (the
// fused kernel's bf16 dropout form, drop): the attention's keep words of every head in the ring
// after the core's P (the ring is free during the core), the ring grown where they do not fit.
struct K4Layout {
  int ring, xs, a0, a1, q, k, v, zero_end, h, bias, tabs, keep, total;
};

__host__ __device__ inline K4Layout k4_layout(int kind, bool bf16, bool cross, int C, int inner, int hidden,
                                              int hg, int d, int dp, int hc, bool drop = false) {
  K4Layout L{};
  const int p_bytes = bf16 ? kWarps * 32 * kPStride * 2 : 0;
  const int qk = align16(hg * kT * dp * 4);
  const int vb = align16(bf16 ? hg * round_up(d, 8) * kPStride * 2 : hg * kT * dp * 4);
  int off = 0;
  if (kind == kFused) {
    const int nb = max2(max2(3 * inner, C), pad_cols(bf16, hc));
    L.keep = p_bytes;
    off = align16(max2(b_bytes(bf16, nb, kStages), p_bytes + (drop && bf16 ? hg * kT * swin::kKeepWords * 4 : 0)));
    L.xs = off;
    off += align16(kT * C * 4);
    L.a0 = off;
    off += align16(a_bytes(bf16, max2(C, inner)));
    L.a1 = cross ? off : L.a0;
    if (cross) off += align16(a_bytes(bf16, C));
    L.q = L.h = off;
    L.k = off + qk;
    L.v = L.k + qk;
    L.zero_end = L.v + vb;
    off += max2(max2(2 * qk + vb, cross ? align16(kT * C * 4) : 0), align16(a_bytes(bf16, hc)));
    L.bias = off;
    off += align16(kT * kT * 4);
    L.tabs = off;
    off += align16((2 * kRowsB + 2 * kColTable + 4 * kRowsB) * 4);  // + LN statistics of x and kv
  } else if (kind == kAttn) {  // K3's split attention block (window_fwd.cuh), its kDrop form's hashes after
    off = attention_layout(bf16, false, cross, C, inner, hg, d, dp).total + (drop ? drop_attention_bytes(hg) : 0);
  } else if (kind == kRows) {
    off = L.tabs = align16(ring_a_bytes(bf16, 1, kProjStages) + b_bytes(bf16, kProjCols, kProjStages));
    off += align16(2 * kRowsB * 4);
  } else if (kind == kFc1) {  // hc hidden columns per block, A (LN2(y)) and w1 streamed
    off = L.tabs = align16(ring_a_bytes(bf16, 1, kStages) + b_bytes(bf16, pad_cols(bf16, hc), kStages));
    off += align16(kRowsB * 4);
  }
  L.total = off;
  return L;
}

struct K4Args {
  const void* x;
  const float *ln1g, *ln1b, *wq, *bq, *wk, *bk, *wv, *bv, *wp, *bp, *bias, *ln2g, *ln2b, *w1, *b1, *w2, *b2;
  void* out;
  void* ln;   // split: LN1(x) (S*B, H*W, C) in x's layout, in the operands' type
  void* av;   // split: AV (S*B, windows, 49, inner) in the operands' type
  float* y;   // split: y = x + proj, (S*B, H*W, C) fp32 in x's layout
  void* hid;  // split: the MLP hidden (S*B, H*W, hidden) in the operands' type (K4 bf16 rounds it)
  int S, B, H, W, C, inner, heads, d, hidden, hg, hc, top, left, cross;
  float scale;
  int windows;  // the token layout: 0 image (K4), 1 windows (K1)
  float* stats;  // the backward's recompute: LN1's (mean, 1/std) of every token, (S*B*H*W, 2)
  // the kDrop forms: the call's sites (the backward's recompute reads only the proj site)
  swin::BlockDrop drop;
  int act;  // the MLP's activation (activation.cuh); the backward's recompute: recompute_code's
};

// One GEMM result's sums in registers, fp32 tiles or mma fragments.
template <bool kBf16> struct Sums;
template <> struct Sums<false> {
  float v[8][kTileN];
  int tile;
};
template <> struct Sums<true> {
  float v[kMaxNTilesB][4][4];
  int nb;
};

// sums += A @ B with A resident (a0, and a1 for the k/v parts under cross); K channels of A.
template <bool kBf16>
__device__ __forceinline__ void gemm_res(Sums<kBf16>& s, const Gemm& g, const void* a0, const void* a1, float* ring) {
  if constexpr (kBf16) {
    gemm_res_bf16<kStages>(g, static_cast<const bf16*>(a0), static_cast<const bf16*>(a1), a_lda(g.K), ring, s.v);
    s.nb = g.nb;
  } else {
    s.tile = gemm_res_f32<kStages>(g, static_cast<const float*>(a0), static_cast<const float*>(a1), ring, s.v);
  }
}

// f(t, col, sum) for every row t < 49 and column col < ncols that this thread holds.
template <typename F>
__device__ __forceinline__ void each(const Sums<false>& s, int ncols, F f) {
  if (s.tile < 0) return;
  const int rg = s.tile % kRowGroups, c0 = s.tile / kRowGroups * kTileN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
      if (rg * 8 + i < kT && c0 + j < ncols) f(rg * 8 + i, c0 + j, s.v[i][j]);
}
template <typename F>
__device__ __forceinline__ void each(const Sums<true>& s, int ncols, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) {
    const int nt = warp + m * kWarps;
    if (nt >= s.nb / 8) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = mt * 16 + gq + (e >> 1) * 8, col = nt * 8 + 2 * t4 + (e & 1);
        if (t < kT && col < ncols) f(t, col, s.v[m][mt][e]);
      }
  }
}

// The same elements, each replaced by f(t, col, sum): reads only, so that their loads overlap
// (each() then stores).
template <typename F>
__device__ __forceinline__ void apply(Sums<false>& s, int ncols, F f) {
  if (s.tile < 0) return;
  const int rg = s.tile % kRowGroups, c0 = s.tile / kRowGroups * kTileN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
      if (rg * 8 + i < kT && c0 + j < ncols) s.v[i][j] = f(rg * 8 + i, c0 + j, s.v[i][j]);
}
template <typename F>
__device__ __forceinline__ void apply(Sums<true>& s, int ncols, F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) {
    const int nt = warp + m * kWarps;
    if (nt >= s.nb / 8) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = mt * 16 + gq + (e >> 1) * 8, col = nt * 8 + 2 * t4 + (e & 1);
        if (t < kT && col < ncols) s.v[m][mt][e] = f(t, col, s.v[m][mt][e]);
      }
  }
}

template <bool kBf16>
__device__ __forceinline__ void zero_sums(Sums<kBf16>& s) { zero_acc(s.v); }

// ---- the split route ---------------------------------------------------------------------
// LN1 of every token of both streams (x), or with kLn2 LN2 of y, 32 rows a block, into the
// scratch `ln` in the operands' type (rounded to bf16 under kBf16: K4's operand of the q/k/v
// products), row for row in x's layout. LN1(x) is dead once the attention has read it, so
// LN2(y) reuses its scratch (the backward's recompute gives it another). kStats: the rows'
// (mean, 1/std) into `stats` too, for the backward's LN1 backward.
template <typename TX, bool kBf16, bool kLn2, bool kStats = false>
__global__ void __launch_bounds__(kThreads) k4_ln_kernel(const K4Args a) {
  using T = typename std::conditional<kLn2, float, TX>::type;
  constexpr int kRows = kThreads / 8;
  __shared__ float2 st[kRows];
  const int C = a.C;
  const size_t per_stream = static_cast<size_t>(a.B) * a.H * a.W;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * kRows;
  const size_t left = a.S * per_stream - r0;
  const int n = left < kRows ? static_cast<int>(left) : kRows;
  const T* x = static_cast<const T*>(kLn2 ? static_cast<const void*>(a.y) : a.x) + r0 * C;
  const float* gamma = kLn2 ? a.ln2g : a.ln1g;
  const float* beta = kLn2 ? a.ln2b : a.ln1b;
  Act<kBf16>* out = static_cast<Act<kBf16>*>(a.ln) + r0 * C;
  row_stats(n, C, [&](int r) { return x + static_cast<size_t>(r) * C; }, st);
  __syncthreads();
  if constexpr (kStats)
    for (int r = threadIdx.x; r < n; r += kThreads) reinterpret_cast<float2*>(a.stats)[r0 + r] = st[r];
  batched(
      n * C,
      [&](int i) {
        const int r = i / C, k = i - r * C;
        const size_t s = (r0 + r) / per_stream;
        return layer_norm(to_f(x[i]), st[r], gamma[s * C + k], beta[s * C + k]);
      },
      [&](int i, float v) { out[i] = from_float<Act<kBf16>>(v); });
}

// The unit hashes and slots of a tile's 49 tokens at `site` (token t's row offset rows[t] =
// token * C), over the ring once the GEMM is done with it; ends with a barrier.
__device__ __forceinline__ void tile_hashes(const swin::DropSite& site, int n, const int* rows, int C, uint32_t* ph,
                                            int* slot) {
  for (int t = threadIdx.x; t < kT; t += kThreads) ph[t] = swin::token_hash(site, n, rows[t] / C, &slot[t]);
  __syncthreads();
}

// One block per (49 rows, stream * batch, 48 output columns), A (in the operands' type)
// streamed through a six-deep ring. kFc2 false: the projection, rows of a window, y = x +
// (AV wp + bp) into the fp32 scratch; kFc2 true: 49 consecutive token rows of x's layout,
// out = y + (h w2 + b2). kDrop (the forward's dropout form, and the dropout backward's recompute
// of the projection): y = x + drop(AV wp + bp) at the proj site, out = y + drop(h w2 + b2) at the
// out site, the tokens' unit hashes over the ring after the GEMM.
template <typename TX, bool kBf16, bool kFc2, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, 2) k4_rows_kernel(const K4Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = TX;
  using A = Act<kBf16>;
  const K4Layout L = k4_layout(kRows, kBf16, false, a.C, a.inner, a.hidden, 1, a.d, 4, a.hc);
  const int C = a.C;
  const int nb = blockIdx.y, s = nb / a.B, c0 = blockIdx.z * kProjCols;
  const size_t hw = static_cast<size_t>(a.H) * a.W;
  const int K = kFc2 ? a.hidden : a.inner;
  int* orows = reinterpret_cast<int*>(smem + L.tabs);  // output, x and y rows: token * C
  int* arows = orows + kRowsB;                          // A rows
  if (kFc2) {
    const int r0 = blockIdx.x * kT;
    for (int t = threadIdx.x; t < kRowsB; t += kThreads) {
      orows[t] = t < kT ? (r0 + t) * C : 0;
      arows[t] = t < kT ? (r0 + t) * K : 0;
    }
  } else {
    window_rows(a, blockIdx.x, orows, arows);
    for (int t = threadIdx.x; t < kRowsB; t += kThreads) arows[t] = t * K;
  }
  __syncthreads();

  Gemm g{};
  const A* abase = static_cast<const A*>(kFc2 ? a.hid : a.av);
  g.abase[0] = kFc2 ? abase + nb * hw * K
                    : abase + (static_cast<size_t>(nb) * (a.H / 7) * (a.W / 7) + blockIdx.x) * kT * K;
  g.aparts = 1;
  g.rows = arows;
  g.w[0] = (kFc2 ? a.w2 : a.wp) + static_cast<size_t>(s) * K * C + c0;
  g.n = g.nb = min(kProjCols, C - c0);
  g.ldw = C;
  g.K = K;
  Sums<kBf16> acc;
  if constexpr (kBf16) {
    gemm_bf16<kProjStages>(g, reinterpret_cast<bf16*>(smem), reinterpret_cast<float*>(smem) +
                           ring_a_bytes(true, 1, kProjStages) / 4, acc.v);
    acc.nb = g.nb;
  } else {
    acc.tile = gemm_f32<kProjStages>(g, reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem) +
                                     ring_a_bytes(false, 1, kProjStages) / 4, acc.v);
  }
  const float* bias = (kFc2 ? a.b2 : a.bp) + s * C + c0;
  const size_t base = nb * hw * C + c0;
  float* y = a.y + base;
  // kDrop: the element's term, dropped or kept at this launch's site
  const swin::DropSite& site = a.drop.site[kFc2 ? swin::kSiteOut : swin::kSiteProj];
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem);
  int* slot = reinterpret_cast<int*>(ph + kRowsB);
  if constexpr (kDrop) tile_hashes(site, nb, orows, C, ph, slot);
  auto term = [&](int t, int col, float v) {
    if constexpr (kDrop) return swin::masked(swin::token_keep(site, ph[t], slot[t], c0 + col, C), v, site.scale);
    else return v;
  };
  if constexpr (kFc2) {
    T* out = static_cast<T*>(a.out) + base;
    apply(acc, g.nb, [&](int t, int col, float v) { return y[orows[t] + col] + term(t, col, v + bias[col]); });
    each(acc, g.nb, [&](int t, int col, float v) { out[orows[t] + col] = from_float<T>(v); });
  } else if constexpr (kDrop) {
    const T* x = static_cast<const T*>(a.x) + base;
    apply(acc, g.nb, [&](int t, int col, float v) { return to_f(x[orows[t] + col]) + term(t, col, v + bias[col]); });
    each(acc, g.nb, [&](int t, int col, float v) { y[orows[t] + col] = v; });
  } else {
    const T* x = static_cast<const T*>(a.x) + base;
    apply(acc, g.nb, [&](int t, int col, float v) { return to_f(x[orows[t] + col]) + (v + bias[col]); });
    each(acc, g.nb, [&](int t, int col, float v) { y[orows[t] + col] = v; });
  }
}

// One block per (49 tokens, stream * batch, hc hidden columns): LN2(y) from the LN2 pass's
// scratch and w1's columns both streamed through rings (no per-block LN2 prologue: the block
// is small enough for two an SM); h = act(. + b1) into the hidden scratch (rounded under
// kBf16; the backward's recompute of a GELU call stores z, activation.cuh). kDrop (the forward's
// dropout form): h = drop(act(. + b1)) at the hidden site, before the rounding.
template <bool kBf16, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, 2) k4_fc1_kernel(const K4Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = Act<kBf16>;
  const int C = a.C, hidden = a.hidden;
  const K4Layout L = k4_layout(kFc1, kBf16, false, C, a.inner, hidden, 1, a.d, 4, a.hc);
  const int nb = blockIdx.y, s = nb / a.B, r0 = blockIdx.x * kT, j0 = blockIdx.z * a.hc;
  const size_t tok = static_cast<size_t>(nb) * a.H * a.W + r0;  // first token of the tile
  int* arows = reinterpret_cast<int*>(smem + L.tabs);
  for (int t = threadIdx.x; t < kRowsB; t += kThreads) arows[t] = t < kT ? t * C : 0;
  __syncthreads();
  const int nh = min(a.hc, hidden - j0);
  Gemm g{};
  g.abase[0] = static_cast<const T*>(a.ln) + tok * C;
  g.aparts = 1;
  g.rows = arows;
  g.w[0] = a.w1 + static_cast<size_t>(s) * C * hidden + j0;
  g.n = g.nb = pad_cols(kBf16, nh);
  g.ncols = nh;
  g.ldw = hidden;
  g.K = C;
  Sums<kBf16> acc;
  float* bbuf = reinterpret_cast<float*>(smem + ring_a_bytes(kBf16, 1, kStages));
  if constexpr (kBf16) {
    gemm_bf16<kStages>(g, reinterpret_cast<bf16*>(smem), bbuf, acc.v);
    acc.nb = g.nb;
  } else {
    acc.tile = gemm_f32<kStages>(g, reinterpret_cast<float*>(smem), bbuf, acc.v);
  }
  T* h = static_cast<T*>(a.hid) + tok * hidden + j0;
  const float* b1 = a.b1 + static_cast<size_t>(s) * hidden + j0;
  if constexpr (kDrop) {
    const swin::DropSite& site = a.drop.site[swin::kSiteHidden];
    uint32_t* ph = reinterpret_cast<uint32_t*>(smem);
    int* slot = reinterpret_cast<int*>(ph + kRowsB);
    for (int t = threadIdx.x; t < kT; t += kThreads) ph[t] = swin::token_hash(site, nb, r0 + t, &slot[t]);
    __syncthreads();
    swin::with_activation(a.act, [&](auto act) {
      apply(acc, nh, [&](int t, int col, float v) {
        return swin::masked(swin::token_keep(site, ph[t], slot[t], j0 + col, hidden), act(v + b1[col]), site.scale);
      });
    });
  } else {
    swin::with_activation(a.act, [&](auto act) { apply(acc, nh, [&](int, int col, float v) { return act(v + b1[col]); }); });
  }
  each(acc, nh, [&](int t, int col, float v) { h[static_cast<size_t>(t) * hidden + col] = from_float<T>(v); });
}

}  // namespace k4fwd
