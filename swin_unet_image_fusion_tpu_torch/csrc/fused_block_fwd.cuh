// Fused pre-norm Swin block, the forward with and without dropout, fp32 and bf16, redesigned
// for Hopper (sm_90a), in both layouts of fused_block.cu. The kernels and their launch code;
// fused_block_fwd.cu builds the forms without dropout and fused_block_fwd_drop.cu the dropout
// forms (the same C interface, one library each, so that the two compile at once):
//   K4  swin_unet_image_fusion_tpu/ops/pallas_block.py::_block_fwd_body (l.52-190, through
//       _block_fwd_kernel / _block_fwd_kernel_self from pallas_fused_block; dropout l.87-109,
//       155-158, 167-168, 183-187), on the image;
//   K1  swin_unet_image_fusion_tpu/ops/pallas_pack.py::_packed_block_fwd_body (l.525-688,
//       through _packed_fwd_kernel / _packed_fwd_kernel_self from
//       pallas_packed_block_strips; dropout l.581-594, 626-640, 657-661, 679-685), on
//       window-packed tokens.
// The backward's recompute keeps fused_block.cu's five launches where
// ops/fused_block.py::block_bwd_plan routes it to fused_block.cu's backward (no stage of the
// default model); fused_block_bwd.cu recomputes on this file's design (window_fwd.cuh; at
// stages 2-4 the split route's kernels, which block_fwd.cuh holds for both files).
// The function is the one fused_block.cu computes:
//   y   = x + proj(attention(LN1(x), LN1(kv))) + bp
//   out = y + fc2(act(fc1(LN2(y)) + b1)) + b2, act ELU, ReLU or GELU (activation.cuh)
// LN in fp32 with the biased variance and eps 1e-5; under cross k/v come from the other
// stream's rows normalised with that stream's LN1; attention as window_fwd.cuh's core (the
// scale folded into q, the shared relative-position bias with the wrap-seam mask folded in
// as -inf, the fast softmax). Layouts (`windows`, a runtime flag that only window_rows
// reads): image x and out (S, B, H, W, C), the (shifted) window partition as address
// arithmetic; windows x and out (S, B, nWin, 49, C) as ops/window_pack.py::pack_windows lays
// them out in this block's geometry, token t of window w at row w * 49 + t. Every kernel
// after the attention works on token rows in x's layout, so only the rows of a window
// differ; the wrap regions come from the rolled-map coordinates in both.
//
// What bounds it, and the design. A 512² request runs ~80 GFLOP of K4 in 40 calls against
// ~25 MB of activations in and out: the arithmetic bounds it, not device memory (1.24 ms
// fp32 at 67 TFLOP/s; 0.11 ms bf16, then bytes); K1's 32 calls, 0.92 ms fp32 in both
// dtypes. The five launches wrote q, k, v, AV, y and the MLP hidden to device memory (~0.3
// GB per stage-0 call, more than the 50 MB L2) and ran every GEMM on one 64x64 tile shape.
// Here, by stage (ops/fused_block.py::block_fwd_plan):
//   fused (C <= 48 at 512²: 2,738 and 722 windows; where two blocks fit an SM, built for
//     three where three fit: stage 0 in fp32): ONE launch, k4_fused_kernel. A block owns
//     one window of one stream: it loads x (and, under cross,
//     the other stream's rows), keeps LN1(x) and LN1(kv) resident as GEMM operands, computes
//     q/k/v with the weights streamed through a three-deep cp.async ring, the attention core
//     and AV, the projection + bp + x = y (fp32, in shared memory), LN2(y), and the MLP in
//     chunks of the hidden: h = act(LN2(y) w1[:, j..] + b1) in shared memory, then its fc2
//     product added to register sums, so the hidden never leaves the block and any width
//     fits. Only x and out touch device memory.
//   split (stages 2-4: 200, 50 and 18 windows): SIX launches, each sized to its N:
//     k4_ln_kernel (LN1 of every token into a scratch in the operands' type),
//     k3_attention_kernel (K3's split attention block, window_fwd.cuh, on it; heads in
//     groups of <= 48 columns; AV to a window-major scratch),
//     k4_rows_kernel<proj> (48 output columns per block, + bp + x into an fp32 y scratch),
//     k4_ln_kernel<kLn2> (LN2 of y into LN1's scratch, dead by then), k4_fc1_kernel (both
//     it and w1 streamed, 144 / 192 hidden columns per block, two blocks an SM, + b1, act,
//     into the hidden scratch), k4_rows_kernel<fc2> (48 columns, + b2 + y, into out). The
//     LN2 pass and the streamed fc1 replaced an fc1 that kept 49 rows of LN2(y) resident and
//     recomputed them in every block of a tile (one block an SM): 0.59 / 0.56 / 0.87 ms to
//     0.07 + 0.43 / 0.08 + 0.38 / 0.15 + 0.47 per 512² request at stages 2 / 3 / 4 in fp32,
//     and 4.38 to 4.16 ms over stages 2-4 in bf16, the same bits (NVIDIA H100 80GB HBM3,
//     700 W, profiler device time, split_ab.py; PERF.md §6). fc2 split along K over two
//     blocks (partials added in a fixed order) was slower at stages 2-3 (0.56 to 0.62 ms)
//     and faster only at stage 4 (1.03 to 0.89); three row blocks an SM were no faster.
// Rounding: the I/O type (TX) and the operands' rounding (kBf16) are separate template
// parameters, as fused_block.cu's. fp32, and K1 in either I/O type (pallas_pack.py:563-688,
// its weights fp32 too, l.617-618): FMA only (TF32 stays off), 8x4 register tiles, every
// scratch fp32; K1 bf16 upcasts x on load, keeps y = x + proj fp32 and rounds y + m once on
// the store. K4 bf16 (kBf16, pallas_block.py:120-189): every product that the TPU body
// rounds runs on mma.sync with bf16 operands and fp32 accumulators: LN1(x), LN1(kv) and the
// weights (l.120-146), p and v (l.160), AV and wp (l.161-163), LN2(y) and w1 (l.172-173), the
// hidden and w2 (l.185); the weights are rounded as the fragments are built; q/k/v, the
// scores and y stay fp32; out is rounded once on the store.
// Every sum runs in a fixed order in one thread or one mma; no atomics: a repeat gives the
// same bits.
// Dropout (kDrop, a template parameter: the forms without dropout keep their bits): the four
// sites of the reference with hash_dropout.cuh's masks, keyed on K4's padded windows for the
// image layout and on K1's window pairs for the windows layout (ops/dropout_layout.py; a site of
// rate 0 is the identity), each in the epilogue of the product that makes it: p before AV (the
// fp32 core hashes each weight's keep bit where it uses it, among the key's FMAs; the bf16 core,
// whose P rows take few instructions, reads keep words hashed once a window and head, two 32-bit
// words a query row, in shared memory: split_ab.py --dropout chose each, PERF.md §6; in bf16 p is
// masked before its rounding), y = x + drop(proj + bp), the hidden
// drop(act(fc1 + b1)) before its rounding, out = y + drop(fc2 + b2). The tokens' unit hashes are
// computed once a block per site. The forward stores no keep bits: the backward hashes them
// again. The same launches: one at C <= 48, six above, no mask kernel.

#pragma once

#include "block_fwd.cuh"

namespace {

using namespace wfwd;
using namespace k4fwd;

constexpr int kFusedPitchMax = 16;  // the one-launch route's q/k row pitches: 4 to 16
constexpr int kMaxC = 384;          // channels of the split route, the backward's LayerNorm limit
// Shared memory a block of the one-launch route may take for three to share an SM (228 KB an
// SM, 1 KB of it reserved per block); such blocks are built for three (85 registers a
// thread): at stage 0 in fp32 the latency of each phase hides behind a third block.
constexpr int kSmem3 = 233472 / 3 - 1024;

// The relative-position bias and the q/k/v biases of columns c0.. (n per part) into shared
// memory: one cp.async group that the q/k/v GEMM waits for with its own.
__device__ void load_biases(const K4Args& a, int s, int c0, int n, float* bias_s, float* bqkv_s) {
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) cp_async4(bias_s + i, a.bias + s * kT * kT + i, true);
  for (int col = threadIdx.x; col < 3 * n; col += kThreads) {
    const int part = (col >= n) + (col >= 2 * n);
    const float* bsrc = part == 0 ? a.bq : part == 1 ? a.bk : a.bv;
    cp_async4(bqkv_s + col, bsrc + s * a.inner + c0 + col - part * n, true);
  }
  cp_async_commit();
}

// The region mask folded into the bias: -inf between regions, whose exp is exactly 0 as
// exp(-1e10) is (the scores are finite).
__device__ void mask_bias(float* bias_s, const int* region) {
  for (int i = threadIdx.x; i < kT * kT; i += kThreads)
    if (region[i / kT] != region[i % kT]) bias_s[i] = -__int_as_float(0x7f800000);
}

// ---- the one-launch route ----------------------------------------------------------------
// One block per (window, stream * batch): the whole block in shared memory (header).
// TX: x's and out's type; kBf16: bf16 operands (K4's rounding), else fp32 inside. kDrop: the
// four sites (header); once the q/k/v product is stored, the tokens' unit hashes at each site
// and their slots go over the q/k/v columns and biases, dead by then; the bf16 core reads the
// attention's keep words from the ring after its P, the fp32 core hashes each weight's bit.
template <int DP, typename TX, bool kBf16, int kBlocksPerSm, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) k4_fused_kernel(const K4Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using T = TX;
  const int C = a.C, inner = a.inner, hidden = a.hidden;
  const K4Layout L = k4_layout(kFused, kBf16, a.cross != 0, C, inner, hidden, a.heads, a.d, DP, a.hc, kDrop);
  const int tid = threadIdx.x;
  const int win = blockIdx.x, nb = blockIdx.y;
  const int s = nb / a.B, b = nb % a.B;
  const int kvs = a.cross ? a.S - 1 - s : s;
  const size_t map = static_cast<size_t>(a.H) * a.W * C;

  int* rows = reinterpret_cast<int*>(smem + L.tabs);
  int* region = rows + kRowsB;
  int* col_ofs = region + kRowsB;
  float* bqkv_s = reinterpret_cast<float*>(col_ofs + kColTable);
  float2* st = reinterpret_cast<float2*>(bqkv_s + kColTable);  // LN statistics: x (or y), kv
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* kv_raw = reinterpret_cast<float*>(smem + L.q);  // cross: the kv rows until LN1
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  void* a0 = smem + L.a0;
  void* a1 = smem + L.a1;
  void* h_s = smem + L.h;
  float* ring = reinterpret_cast<float*>(smem + L.ring);

  window_rows(a, win, rows, region);
  fill_col_table<DP, kBf16>(col_ofs, inner, a.d);
  load_biases(a, s, 0, inner, bias_s, bqkv_s);
  __syncthreads();
  const T* xb = static_cast<const T*>(a.x) + static_cast<size_t>(s * a.B + b) * map;
  const T* kvb = static_cast<const T*>(a.x) + static_cast<size_t>(kvs * a.B + b) * map;
  batched(kT * C, [&](int i) { return to_f(xb[rows[i / C] + i % C]); }, [&](int i, float v) { xs[i] = v; });
  if (a.cross)
    batched(kT * C, [&](int i) { return to_f(kvb[rows[i / C] + i % C]); }, [&](int i, float v) { kv_raw[i] = v; });
  __syncthreads();
  ln_to_a<kBf16>(xs, C, C, a.ln1g + s * C, a.ln1b + s * C, a0, st);
  if (a.cross) ln_to_a<kBf16>(kv_raw, C, C, a.ln1g + kvs * C, a.ln1b + kvs * C, a1, st + kRowsB);
  zero_smem(smem, L.q, L.zero_end);
  __syncthreads();

  {  // q/k/v of every head
    Gemm g{};
    g.aparts = a.cross ? 2 : 1;
    const size_t wofs = static_cast<size_t>(s) * C * inner;
    g.w[0] = a.wq + wofs;
    g.w[1] = a.wk + wofs;
    g.w[2] = a.wv + wofs;
    g.n = inner;
    g.ldw = inner;
    g.nb = 3 * inner;
    g.K = C;
    Sums<kBf16> acc;
    zero_sums(acc);
    gemm_res(acc, g, a0, a1, ring);
    apply(acc, g.nb, [&](int, int col, float v) {
      const float u = v + bqkv_s[col];
      return col < inner ? u * a.scale : u;
    });
    each(acc, g.nb, [&](int t, int col, float v) { put_qkv<DP, kBf16>(t, col, v, inner, col_ofs, q_s, k_s, smem + L.v); });
  }
  mask_bias(bias_s, region);
  zero_smem(smem, L.a0, L.a0 + a_bytes(kBf16, max2(C, inner)));  // AV's padded channels
  __syncthreads();
  uint32_t* ph = reinterpret_cast<uint32_t*>(col_ofs);  // kDrop: [site][64] unit hashes, then slots
  int* slot = reinterpret_cast<int*>(ph + swin::kNumSites * kRowsB);
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(smem + L.ring + L.keep);
  if constexpr (kDrop) {
    for (int t = tid; t < kT; t += kThreads)
#pragma unroll
      for (int site = 0; site < swin::kNumSites; ++site)
        ph[site * kRowsB + t] = swin::token_hash(a.drop.site[site], nb, rows[t] / C, &slot[t]);
    __syncthreads();
    if constexpr (kBf16) {
      swin::attention_keep_words(a.drop.site[swin::kSiteAttn], ph, slot, 0, a.heads, a.heads, keep_s);
      __syncthreads();
    }
  }
  // kDrop: the term of token t, column col of a token site `cols` wide, dropped or kept
  auto term = [&](int site, int t, int col, int cols, float v) {
    if constexpr (kDrop)
      return swin::masked(swin::token_keep(a.drop.site[site], ph[site * kRowsB + t], slot[t], col, cols), v,
                          a.drop.site[site].scale);
    else
      return v;
  };
  constexpr int kCoreDrop = !kDrop ? swin::kNoDrop : kBf16 ? swin::kDropWords : swin::kDropHashed;
  attention_core<DP, kBf16, kCoreDrop>(
      q_s, k_s, smem + L.v, reinterpret_cast<bf16*>(ring), bias_s, a.heads, a.d,
      [&](int t, int col, float v) { a_put<kBf16>(a0, inner, t, col, v); }, keep_s, a.drop.site[swin::kSiteAttn].scale,
      swin::AttnHash{a.drop.site[swin::kSiteAttn], ph + swin::kSiteAttn * kRowsB, slot, 0, a.heads});
  __syncthreads();

  {  // y = x + (AV wp + bp), fp32, in place of x
    Gemm g{};
    g.aparts = 1;
    g.w[0] = a.wp + static_cast<size_t>(s) * inner * C;
    g.n = g.nb = C;
    g.ldw = C;
    g.K = inner;
    Sums<kBf16> acc;
    zero_sums(acc);
    gemm_res(acc, g, a0, a0, ring);
    const float* bp = a.bp + s * C;
    apply(acc, C,
          [&](int t, int col, float v) { return xs[t * C + col] + term(swin::kSiteProj, t, col, C, v + bp[col]); });
    each(acc, C, [&](int t, int col, float v) { xs[t * C + col] = v; });
  }
  __syncthreads();
  ln_to_a<kBf16>(xs, C, C, a.ln2g + s * C, a.ln2b + s * C, a0, st);
  zero_smem(smem, L.h, L.h + a_bytes(kBf16, a.hc));
  __syncthreads();

  // the MLP in chunks of hc hidden columns: h = act(LN2(y) w1[:, j0..] + b1) in shared
  // memory, its product with w2[j0.., :] added to the output's sums
  Sums<kBf16> out_acc;
  zero_sums(out_acc);
  for (int j0 = 0; j0 < hidden; j0 += a.hc) {
    const int nh = min(a.hc, hidden - j0);
    Gemm g1{};
    g1.aparts = 1;
    g1.w[0] = a.w1 + static_cast<size_t>(s) * C * hidden + j0;
    g1.n = g1.nb = pad_cols(kBf16, nh);
    g1.ncols = nh;
    g1.ldw = hidden;
    g1.K = C;
    Sums<kBf16> acc;
    zero_sums(acc);
    gemm_res(acc, g1, a0, a0, ring);
    const float* b1 = a.b1 + static_cast<size_t>(s) * hidden + j0;
    swin::with_activation(a.act, [&](auto act) {
      apply(acc, nh, [&](int t, int col, float v) { return term(swin::kSiteHidden, t, j0 + col, hidden, act(v + b1[col])); });
    });
    each(acc, nh, [&](int t, int col, float v) { a_put<kBf16>(h_s, a.hc, t, col, v); });
    __syncthreads();
    Gemm g2{};
    g2.aparts = 1;
    g2.w[0] = a.w2 + (static_cast<size_t>(s) * hidden + j0) * C;
    g2.n = g2.nb = C;
    g2.ldw = C;
    g2.K = nh;
    if constexpr (kBf16) {
      gemm_res_bf16<kStages>(g2, static_cast<const bf16*>(h_s), static_cast<const bf16*>(h_s), a_lda(a.hc),
                             ring, out_acc.v);
      out_acc.nb = C;
    } else {
      out_acc.tile = gemm_res_f32<kStages>(g2, static_cast<const float*>(h_s), static_cast<const float*>(h_s),
                                           ring, out_acc.v);
    }
  }
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(s * a.B + b) * map;
  const float* b2 = a.b2 + s * C;
  apply(out_acc, C,
        [&](int t, int col, float v) { return xs[t * C + col] + term(swin::kSiteOut, t, col, C, v + b2[col]); });
  each(out_acc, C, [&](int t, int col, float v) { out[rows[t] + col] = from_float<T>(v); });
}

// ---- host side -------------------------------------------------------------------------
constexpr int kPitches[] = {4, 8, 12, 16, 24, 32, 48};

int pitch_for(int d) {
  for (int p : kPitches)
    if (d <= p) return p;
  return 0;
}

// Whether the kernels take these dimensions (ops/fused_block.py::block_fwd_plan makes the
// same checks and raises first). fused: every head in the block, hc hidden columns per MLP
// step; split: hg heads per attention block, hc hidden columns per fc1 block.
bool supported(bool bf16, int C, int inner, int heads, int d, int hidden, int hg, int hc, bool fused) {
  const int dp = pitch_for(d);
  if (dp == 0 || hg < 1 || heads % hg != 0 || inner != heads * d) return false;
  if (C % 8 != 0 || inner % 8 != 0 || hidden % 4 != 0 || hc < 1 || hc % 4 != 0) return false;
  const int n = hg * d, cols = max_cols(bf16);
  if (n % 8 != 0 || 3 * n > cols || 3 * n > kColTable) return false;
  if (fused) return hg == heads && dp <= kFusedPitchMax && C <= cols && hc <= cols && hc <= hidden;
  return hc == cols && C <= kMaxC;
}

cudaError_t set_smem(const void* kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, const K4Args& a, cudaStream_t st) {
  const cudaError_t err = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

int layout_total(int kind, bool bf16, const K4Args& a, bool drop) {
  return k4_layout(kind, bf16, a.cross != 0, a.C, a.inner, a.hidden, a.hg, a.d, pitch_for(a.d), a.hc, drop).total;
}

// kDrop: the dropout forms of the same launches.
template <int DP, typename TX, bool kBf16, bool kDrop>
cudaError_t launch_block(bool fused, const K4Args& a, cudaStream_t st) {
  const int nwin = (a.H / 7) * (a.W / 7), nb = a.S * a.B;
  if (fused) {
    if constexpr (DP <= kFusedPitchMax) {
      const int smem = layout_total(kFused, kBf16, a, kDrop);
      return smem <= kSmem3 ? launch(k4_fused_kernel<DP, TX, kBf16, 3, kDrop>, dim3(nwin, nb), smem, a, st)
                            : launch(k4_fused_kernel<DP, TX, kBf16, 2, kDrop>, dim3(nwin, nb), smem, a, st);
    }
    return cudaErrorInvalidValue;
  }
  const size_t rows = static_cast<size_t>(nb) * a.H * a.W;
  const unsigned ln_blocks = static_cast<unsigned>((rows + kThreads / 8 - 1) / (kThreads / 8));
  k4_ln_kernel<TX, kBf16, false><<<ln_blocks, kThreads, 0, st>>>(a);
  // K3's split attention block on LN1(x) and LN1(kv): AV into the window-major scratch; its
  // dropout form hashes the keep words of its heads and stores none
  const Args k3 = {a.ln, a.wq, a.bq, a.wk, a.bk, a.wv, a.bv, a.wp, a.bp, a.bias, nullptr, a.av,
                   a.S, a.B, a.H, a.W, a.C, a.inner, a.heads, a.d, a.hg, a.top, a.left, a.cross, a.scale,
                   a.windows, a.drop.site[swin::kSiteAttn], nullptr};
  constexpr int kAttnDrop = !kDrop ? swin::kNoDrop : kBf16 ? swin::kDropWords : swin::kDropHashed;
  const int asmem = layout_total(kAttn, kBf16, a, kDrop);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(k3_attention_kernel<DP, kBf16, false, kAttnDrop>), asmem);
  if (err != cudaSuccess) return err;
  k3_attention_kernel<DP, kBf16, false, kAttnDrop><<<dim3(nwin, nb, a.heads / a.hg), kThreads, asmem, st>>>(k3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = a.H * a.W / kT, col_groups = (a.C + kProjCols - 1) / kProjCols;
  const int rsmem = layout_total(kRows, kBf16, a, kDrop);
  err = launch(k4_rows_kernel<TX, kBf16, false, kDrop>, dim3(nwin, nb, col_groups), rsmem, a, st);
  if (err != cudaSuccess) return err;
  k4_ln_kernel<TX, kBf16, true><<<ln_blocks, kThreads, 0, st>>>(a);  // LN2 into LN1's scratch
  err = launch(k4_fc1_kernel<kBf16, kDrop>, dim3(tiles, nb, (a.hidden + a.hc - 1) / a.hc),
               layout_total(kFc1, kBf16, a, kDrop), a, st);
  if (err != cudaSuccess) return err;
  return launch(k4_rows_kernel<TX, kBf16, true, kDrop>, dim3(tiles, nb, col_groups), rsmem, a, st);
}

template <typename TX, bool kBf16, bool kDrop>
cudaError_t launch_pitch(bool fused, const K4Args& a, cudaStream_t st) {
  switch (pitch_for(a.d)) {
    case 4: return launch_block<4, TX, kBf16, kDrop>(fused, a, st);
    case 8: return launch_block<8, TX, kBf16, kDrop>(fused, a, st);
    case 12: return launch_block<12, TX, kBf16, kDrop>(fused, a, st);
    case 16: return launch_block<16, TX, kBf16, kDrop>(fused, a, st);
    case 24: return launch_block<24, TX, kBf16, kDrop>(fused, a, st);
    case 32: return launch_block<32, TX, kBf16, kDrop>(fused, a, st);
    case 48: return launch_block<48, TX, kBf16, kDrop>(fused, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// Shared memory in bytes of one block of kernel `kind` (swin_k4_fwd_smem).
size_t k4_fwd_smem(int kind, int bf16_ops, int cross, int C, int inner, int heads, int d, int hidden, int hg, int hc,
                   int drop) {
  if (kind < kFused || kind > kLn || !supported(bf16_ops != 0, C, inner, heads, d, hidden, hg, hc, kind == kFused))
    return 0;
  return static_cast<size_t>(
      k4_layout(kind, bf16_ops != 0, cross != 0, C, inner, hidden, hg, d, pitch_for(d), hc, drop != 0).total);
}

// swin_k4_fwd of the library that builds the kDrop forms (a call with dropout exactly where
// kDrop is set, else cudaErrorInvalidValue).
template <bool kDrop>
int k4_fwd(const void* x, const float* ln1g, const float* ln1b, const float* wq, const float* bq, const float* wk,
           const float* bk, const float* wv, const float* bv, const float* wp, const float* bp, const float* bias,
           const float* ln2g, const float* ln2b, const float* w1, const float* b1, const float* w2, const float* b2,
           void* out, void* ln, void* av, float* y, void* hid, const swin::DropArgs* drop, int S, int B, int H, int W,
           int C, int heads, int d, int hidden, int hg, int hc, int fused, int shift, int cross, int windows,
           int bf16_io, int bf16_ops, float scale, int act, void* stream) {
  const int inner = heads * d;
  if (H % 7 != 0 || W % 7 != 0 || S < 1 || S > 2 || (cross && S != 2) || (bf16_ops && !bf16_io) ||
      !supported(bf16_ops != 0, C, inner, heads, d, hidden, hg, hc, fused != 0) ||
      (!fused && (ln == nullptr || av == nullptr || y == nullptr || hid == nullptr)) ||
      shift < 0 || shift > 2 || (shift == 2 && !windows) || (drop != nullptr) != kDrop || !swin::activation_ok(act))
    return static_cast<int>(cudaErrorInvalidValue);
  const K4Args a = {x, ln1g, ln1b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2g, ln2b, w1, b1, w2, b2,
                    out, ln, av, y, hid, S, B, H, W, C, inner, heads, d, hidden, hg, hc,
                    shift == 1 ? 4 : 0, shift ? 4 : 0, cross, scale, windows != 0, nullptr,
                    kDrop ? swin::block_drop(drop, H * W, B) : swin::BlockDrop{}, act};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16_ops) err = launch_pitch<bf16, true, kDrop>(fused != 0, a, st);        // K4 bf16
  else if (bf16_io) err = launch_pitch<bf16, false, kDrop>(fused != 0, a, st);   // K1 bf16
  else err = launch_pitch<float, false, kDrop>(fused != 0, a, st);
  return static_cast<int>(err);
}

}  // namespace
