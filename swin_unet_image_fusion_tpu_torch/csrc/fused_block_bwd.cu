// Fused pre-norm Swin block, the backward with and without dropout, fp32 and bf16, redesigned
// for Hopper (sm_90a), in both layouts of fused_block.cu:
//   K4 bwd  swin_unet_image_fusion_tpu/ops/pallas_block.py::_block_bwd_body (l.230-449,
//           through _block_bwd_kernel / _block_bwd_kernel_self from _backward, l.688), on
//           the image;
//   K1 bwd  swin_unet_image_fusion_tpu/ops/pallas_pack.py::_packed_block_bwd_body (l.760-,
//           through _packed_bwd_kernel / _packed_bwd_kernel_self from _backward, l.1644), on
//           window-packed tokens.
// Every shape this file does not take keeps another route (ops/fused_block.py::block_bwd_plan
// routes them, with and without dropout alike: this file's route at stages 0-1 of the default
// model, fused_block_bwd_split.cu at stages 2-3, fused_block.cu's twenty launches at stage 4).
// The function is fused_block.cu's backward: given x, the 17 weights and g = dL/d out, it
// recomputes the block and returns g_x and every weight's gradient; under cross the k/v
// gradients of stream s go into stream 1-s's LN1 backward; a bf16 g_x under cross is
// rnd(rnd(g_y + q side) + rnd(k/v side)), the sum of the JAX kernels' gx and gkv outputs in
// x's dtype; the softmax clamp at 80 is not differentiated. fp32 inside in both dtypes
// (x and g upcast as they are loaded, as both JAX bodies compute: K4 l.278-293, K1
// l.792-794): K4 bf16's forward rounds its operands to bf16, its backward does not, so the
// recompute here is K1's fp32 block, never K4 bf16's forward.
//
// What bounds it, and the design. The backward does about three times the forward's
// matmul work (recompute, input gradients, weight gradients), so the fp32 rate bounds it as
// it bounds the forward (0.38 / 0.22 ms per stage-0 call at 224² batch 20, encoder /
// decoder MLP; PERF.md §6). fused_block.cu's backward runs twenty launches a block: LN1, the
// 64x64-tile GEMMs and the old attention core for the recompute, a core backward of one
// 128-thread block per (16 windows, image, head) with scalar loops over shared memory, the
// LayerNorm backwards, and weight gradients on 32- or 64-wide tiles that at C = 24 compute
// mostly zeros. Where a window's blocks fit in shared memory (C <= 48 in the default model,
// stages 0-1: 3 heads*d <= 144, d <= 8, C <= 144) this file runs seven:
//   1. transpose_kernel: (wq|wk|wv)^T, wp^T, w1^T, w2^T into the workspace, so that every
//      input-gradient product streams its weights through the forward's ring;
//   2. block_fwd_kernel: a block per (group of windows, stream), walking a fixed list of
//      windows (blockIdx.x, + gridDim.x, ...), recomputes each window's forward on
//      window_fwd.cuh's code (LN1 of x and, under cross, of the other stream's rows as
//      resident operands; q/k/v with the weights through a cp.async ring; the attention
//      core; y = x + proj; LN2(y); the MLP hidden in steps) and writes what the backward
//      reads: LN1(x) and its statistics, q (scaled), k, v, AV, y, LN2(y), the hidden;
//   3. block_mlp_bwd_kernel: a block per (group of 49-token tiles, stream), the MLP and LN2
//      being per token: g_h = g w2^T, g_pre = g_h act'(z), g_lny += g_pre w1^T per step,
//      g_y = g + LN2'(g_lny) with its gamma/beta sums, g_o = g_y wp^T;
//   4. block_bwd_attn_kernel: a block per (group of windows, stream): window_bwd.cuh's core
//      backward over every head from q, k, v, g_o (the bias-table gradient summed in
//      registers across the block's windows), then g_ln = [g_q | g_k | g_v] [wq|wk|wv]^T,
//      under cross the q side and the k/v side apart, the latter into the other stream's
//      rows;
//   5. ln1_bwd_kernel: g_x = g_y + LN1'(g_ln) (the two sides of a row come from blocks of
//      both streams, hence a launch of its own), rounded as above, with per-block partials
//      of the LN1 gamma/beta gradients;
//   6. wgrad_rows_kernel (window_bwd.cuh): every weight's [A | 1]^T B over the tokens in one
//      launch, chunks of rows per block, 4 x 4 register tiles, the bias as the ones column;
//   7. reduce_chunks_kernel (window_core_bwd.cuh): every partial summed in chunk order.
// Every product of the block kernels has 8 x TN register tiles, TN from its width
// (window_bwd.cuh). One kernel for the whole window, tried first, needed up to 171 KB of
// shared memory and all 255 registers a thread, so one block an SM, and was slower than the
// twenty launches at stage 0; the three kernels fit two blocks an SM each (53-114 KB, 128
// registers), and register bounds for three blocks an SM were no faster, for one slower.
// The stored operands take ~1.0 GB at stage 0 of a 224² batch-20 step, written once and
// read once, against the twenty launches' 1.1 GB of scratch.
// At stages 2-3 (C = 96 and 192, d = 12 and 24) a window's blocks do not fit;
// fused_block_bwd_split.cu's split route runs eleven launches sized to each step instead, K3's
// backward block (k3_bwd.cuh) on the stored LN1(x) among them. Both share block_bwd.cuh's
// transposed weights and weight-gradient tail.
// fp32 FMA throughout (TF32 off), no atomics: every sum runs in a fixed order, and the
// blocks per stream come from the caller (one wave of the card's SMs), so two calls on one
// card give the same bits.
//
// Dropout (the seed_ref paths of K1 bwd, pallas_pack.py:808-818 and 866-929, and of K4 bwd,
// pallas_block.py:255-271 and 348-411): the same seven launches, each block kernel's kDrop
// form (a template parameter: the form without dropout keeps its bits), with the masks of
// hash_dropout.cuh keyed as the forward keyed them (DropArgs, one site of rate 0 the identity):
//   block_fwd_kernel<DP, true>      hashes the window's tokens at the attention and proj sites
//                                   and the attention's keep bits of every head (two 32-bit
//                                   words per query row, ballots of a warp), writes the words
//                                   to the workspace, runs the core on the dropped weights (AV
//                                   stored dropped) and adds drop(proj + bp) to x, so y and
//                                   LN2(y) are the forward's; the hidden stays undropped;
//   block_mlp_bwd_kernel<true>      g_m = drop(g) as the g_h product's A (and to the workspace
//                                   for w2's and b2's gradients), g_pre = drop(g_m w2^T)
//                                   act'(z) with the hidden dropped in place once the tile has
//                                   read act'(z) (w2's gradient reads it), g_y = g + LN2'(g_lny)
//                                   with the undropped g, and g_o from g_proj = drop(g_y) (to the
//                                   workspace for wp's and bp's gradients);
//   block_bwd_attn_kernel<DP, true> the window's keep words (over its row buffer, dead during
//                                   the core), g_P masked and g_v from the dropped P in
//                                   window_bwd.cuh's core backward;
// the LN1 backward adds the undropped g_y, and the weight-gradient launch reads g_m, the
// dropped hidden and g_proj where the form without dropout reads g, h and g_y.

#include "block_bwd.cuh"

namespace {

using namespace wbwd;
using namespace bbwd;

constexpr int kLn1Rows = 128;          // token rows per block of the LN1 backward
constexpr int kLnMaxPerLane = 12;      // C <= 384 in the LN1 backward

// Byte offsets of the three blocks' dynamic shared memory (ops/fused_block.py::bwd_smem
// mirrors them).
//   forward (recompute): ring, the weight ring (two slots); xs: x, then y, fp32 [49][C];
//     rowbuf: the kv rows (cross); a1: LN1(x), then LN2(y); a3: AV (resident operands); qkv:
//     LN1(kv) (cross) until the q/k/v product has read it, then q, k, v in the core layout
//     [heads][49][DP], then the MLP step's hidden; bias: the window's bias with the wrap mask
//     as -inf; tabs: rows, regions, token rows, q/k/v columns and biases, LN statistics.
//   MLP backward: ring; xs: y; rowbuf: the g_lny sums, then g_o [49][C]; a1: g, then g_y;
//     u: the MLP step's g_pre; tabs: LN2 statistics and the LN2 gradient sums.
//   attention backward: ring; q, k, v, g_o (core layout); u: g_q | g_k | g_v (operands);
//     rd: the rows pass's (1/sum, dot) per (head, row); rowbuf: a g_ln product's rows; bias;
//     tabs: rows, regions, token rows.
enum Kernel { kForward = 0, kMlp = 1, kAttention = 2 };  // the three block kernels

//   drop (the dropout form), after the tables: forward, the tokens' unit hashes at the attention
//     and proj sites and their slots, then the keep words of every head; MLP backward, the unit
//     hashes at the proj, hidden and out sites and the slots; attention backward, the keep words,
//     over rowbuf where they fit there (2 heads <= C: rowbuf is dead until the g_ln products,
//     which run after the core; so stage 1 keeps two blocks an SM).
struct BwdLayout {
  int xs, rowbuf, a1, a2, a3, q, k, v, u, rd, go, bias, tabs, keep, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int kernel, int C, int inner, int heads, int dp, int hc, bool cross,
                                                bool drop = false) {
  BwdLayout L{};
  const int qkv = align16(heads * kT * dp * 4);
  const int rows_c = align16(kT * C * 4);
  const int step = align16(a_bytes(false, round_up(hc, 4)));
  int off;
  if (kernel == kForward) {
    off = align16(b_bytes(false, max2(max2(3 * inner, C), round_up(hc, 4)), kRing));
    L.xs = off;
    off += rows_c;
    L.rowbuf = off;
    off += cross ? rows_c : 0;
    L.a1 = off;
    off += align16(a_bytes(false, C));
    L.a3 = off;
    off += align16(a_bytes(false, inner));
    L.q = L.u = L.a2 = off;
    L.k = off + qkv;
    L.v = off + 2 * qkv;
    off += max2(max2(3 * qkv, step), cross ? align16(a_bytes(false, C)) : 0);
    L.bias = off;
    off += align16(kT * kT * 4);
    L.tabs = off;
    off += align16((3 * kRowsB + 2 * kColTable) * 4 + 3 * kRowsB * 8);
  } else if (kernel == kMlp) {
    off = align16(b_bytes(false, max2(max2(inner, C), round_up(hc, 4)), kRing));
    L.xs = off;
    off += rows_c;
    L.rowbuf = off;
    off += rows_c;
    L.a1 = off;
    off += align16(a_bytes(false, C));
    L.u = off;
    off += step;
    L.tabs = off;
    off += align16(kRowsB * 8 + 2 * C * 4);
  } else {
    off = align16(b_bytes(false, C, kRing));
    L.q = off;
    L.k = off + qkv;
    L.v = off + 2 * qkv;
    L.go = off + 3 * qkv;
    off += 4 * qkv;
    L.u = off;
    off += align16(a_bytes(false, 3 * inner));
    L.rd = off;
    off += align16(heads * kT * 8);
    L.rowbuf = off;
    off += rows_c;
    L.bias = off;
    off += align16(kT * kT * 4);
    L.tabs = off;
    off += align16(3 * kRowsB * 4);
  }
  L.keep = off;
  const int words = align16(heads * kT * swin::kKeepWords * 4);
  if (kernel == kAttention && words <= align16(kT * C * 4)) L.keep = L.rowbuf;
  else if (drop) off += kernel == kForward ? align16(3 * kRowsB * 4) + words : kernel == kMlp ? align16(4 * kRowsB * 4) : words;
  L.total = off;
  return L;
}

struct BwdArgs {
  const void* x;
  const void* g;
  const float *ln1g, *ln1b, *wq, *bq, *wk, *bk, *wv, *bv, *wp, *bp, *bias, *ln2g, *ln2b, *w1, *b1, *w2, *b2;
  const float *wqkvT, *wpT, *w1T, *w2T;  // per stream (3 inner, C), (C, inner), (hidden, C), (C, hidden)
  // token rows of x's layout, (S, B*H*W, width) fp32
  float *lnx, *stats1, *q, *k, *v, *o, *y, *lny, *h, *gpre, *gy, *go, *gq, *gk, *gv, *glnq, *glnkv;
  float *tab_part, *ln2_part;  // (S, attention blocks per stream, 49*49), (S, MLP blocks, 2C)
  int S, B, H, W, C, inner, heads, d, hidden, hc, top, left, cross;
  float scale;
  int windows;  // the token layout: 0 image (K4), 1 windows (K1)
  int bf16;     // x and g bf16 (else fp32)
  // the dropout form (kDrop): the call's sites; the keep words of every (image, window, head),
  // (S*B, windows, heads, 49, 2), written by the forward and read by the attention's backward;
  // g_m = drop(g) and g_proj = drop(g_y), (S, M, C)
  swin::BlockDrop drop;
  uint32_t* keep;
  float *gm, *gproj;
  int act;  // the MLP's activation (activation.cuh)
};

// The window's token rows, wrap regions and token indices, and its bias with the wrap mask.
__device__ void window_setup(const BwdArgs& a, int win, int s, int* rows, int* region, int* tok, float* bias_s) {
  window_rows(a, win, rows, region);
  for (int t = threadIdx.x; t < kRowsB; t += kThreads) tok[t] = rows[t] / a.C;  // this thread's rows[t]
  __syncthreads();
  for (int e = threadIdx.x; e < kT * kT; e += kThreads)
    bias_s[e] = region[e / kT] == region[e % kT] ? a.bias[s * kT * kT + e] : -__int_as_float(0x7f800000);
}

// Core-layout rows [heads][49][DP] of the window to token rows of device memory, or back.
template <int DP, bool kLoad>
__device__ __forceinline__ void core_rows(float* core, float* dst, int inner, int d, const int* tok) {
  auto at = [&](int t, int col) -> float& {
    const int h = col / d;
    return core[(h * kT + t) * DP + col - h * d];
  };
  auto row = [&](int t, int col) -> float& { return dst[static_cast<size_t>(tok[t]) * inner + col]; };
  if (kLoad)
    copy_row_col(kT, inner, [&](int t, int col) { return row(t, col); },
                 [&](int t, int col, float v) { at(t, col) = v; });
  else
    each_row_col(kT, inner, [&](int t, int col) { row(t, col) = at(t, col); });
}

// The forward, recomputed: a block per (group of windows, stream) writes what the backward
// reads of each window: LN1(x) and its statistics, q (scaled), k, v, AV, y, LN2(y) and the
// MLP hidden (header, step 2). kDrop: the window's keep words of every head (to a.keep too), AV
// from the dropped weights, y = x + drop(proj + bp); the hidden stays undropped (act' reads it).
// The hidden is act(z), under GELU z itself (activation.cuh).
template <int DP, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) block_fwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, inner = a.inner, hidden = a.hidden;
  const BwdLayout L = bwd_layout(kForward, C, inner, a.heads, DP, a.hc, a.cross != 0, kDrop);
  const int s = blockIdx.y;
  const int kvs = a.cross ? a.S - 1 - s : s;
  const int nwin = (a.H / 7) * (a.W / 7);
  const int hw = a.H * a.W;
  const size_t map = static_cast<size_t>(hw) * C;

  int* rows = reinterpret_cast<int*>(smem + L.tabs);
  int* region = rows + kRowsB;
  int* tok = region + kRowsB;
  int* col_ofs = tok + kRowsB;
  float* bqkv_s = reinterpret_cast<float*>(col_ofs + kColTable);
  float2* st = reinterpret_cast<float2*>(bqkv_s + kColTable);  // x, kv, y
  float* ring = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf);
  float* a1 = reinterpret_cast<float*>(smem + L.a1);
  float* a3 = reinterpret_cast<float*>(smem + L.a3);
  float* qkv_s = reinterpret_cast<float*>(smem + L.q);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + L.keep);  // kDrop: unit hashes, attention then proj
  int* slot = reinterpret_cast<int*>(ph + 2 * kRowsB);
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(smem + L.keep + align16(3 * kRowsB * 4));
  const swin::DropSite& attn_site = a.drop.site[swin::kSiteAttn];
  const swin::DropSite& proj_site = a.drop.site[swin::kSiteProj];
  const int words = a.heads * kT * swin::kKeepWords;

  zero_smem(smem, 0, L.total);  // the operands' padded channels stay finite zeros
  __syncthreads();
  fill_col_table<DP, false>(col_ofs, inner, a.d);
  for (int col = threadIdx.x; col < 3 * inner; col += kThreads) {
    const int part = (col >= inner) + (col >= 2 * inner);
    const float* bsrc = part == 0 ? a.bq : part == 1 ? a.bk : a.bv;
    bqkv_s[col] = bsrc[s * inner + col - part * inner];
  }

  for (int item = blockIdx.x; item < a.B * nwin; item += gridDim.x) {
    const int b = item / nwin, win = item - b * nwin;
    const size_t img = static_cast<size_t>(s) * a.B + b;      // (s, b)
    const size_t kv_img = static_cast<size_t>(kvs) * a.B + b;  // the image k/v come from
    __syncthreads();  // the previous window's readers are done
    window_setup(a, win, s, rows, region, tok, bias_s);
    if constexpr (kDrop) {
      for (int t = threadIdx.x; t < kT; t += kThreads) {
        int unused;
        ph[t] = swin::token_hash(attn_site, static_cast<int>(img), tok[t], &slot[t]);
        ph[kRowsB + t] = swin::token_hash(proj_site, static_cast<int>(img), tok[t], &unused);
      }
      __syncthreads();
      swin::attention_keep_words(attn_site, ph, slot, 0, a.heads, a.heads, keep_s);
    }
    copy_row_col(kT, C, [&](int t, int k) { return act(a.x, img * map + rows[t] + k, a.bf16); },
                 [&](int t, int k, float v) { xs[t * C + k] = v; });
    if (a.cross)
      copy_row_col(kT, C, [&](int t, int k) { return act(a.x, kv_img * map + rows[t] + k, a.bf16); },
                   [&](int t, int k, float v) { rowbuf[t * C + k] = v; });
    __syncthreads();
    if constexpr (kDrop) {
      uint32_t* keep = a.keep + (img * nwin + win) * words;
      for (int i = threadIdx.x; i < words; i += kThreads) keep[i] = keep_s[i];
    }
    ln_to_a<false>(xs, C, C, a.ln1g + s * C, a.ln1b + s * C, a1, st);
    float* a2 = reinterpret_cast<float*>(smem + L.a2);
    if (a.cross) ln_to_a<false>(rowbuf, C, C, a.ln1g + kvs * C, a.ln1b + kvs * C, a2, st + kRowsB);
    store_a(a1, C, a.lnx + img * map, C, tok);
    for (int t = threadIdx.x; t < kT; t += kThreads) reinterpret_cast<float2*>(a.stats1)[img * hw + tok[t]] = st[t];
    {  // q (scaled), k, v of every head
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
      with_tn(g.nb, [&](auto tn) {
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_tile<decltype(tn)::value, kRing>(acc, g, a1, a.cross ? a2 : a1, ring);
        zero_smem(smem, L.q, L.v + (L.k - L.q));  // q/k/v's padded dims, over LN1(kv) and the hidden
        __syncthreads();
        float* q_s = reinterpret_cast<float*>(smem + L.q);
        each(acc, g.nb, [&](int t, int col, float v) {
          const float u = v + bqkv_s[col];
          put_qkv<DP, false>(t, col, col < inner ? u * a.scale : u, inner, col_ofs, q_s,
                             reinterpret_cast<float*>(smem + L.k), smem + L.v);
        });
      });
    }
    __syncthreads();
    const size_t hofs = img * hw * inner;
    core_rows<DP, false>(qkv_s, a.q + hofs, inner, a.d, tok);
    core_rows<DP, false>(reinterpret_cast<float*>(smem + L.k), a.k + hofs, inner, a.d, tok);
    core_rows<DP, false>(reinterpret_cast<float*>(smem + L.v), a.v + hofs, inner, a.d, tok);
    attention_core<DP, false, kDrop>(qkv_s, reinterpret_cast<const float*>(smem + L.k), smem + L.v, nullptr, bias_s,
                                     a.heads, a.d, [&](int t, int col, float v) { a_at(a3, t, col) = v; }, keep_s,
                                     attn_site.scale);
    __syncthreads();
    store_a(a3, inner, a.o + hofs, inner, tok);
    with_tn(C, [&](auto tn) {  // y = x + (AV wp + bp), in place of x
      Tile<decltype(tn)::value> acc;
      zero_tile(acc);
      gemm_tile<decltype(tn)::value, kRing>(acc, weights(a.wp + static_cast<size_t>(s) * inner * C, C, C, inner),
                                            a3, a3, ring);
      const float* bp = a.bp + s * C;
      each(acc, C, [&](int t, int col, float v) {
        if constexpr (kDrop)
          xs[t * C + col] = xs[t * C + col] + swin::masked(swin::token_keep(proj_site, ph[kRowsB + t], slot[t], col, C),
                                                           v + bp[col], proj_site.scale);
        else
          xs[t * C + col] = xs[t * C + col] + (v + bp[col]);
      });
    });
    __syncthreads();
    each_row_col(kT, C, [&](int t, int k) { a.y[(img * hw + tok[t]) * C + k] = xs[t * C + k]; });
    ln_to_a<false>(xs, C, C, a.ln2g + s * C, a.ln2b + s * C, a1, st + 2 * kRowsB);  // LN2(y) over LN1(x)
    store_a(a1, C, a.lny + img * map, C, tok);
    float* h_s = reinterpret_cast<float*>(smem + L.u);
    const int hact = swin::recompute_code(a.act);
    for (int j0 = 0; j0 < hidden; j0 += a.hc) {  // h = act(LN2(y) w1 + b1) (GELU: z), hc columns at a time
      const int nh = min(a.hc, hidden - j0), nbh = round_up(nh, 4);
      const float* b1 = a.b1 + static_cast<size_t>(s) * hidden + j0;
      with_tn(nbh, [&](auto tn) {
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_tile<decltype(tn)::value, kRing>(
            acc, weights(a.w1 + static_cast<size_t>(s) * C * hidden + j0, nbh, hidden, C, nh), a1, a1, ring);
        each(acc, nh, [&](int t, int col, float v) { a_at(h_s, t, col) = swin::activate(hact, v + b1[col]); });
      });
      __syncthreads();
      store_a(h_s, nh, a.h + img * hw * hidden + j0, hidden, tok);
    }
  }
}

// The MLP's backward: a block per (group of 49-token tiles, stream), the tokens of a tile
// consecutive rows of x's layout (the MLP and LN2 work on rows): g_h = g w2^T, g_pre = g_h
// act'(z) (read from the stored hidden; under GELU the erf hidden replaces z there, w2's
// gradient reads it), g_lny += g_pre w1^T per hidden step, g_y = g + LN2'(g_lny) with its gamma/beta
// sums, g_o = g_y wp^T. kDrop: the g_h product's A is g_m = drop(g) (to a.gm too), g_pre =
// drop(g_m w2^T) act'(z) and the hidden dropped in place once its act' is read (w2's gradient
// reads it), g_y = g + LN2'(g_lny) with the undropped g, and g_o from g_proj = drop(g_y) (to
// a.gproj, g_y to a.gy).
template <bool kDrop = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) block_mlp_bwd_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, inner = a.inner, hidden = a.hidden;
  const BwdLayout L = bwd_layout(kMlp, C, inner, a.heads, 4, a.hc, a.cross != 0, kDrop);
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int tiles = a.B * a.H * a.W / kT;
  float2* st2 = reinterpret_cast<float2*>(smem + L.tabs);
  float* ln2_acc = reinterpret_cast<float*>(st2 + kRowsB);
  float* ring = reinterpret_cast<float*>(smem);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf);
  float* a1 = reinterpret_cast<float*>(smem + L.a1);
  float* ch = reinterpret_cast<float*>(smem + L.u);
  const float* gam = a.ln2g + s * C;
  const int cp = round_up(C, kKc);
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + L.keep);  // kDrop: unit hashes, proj, hidden, out
  int* slot = reinterpret_cast<int*>(ph + 3 * kRowsB);
  const swin::DropSite& proj_site = a.drop.site[swin::kSiteProj];
  const swin::DropSite& hid_site = a.drop.site[swin::kSiteHidden];
  const swin::DropSite& out_site = a.drop.site[swin::kSiteOut];

  zero_smem(smem, 0, L.total);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t r0 = static_cast<size_t>(s) * tiles * kT + static_cast<size_t>(tile) * kT;  // first row
    __syncthreads();
    if constexpr (kDrop) {  // the tile's tokens: image b, tokens tok0.. of its map
      const int hw = a.H * a.W, b = tile * kT / hw, tok0 = tile * kT - b * hw, n = s * a.B + b;
      for (int t = tid; t < kT; t += kThreads) {
        int unused;
        ph[t] = swin::token_hash(proj_site, n, tok0 + t, &slot[t]);
        ph[kRowsB + t] = swin::token_hash(hid_site, n, tok0 + t, &unused);
        ph[2 * kRowsB + t] = swin::token_hash(out_site, n, tok0 + t, &unused);
      }
      __syncthreads();
    }
    copy_row_col(kT, cp, [&](int t, int k) { return k < C ? act(a.g, (r0 + t) * C + k, a.bf16) : 0.0f; },
                 [&](int t, int k, float v) {
                   if constexpr (kDrop) {
                     v = swin::masked(swin::token_keep(out_site, ph[2 * kRowsB + t], slot[t], k, C), v, out_site.scale);
                     if (k < C) a.gm[(r0 + t) * C + k] = v;
                   }
                   a_at(a1, t, k) = v;
                 });
    for (int e = tid; e < kT * C; e += kThreads) {
      xs[e] = a.y[r0 * C + e];
      rowbuf[e] = 0.0f;
    }
    __syncthreads();
    row_stats(kT, C, [&](int t) { return xs + t * C; }, st2);
    for (int j0 = 0; j0 < hidden; j0 += a.hc) {
      const int nh = min(a.hc, hidden - j0), nbh = round_up(nh, 4);
      float* h = a.h + r0 * hidden + j0;
      with_tn(nbh, [&](auto tn) {  // g_pre = (g w2^T) act'(z)
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_tile<decltype(tn)::value, kRing>(
            acc, weights(a.w2T + static_cast<size_t>(s) * C * hidden + j0, nbh, hidden, C, nh), a1, a1, ring);
        each(acc, nh, [&](int t, int col, float v) {
          float* hp = h + static_cast<size_t>(t) * hidden + col;
          float hv = *hp;
          const float da = swin::act_grad(a.act, hv);  // GELU: hv becomes the erf hidden
          if constexpr (kDrop) {
            const bool keep = swin::token_keep(hid_site, ph[kRowsB + t], slot[t], j0 + col, hidden);
            a_at(ch, t, col) = swin::masked(keep, v, hid_site.scale) * da;
            *hp = swin::masked(keep, hv, hid_site.scale);
          } else {
            a_at(ch, t, col) = v * da;
            if (a.act == swin::kActGelu) *hp = hv;
          }
        });
      });
      __syncthreads();
      each_row_col(kT, nh, [&](int t, int col) { a.gpre[(r0 + t) * hidden + j0 + col] = a_at(ch, t, col); });
      with_tn(C, [&](auto tn) {  // g_lny += g_pre w1^T
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_tile<decltype(tn)::value, kRing>(
            acc, weights(a.w1T + (static_cast<size_t>(s) * hidden + j0) * C, C, C, nh), ch, ch, ring);
        each(acc, C, [&](int t, int col, float v) { rowbuf[t * C + col] += v; });
      });
    }
    __syncthreads();
    {  // g_y = g + LN2'(g_lny), in place of g; the gamma/beta sums
      const int lane8 = tid & 7;
      const unsigned mask = 0xffu << (tid & 24);
      auto sum8 = [&](float v) {
        for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
        return v;
      };
      for (int t = tid / 8; t < kT; t += kThreads / 8) {
        const float2 st = st2[t];
        float s1 = 0.0f, s2 = 0.0f;
        for (int k = lane8; k < C; k += 8) {
          const float gh = rowbuf[t * C + k] * gam[k], xh = (xs[t * C + k] - st.x) * st.y;
          s1 += gh;
          s2 = fmaf(gh, xh, s2);
        }
        s1 = sum8(s1) / C;
        s2 = sum8(s2) / C;
        for (int k = lane8; k < C; k += 8) {
          const float gh = rowbuf[t * C + k] * gam[k], xh = (xs[t * C + k] - st.x) * st.y;
          if constexpr (kDrop) {  // the residual takes the undropped g; g_o's A is g_proj
            const float gy = act(a.g, (r0 + t) * C + k, a.bf16) + st.y * (gh - s1 - xh * s2);
            const float gp =
                swin::masked(swin::token_keep(proj_site, ph[t], slot[t], k, C), gy, proj_site.scale);
            a_at(a1, t, k) = gp;
            a.gy[(r0 + t) * C + k] = gy;
            a.gproj[(r0 + t) * C + k] = gp;
          } else {
            const float gy = a_at(a1, t, k) + st.y * (gh - s1 - xh * s2);
            a_at(a1, t, k) = gy;
            a.gy[(r0 + t) * C + k] = gy;
          }
        }
      }
      for (int c = tid; c < C; c += kThreads) {
        float pg = 0.0f, pb = 0.0f;
        for (int t = 0; t < kT; ++t) {
          const float gl = rowbuf[t * C + c];
          pg = fmaf(gl, (xs[t * C + c] - st2[t].x) * st2[t].y, pg);
          pb += gl;
        }
        ln2_acc[c] += pg;
        ln2_acc[C + c] += pb;
      }
    }
    __syncthreads();
    with_tn(inner, [&](auto tn) {  // g_o = g_y wp^T, through rowbuf to token rows
      Tile<decltype(tn)::value> acc;
      zero_tile(acc);
      gemm_tile<decltype(tn)::value, kRing>(acc, weights(a.wpT + static_cast<size_t>(s) * C * inner, inner, inner, C),
                                            a1, a1, ring);
      each(acc, inner, [&](int t, int col, float v) { rowbuf[t * inner + col] = v; });
    });
    __syncthreads();
    for (int e = tid; e < kT * inner; e += kThreads) a.go[r0 * inner + e] = rowbuf[e];
  }
  __syncthreads();
  float* part = a.ln2_part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = tid; c < 2 * C; c += kThreads) part[c] = ln2_acc[c];
}

// The attention's backward: a block per (group of windows, stream) takes each window's q, k, v
// and g_o, runs window_bwd.cuh's core backward over every head (its bias-gradient sums in
// registers across the block's windows), writes g_q, g_k, g_v and g_ln = [g_q | g_k | g_v]
// [wq | wk | wv]^T, under cross the q side and the k/v side apart, the latter to the other
// stream's rows. kDrop: the window's keep words from a.keep (g_o is already g_proj wp^T); the
// core's backward with g_P masked and g_v from the dropped P.
template <int DP, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) block_bwd_attn_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, inner = a.inner, heads = a.heads;
  const BwdLayout L = bwd_layout(kAttention, C, inner, heads, DP, a.hc, a.cross != 0, kDrop);
  const int tid = threadIdx.x;
  const int s = blockIdx.y;
  const int kvs = a.cross ? a.S - 1 - s : s;
  const int nwin = (a.H / 7) * (a.W / 7);
  const int hw = a.H * a.W;
  const size_t map = static_cast<size_t>(hw) * C;

  int* rows = reinterpret_cast<int*>(smem + L.tabs);
  int* region = rows + kRowsB;
  int* tok = region + kRowsB;
  float* ring = reinterpret_cast<float*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* go_s = reinterpret_cast<float*>(smem + L.go);
  float* ch = reinterpret_cast<float*>(smem + L.u);
  float2* rd = reinterpret_cast<float2*>(smem + L.rd);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);

  zero_smem(smem, 0, L.total);  // the core layout's padded dims and the operands' channels
  float tab[kQuarter];
#pragma unroll
  for (int uu = 0; uu < kQuarter; ++uu) tab[uu] = 0.0f;

  for (int item = blockIdx.x; item < a.B * nwin; item += gridDim.x) {
    const int b = item / nwin, win = item - b * nwin;
    const size_t img = static_cast<size_t>(s) * a.B + b;
    const size_t kv_img = static_cast<size_t>(kvs) * a.B + b;
    __syncthreads();
    window_setup(a, win, s, rows, region, tok, bias_s);
    uint32_t* keep_s = reinterpret_cast<uint32_t*>(smem + L.keep);
    if constexpr (kDrop) {
      const int words = heads * kT * swin::kKeepWords;
      const uint32_t* keep = a.keep + (img * nwin + win) * words;
      for (int i = tid; i < words; i += kThreads) keep_s[i] = keep[i];
    }
    const size_t ofs = img * hw * inner;
    core_rows<DP, true>(q_s, a.q + ofs, inner, a.d, tok);
    core_rows<DP, true>(k_s, a.k + ofs, inner, a.d, tok);
    core_rows<DP, true>(v_s, a.v + ofs, inner, a.d, tok);
    core_rows<DP, true>(go_s, a.go + ofs, inner, a.d, tok);
    __syncthreads();
    const float drop_scale = a.drop.site[swin::kSiteAttn].scale;
    core_bwd_rows<DP, kDrop>(
        q_s, k_s, v_s, go_s, bias_s, heads, a.d, a.scale, rd, tab,
        [&](int t, int col, float v) { a_at(ch, t, col) = v; }, keep_s, drop_scale);
    __syncthreads();
    core_bwd_cols<DP, kDrop>(
        q_s, k_s, v_s, go_s, bias_s, heads, a.d, rd,
        [&](int u, int col, float gk, float gv) {
          a_at(ch, u, inner + col) = gk;
          a_at(ch, u, 2 * inner + col) = gv;
        },
        keep_s, drop_scale);
    __syncthreads();
    store_a(ch, inner, a.gq + ofs, inner, tok);
    store_a(ch + inner * kPitchF, inner, a.gk + ofs, inner, tok);
    store_a(ch + 2 * inner * kPitchF, inner, a.gv + ofs, inner, tok);
    Gemm g{};
    g.aparts = 1;
    g.n = g.nb = C;
    g.ldw = C;
    const float* wt = a.wqkvT + static_cast<size_t>(s) * 3 * inner * C;
    auto product = [&](const float* a0, int K, const float* w, float* dst) {
      g.w[0] = w;
      g.K = K;
      with_tn(C, [&](auto tn) {
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_tile<decltype(tn)::value, kRing>(acc, g, a0, a0, ring);
        each(acc, C, [&](int t, int col, float v) { rowbuf[t * C + col] = v; });
      });
      __syncthreads();
      each_row_col(kT, C, [&](int t, int k) { dst[static_cast<size_t>(tok[t]) * C + k] = rowbuf[t * C + k]; });
    };
    if (a.cross) {
      product(ch, inner, wt, a.glnq + img * map);
      __syncthreads();
      product(ch + inner * kPitchF, 2 * inner, wt + static_cast<size_t>(inner) * C, a.glnkv + kv_img * map);
    } else {
      product(ch, 3 * inner, wt, a.glnq + img * map);
    }
  }

  const int t = tid >> 2, qd = tid & 3;
  if (t < kT) {
    float* tp = a.tab_part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * kT * kT + t * kT;
#pragma unroll
    for (int uu = 0; uu < kQuarter; ++uu)
      if (qd * kQuarter + uu < kT) tp[qd * kQuarter + uu] = tab[uu];
  }
}

// ---- LN1 backward: g_x = g_y + LN1'(g_ln) over token rows --------------------------------
struct Ln1Args {
  const void* x;        // (S, M, C) TX
  const float* stats;   // (S, M, 2): mean, 1/std
  const float* gamma;   // (S, C)
  const float* glnq;    // (S, M, C): LN1(x)'s gradient; under cross its q side
  const float* glnkv;   // under cross the k/v side (the other stream's blocks wrote it)
  const float* gy;      // (S, M, C)
  void* gx;             // (S, M, C) TX
  float* part;          // (S, blocks, 2C): column sums of g * xhat, then of g
  int M, C;
};

// One warp per row, as window_core_bwd.cuh's ln_bwd_kernel. kCross: the row's gradient has
// two sides; kSplit (bf16 under cross): their input gradients are rounded apart, g_x =
// rnd(rnd(g_y + q side) + rnd(k/v side)); else the sides are summed first.
template <typename TX, bool kCross, bool kSplit>
__global__ void __launch_bounds__(kThreads) ln1_bwd_kernel(const Ln1Args p) {
  extern __shared__ float red[];  // [8 warps][2C]
  const int s = blockIdx.y, C = p.C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = static_cast<size_t>(s) * p.M;
  const TX* x = static_cast<const TX*>(p.x) + base * C;
  const float* gamma = p.gamma + s * C;
  float pg[kLnMaxPerLane] = {}, pb[kLnMaxPerLane] = {};
  const int row0 = blockIdx.x * kLn1Rows, row_end = min(p.M, row0 + kLn1Rows);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const float2 st = reinterpret_cast<const float2*>(p.stats)[base + r];
    const size_t off = (base + r) * C;
    float xh[kLnMaxPerLane], gh[kLnMaxPerLane], gh2[kLnMaxPerLane];
    float s1 = 0.0f, s2 = 0.0f, t1 = 0.0f, t2 = 0.0f;
#pragma unroll
    for (int e = 0; e < kLnMaxPerLane; ++e) {
      const int c = lane + 32 * e;
      xh[e] = gh[e] = gh2[e] = 0.0f;
      if (c < C) {
        float g1 = p.glnq[off + c];
        const float g2 = kCross ? p.glnkv[off + c] : 0.0f;
        const float gsum = g1 + g2;
        if (!kSplit) g1 = gsum;
        xh[e] = (to_f(x[r * static_cast<size_t>(C) + c]) - st.x) * st.y;
        gh[e] = g1 * gamma[c];
        s1 += gh[e];
        s2 = fmaf(gh[e], xh[e], s2);
        if (kSplit) {
          gh2[e] = g2 * gamma[c];
          t1 += gh2[e];
          t2 = fmaf(gh2[e], xh[e], t2);
        }
        pg[e] = fmaf(gsum, xh[e], pg[e]);
        pb[e] += gsum;
      }
    }
    s1 = swin::warp_sum(s1) / C;
    s2 = swin::warp_sum(s2) / C;
    if (kSplit) {
      t1 = swin::warp_sum(t1) / C;
      t2 = swin::warp_sum(t2) / C;
    }
    TX* gx = static_cast<TX*>(p.gx) + off;
#pragma unroll
    for (int e = 0; e < kLnMaxPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c < C) {
        const float v = p.gy[off + c] + st.y * (gh[e] - s1 - xh[e] * s2);
        if (kSplit) gx[c] = from_float<TX>(swin::round_bf16(v) + swin::round_bf16(st.y * (gh2[e] - t1 - xh[e] * t2)));
        else gx[c] = from_float<TX>(v);
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
  float* part = p.part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float sum = 0.0f;
    for (int w = 0; w < kWarps; ++w) sum += red[w * 2 * C + c];
    part[c] = sum;
  }
}

// ---- host side -------------------------------------------------------------------------
int pitch_for(int d) { return d <= 4 ? 4 : d <= 8 ? 8 : 0; }

// Whether this route takes the dimensions (ops/fused_block.py::block_bwd_plan makes the same
// checks and routes every other shape to fused_block.cu's backward); drop: the dropout form.
bool supported(int C, int inner, int heads, int d, int hidden, int hc, bool cross, bool drop) {
  if (pitch_for(d) == 0 || inner != heads * d || C % 8 != 0 || inner % 8 != 0 || hidden % 4 != 0) return false;
  if (3 * inner > kMaxCols || 3 * inner > kColTable || C > kMaxCols || hc < 4 || hc % 4 != 0 || hc > kMaxCols ||
      hc > hidden)
    return false;
  for (int kernel : {kForward, kMlp, kAttention})
    if (bwd_layout(kernel, C, inner, heads, pitch_for(d), hc, cross, drop).total > kSmemMax) return false;
  return true;
}

// Workspace of one call, carved in this order (ops/fused_block.py::bwd_workspace_floats
// mirrors it); with base == nullptr the walk sizes it.
struct BwdScratch {
  float *wqkvT, *wpT, *w1T, *w2T, *lnx, *stats1, *q, *k, *v, *o, *y, *gy, *go, *lny, *h, *gpre, *gq, *gk, *gv,
      *glnq, *glnkv;
  float *tab_part, *ln2_part, *ln1_part, *wg_part;
  float *gm, *gproj;  // the dropout form: drop(g), drop(g_y)
  uint32_t* keep;     // the dropout form: the keep words of every (image, window, head)
  int chunk_rows, chunks;  // of the weight-gradient launch
};

int ln1_blocks(int M) { return (M + kLn1Rows - 1) / kLn1Rows; }

// blocks: blocks per stream of the forward, MLP and attention halves; drop: the dropout form's
// pieces after the others.
BwdScratch carve(swin::Arena& ar, int S, int B, int H, int W, int C, int heads, int inner, int hidden,
                 const int* blocks, bool cross, bool drop) {
  BwdScratch sc;
  const int M = B * H * W;
  const size_t SM = static_cast<size_t>(S) * M;
  sc.wqkvT = ar.take(static_cast<size_t>(S) * 3 * inner * C);
  sc.wpT = ar.take(static_cast<size_t>(S) * C * inner);
  sc.w1T = ar.take(static_cast<size_t>(S) * hidden * C);
  sc.w2T = ar.take(static_cast<size_t>(S) * C * hidden);
  sc.lnx = ar.take(SM * C);
  sc.stats1 = ar.take(SM * 2);
  sc.q = ar.take(SM * inner);
  sc.k = ar.take(SM * inner);
  sc.v = ar.take(SM * inner);
  sc.o = ar.take(SM * inner);
  sc.y = ar.take(SM * C);
  sc.gy = ar.take(SM * C);
  sc.go = ar.take(SM * inner);
  sc.lny = ar.take(SM * C);
  sc.h = ar.take(SM * hidden);
  sc.gpre = ar.take(SM * hidden);
  sc.gq = ar.take(SM * inner);
  sc.gk = ar.take(SM * inner);
  sc.gv = ar.take(SM * inner);
  sc.glnq = ar.take(SM * C);
  sc.glnkv = cross ? ar.take(SM * C) : nullptr;
  sc.tab_part = ar.take(static_cast<size_t>(S) * blocks[kAttention] * kT * kT);
  sc.ln2_part = ar.take(static_cast<size_t>(S) * blocks[kMlp] * 2 * C);
  sc.ln1_part = ar.take(static_cast<size_t>(S) * ln1_blocks(M) * 2 * C);
  sc.chunk_rows = wg_chunk_rows(M, kWgPerStream * S);
  sc.chunks = (M + sc.chunk_rows - 1) / sc.chunk_rows;
  size_t per_chunk = 0;
  for (int job = 0; job < kWgPerStream; ++job) {
    int ka, nb;
    wg_shape(job, C, inner, hidden, &ka, &nb);
    per_chunk += static_cast<size_t>(ka + 1) * nb;
  }
  sc.wg_part = ar.take(S * sc.chunks * per_chunk);
  sc.gm = drop ? ar.take(SM * C) : nullptr;
  sc.gproj = drop ? ar.take(SM * C) : nullptr;
  const size_t words = static_cast<size_t>(S) * B * (H / 7) * (W / 7) * heads * kT * swin::kKeepWords;
  sc.keep = drop ? reinterpret_cast<uint32_t*>(ar.take(words)) : nullptr;
  return sc;
}

template <typename Fn>
cudaError_t launch_blocks(Fn kernel, int blocks, int smem, const BwdArgs& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, a.S), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename TX>
int block_bwd(const float* const* in, float* const* out, float* ws, const swin::DropArgs* drop, int S, int B, int H,
              int W, int C, int heads, int d, int hidden, int hc, const int* blocks, int shift, int cross, int windows,
              float scale, int act, cudaStream_t st) {
  const int inner = heads * d;
  const int M = B * H * W;
  const bool dropping = drop != nullptr;
  swin::Arena ar{ws};
  const BwdScratch sc = carve(ar, S, B, H, W, C, heads, inner, hidden, blocks, cross != 0, dropping);
  launch_transposes(in, sc.wqkvT, sc.wpT, sc.w1T, sc.w2T, S, C, inner, hidden, st);

  BwdArgs a = {in[kX], in[kG], in[kLn1g], in[kLn1b], in[kWq], in[kBq], in[kWk], in[kBk], in[kWv],
                     in[kBv], in[kWp], in[kBp], in[kBias], in[kLn2g], in[kLn2b], in[kW1], in[kB1], in[kW2],
                     in[kB2], sc.wqkvT, sc.wpT, sc.w1T, sc.w2T, sc.lnx, sc.stats1, sc.q, sc.k, sc.v, sc.o, sc.y,
                     sc.lny, sc.h, sc.gpre, sc.gy, sc.go, sc.gq, sc.gk, sc.gv, sc.glnq, sc.glnkv, sc.tab_part,
                     sc.ln2_part,
                     S, B, H, W, C, inner, heads, d, hidden, hc, shift ? 4 : 0, shift ? 4 : 0, cross, scale,
                     windows != 0, std::is_same<TX, bf16>::value};
  a.act = act;
  if (dropping) {
    a.drop = swin::block_drop(drop, H * W, B);
    a.keep = sc.keep;
    a.gm = sc.gm;
    a.gproj = sc.gproj;
  }
  const int dp = pitch_for(d);
  int smem[3];
  for (int kernel : {kForward, kMlp, kAttention})
    smem[kernel] = bwd_layout(kernel, C, inner, heads, dp, hc, cross != 0, dropping).total;
  cudaError_t err;
  if (dropping) {
    err = dp == 4 ? launch_blocks(block_fwd_kernel<4, true>, blocks[kForward], smem[kForward], a, st)
                  : launch_blocks(block_fwd_kernel<8, true>, blocks[kForward], smem[kForward], a, st);
    if (err == cudaSuccess) err = launch_blocks(block_mlp_bwd_kernel<true>, blocks[kMlp], smem[kMlp], a, st);
    if (err == cudaSuccess)
      err = dp == 4 ? launch_blocks(block_bwd_attn_kernel<4, true>, blocks[kAttention], smem[kAttention], a, st)
                    : launch_blocks(block_bwd_attn_kernel<8, true>, blocks[kAttention], smem[kAttention], a, st);
  } else {
    err = dp == 4 ? launch_blocks(block_fwd_kernel<4>, blocks[kForward], smem[kForward], a, st)
                  : launch_blocks(block_fwd_kernel<8>, blocks[kForward], smem[kForward], a, st);
    if (err == cudaSuccess) err = launch_blocks(block_mlp_bwd_kernel<false>, blocks[kMlp], smem[kMlp], a, st);
    if (err == cudaSuccess)
      err = dp == 4 ? launch_blocks(block_bwd_attn_kernel<4>, blocks[kAttention], smem[kAttention], a, st)
                    : launch_blocks(block_bwd_attn_kernel<8>, blocks[kAttention], smem[kAttention], a, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  // the LN1 backward: g_x = g_y + LN1'(g_ln), rounded as the header says, with its gamma/beta
  // partials
  constexpr bool kBf16 = std::is_same<TX, bf16>::value;
  const Ln1Args ln = {in[kX], sc.stats1, in[kLn1g], sc.glnq, sc.glnkv, sc.gy, out[0], sc.ln1_part, M, C};
  const dim3 ln_grid(ln1_blocks(M), S);
  const size_t ln_smem = static_cast<size_t>(kWarps) * 2 * C * sizeof(float);
  if (!cross) ln1_bwd_kernel<TX, false, false><<<ln_grid, kThreads, ln_smem, st>>>(ln);
  else if (kBf16) ln1_bwd_kernel<TX, true, true><<<ln_grid, kThreads, ln_smem, st>>>(ln);
  else ln1_bwd_kernel<TX, true, false><<<ln_grid, kThreads, ln_smem, st>>>(ln);

  // wp's gradient reads g_proj and w2's g_m (and the dropped hidden) in the dropout form
  const Tail t = {dropping ? sc.gproj : sc.gy, sc.lnx, sc.o, sc.lny, sc.h, sc.gpre, sc.gq, sc.gk, sc.gv, sc.tab_part,
                  sc.ln2_part, sc.ln1_part, sc.wg_part, sc.chunk_rows, sc.chunks, blocks[kAttention], blocks[kMlp],
                  ln1_blocks(M), sc.gm};
  return launch_tail<TX>(in, out, t, S, M, C, inner, hidden, cross != 0, st);
}

}  // namespace

extern "C" {

// swin_cuda_error_string comes with window_core.cuh.

// Dynamic shared memory in bytes of one block of the forward (kind 0), MLP-backward (1) or
// attention-backward (2) kernel, or 0 where this route does not take the dimensions (hc:
// hidden columns per MLP step; drop: the dropout form).
size_t swin_block_bwd_smem(int kind, int C, int heads, int d, int hidden, int hc, int cross, int drop) {
  if (kind < kForward || kind > kAttention || !supported(C, heads * d, heads, d, hidden, hc, cross != 0, drop != 0))
    return 0;
  return static_cast<size_t>(bwd_layout(kind, C, heads * d, heads, pitch_for(d), hc, cross != 0, drop != 0).total);
}

// Floats of workspace one call needs; blocks: blocks per stream of the three kernels; drop: the
// dropout form.
size_t swin_block_bwd_workspace(int S, int B, int H, int W, int C, int heads, int d, int hidden, int fwd_blocks,
                                int mlp_blocks, int attn_blocks, int cross, int drop) {
  const int blocks[3] = {fwd_blocks, mlp_blocks, attn_blocks};
  swin::Arena ar{nullptr};
  carve(ar, S, B, H, W, C, heads, heads * d, hidden, blocks, cross != 0, drop != 0);
  return ar.used;
}

// The block's backward on `stream`. in: x, the 17 weights in the forward's order, then g =
// dL/d out (same shape as x); out: g_x, then the 17 weight gradients in that order and shapes.
// x, g and g_x are fp32, or bf16 when `bf16_io` is set (fp32 inside, K1 and K4 alike); the
// weights and their gradients fp32. `drop`: the forward's dropout arguments (the dropout form,
// ops/dropout_layout.py's keying for the layout), or nullptr for none. Layout as swin_k4_fwd's
// (`windows`); 7x7 windows. hc: hidden columns per MLP step; fwd_blocks, mlp_blocks,
// attn_blocks: blocks per stream of the three block kernels; ws: ws_floats floats of
// workspace, at least swin_block_bwd_workspace(..., drop != nullptr). Every output is written
// in full. Returns cudaGetLastError() after the launches (0 = ok), cudaErrorInvalidValue on
// dimensions this route does not take or a workspace too small.
int swin_block_bwd(const float* const* in, float* const* out, float* ws, size_t ws_floats,
                   const swin::DropArgs* drop, int S, int B, int H, int W, int C, int heads, int d, int hidden, int hc,
                   int fwd_blocks, int mlp_blocks, int attn_blocks, int shift, int cross, int windows, int bf16_io,
                   float scale, int act, void* stream) {
  const int blocks[3] = {fwd_blocks, mlp_blocks, attn_blocks};
  const bool dropping = drop != nullptr;
  if (H % 7 != 0 || W % 7 != 0 || S < 1 || S > 2 || (cross && S != 2) || fwd_blocks < 1 || mlp_blocks < 1 ||
      attn_blocks < 1 || !supported(C, heads * d, heads, d, hidden, hc, cross != 0, dropping) || !swin::activation_ok(act) ||
      ws_floats < swin_block_bwd_workspace(S, B, H, W, C, heads, d, hidden, fwd_blocks, mlp_blocks, attn_blocks,
                                           cross, dropping))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_io ? block_bwd<bf16>(in, out, ws, drop, S, B, H, W, C, heads, d, hidden, hc, blocks, shift, cross,
                                   windows, scale, act, st)
                 : block_bwd<float>(in, out, ws, drop, S, B, H, W, C, heads, d, hidden, hc, blocks, shift, cross,
                                    windows, scale, act, st);
}

}  // extern "C"
