// Fused pre-norm Swin block, the backward without dropout, fp32 and bf16, redesigned for
// Hopper (sm_90a): the split route, in both layouts of fused_block.cu (K4 bwd on the image,
// K1 bwd on window-packed tokens), for the shapes whose window does not fit one block of
// fused_block_bwd.cu's fused route. The function is fused_block_bwd.cu's (its header): g_x and
// every weight's gradient from x, the 17 weights and g; fp32 inside in both dtypes; a bf16 g_x
// under cross rnd(rnd(g_y + LN1'(q side)) + rnd(LN1'(k/v side))); the softmax clamp at 80 not
// differentiated. ops/fused_block.py::block_bwd_plan routes the default model's stages 2-4
// here (d = 12, 24 and 48), with and without dropout; other head widths (d = 13-16, 25-32)
// keep fused_block.cu's backward.
//
// Where a window's blocks do not fit one block's shared memory (C = 96, 192 and 384 in the
// default model, stages 2-4), the backward runs on kernels sized to each step, eleven launches:
//   1. transpose_kernel (block_bwd.cuh), as the fused route;
//   2-6. the forward recomputed on fused_block_fwd.cu's split route (block_fwd.cuh), fp32
//      inside in both dtypes (K1's fp32 block, never K4 bf16's rounding): k4_ln_kernel (LN1(x)
//      and its statistics), K3's split attention block (window_fwd.cuh's k3_attention_kernel,
//      AV window-major), k4_rows_kernel (y = x + AV wp + bp, fp32), k4_ln_kernel<kLn2> (LN2(y),
//      into a scratch of its own: LN1(x) stays for the attention's backward), k4_fc1_kernel
//      (the hidden); fc2 is not recomputed, neither backward needs it;
//   7. split_mlp_bwd_kernel: g_pre and g_y = g + LN2'(g_lny) over 49-token tiles, the g_lny
//      products in column groups of at most kMaxCols; at pitch 48 (C = 384, whose block holds
//      one an SM: 20 tiles a stream at 448² batch 5) stepped: a block per (tile, hidden step)
//      writing that step's g_lny, then split_ln2_bwd_kernel sums the steps in step order and
//      runs the LN2 backward (one launch more);
//   8. K3's split-route block (k3_bwd.cuh's k3_bwd_kernel<DP, false>, a block per group of
//      windows, stream and group of heads, as ops/window_attention.py::bwd_plan groups them) on
//      the stored LN1(x) as its x and g_y as its g: it recomputes q/k/v, AV and g_o = g_y wp^T,
//      runs the core backward (the bias-table gradient summed in registers; at d = 48
//      window_bwd.cuh's core_bwd_tiled) and writes AV, g_q, g_k and g_v to token rows;
//   9. gln_ln1_kernel: g_ln = [g_q | g_k | g_v] [wq | wk | wv]^T over 49-token tiles, under
//      cross its q side and its k/v side apart, and the LN1 backward in its epilogue; grouped
//      at pitch 48, a block per (tile, column group) writing its columns
//      of g_ln, then split_ln1_bwd_kernel runs the LN1 backward (one launch more);
//   10-11. one weight-gradient launch (with kWgRect's rectangles at these widths, the rows cut
//      for about sixteen working blocks an SM) and one reduction (block_bwd.cuh's tail, as
//      the fused route's).
// fp32 FMA throughout (TF32 off), no atomics: every sum runs in a fixed order, and the blocks
// of each kernel that walks a list come from the caller (one wave of the card's SMs), so two
// calls on one card give the same bits.
// Dropout: the same eleven launches in their kDrop forms (fused_block_bwd.cu's header says
// which gradient each site masks): K3's attention block recomputes AV from the dropped weights
// and writes every head's keep words for K3's backward block, k4_rows_kernel adds drop(proj +
// bp), split_mlp_bwd_kernel<true> masks g, the hidden and g_y as block_mlp_bwd_kernel<true>
// does, and K3's block k3_bwd_kernel<DP, false, true> runs on g = g_proj with those keep words
// (its AV, which wp's gradient reads, the dropped one).

#include "block_bwd.cuh"
#include "block_fwd.cuh"
#include "k3_bwd.cuh"

namespace {

using namespace wbwd;
using namespace bbwd;

// The split route's MLP backward: a block per (group of 49-token tiles, stream), as
// block_mlp_bwd_kernel but for rows of up to C = 384: y is read from device memory where the
// LN2 statistics and backward need it, so that g (resident, the g_h products' A), the g_lny
// sums [49][C] and the hidden step's g_pre fit two blocks an SM at C = 96 (one at C = 192 and
// at C = 384, 224 KB there); the g_lny products run in column groups of at most kMaxCols
// (k3bwd::gx_width: 128 at C = 384); no g_o (the K3 block forms it from g_y). Writes g_pre,
// g_y and the LN2 gamma/beta partials. kDrop: as fused_block_bwd.cu's
// block_mlp_bwd_kernel<true>: g_m = drop(g) as the g_h product's A (to gm), g_pre = drop(g_m
// w2^T) act'(z) with the hidden dropped in place after its act' is read, g_y with the undropped g
// as its residual, and g_proj = drop(g_y) beside it (K3's block reads it as its g).
struct MlpArgs {
  const void* g;                                // dL/d out, (S, M, C) fp32 or bf16
  const float *ln2g, *w1T, *w2T, *y;            // (S, C); per stream (hidden, C), (C, hidden); y
  float* h;                                     // the hidden, (S, M, hidden) (kDrop: dropped in place)
  float *gpre, *gy, *ln2_part;                  // (S, M, hidden), (S, M, C), (S, blocks, 2C)
  int B, H, W, C, hidden, hc, bf16;
  swin::BlockDrop drop;                         // kDrop: the call's sites
  float *gm, *gproj;                            // kDrop: drop(g), drop(g_y), (S, M, C)
  int steps;                                    // 1, or the hidden steps each a block (stepped)
  float* glny;                                  // stepped: g_lny of each step, (steps, S, M, C)
  int act;                                      // the MLP's activation (activation.cuh)
};

// The epilogue of the MLP backward for one 49-token tile (rows r0.. of y): g_y = g +
// LN2'(g_lny) (kDrop: with the undropped g, and g_proj = drop(g_y) beside it; g_of(t, k): the
// residual g of the form without dropout) and the tile's LN2 gamma/beta sums added to ln2_acc.
template <bool kDrop, typename GOf>
__device__ __forceinline__ void ln2_epilogue(const MlpArgs& a, size_t r0, const float* y, const float* rowbuf,
                                             const float2* st2, float* ln2_acc, const float* gam, const uint32_t* ph,
                                             const int* slot, GOf g_of) {
  const int C = a.C, tid = threadIdx.x;
  const swin::DropSite& proj_site = a.drop.site[swin::kSiteProj];
  const int lane8 = tid & 7;
  const unsigned mask = 0xffu << (tid & 24);
  auto sum8 = [&](float v) {
    for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
    return v;
  };
  for (int t = tid / 8; t < kT; t += kThreads / 8) {
    const float2 st = st2[t];
    const float* yr = y + static_cast<size_t>(t) * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane8; k < C; k += 8) {
      const float gh = rowbuf[t * C + k] * gam[k], xh = (yr[k] - st.x) * st.y;
      s1 += gh;
      s2 = fmaf(gh, xh, s2);
    }
    s1 = sum8(s1) / C;
    s2 = sum8(s2) / C;
    for (int k = lane8; k < C; k += 8) {
      const float gh = rowbuf[t * C + k] * gam[k], xh = (yr[k] - st.x) * st.y;
      if constexpr (kDrop) {  // the residual takes the undropped g
        const float gy = act(a.g, (r0 + t) * C + k, a.bf16) + st.y * (gh - s1 - xh * s2);
        a.gy[(r0 + t) * C + k] = gy;
        a.gproj[(r0 + t) * C + k] =
            swin::masked(swin::token_keep(proj_site, ph[t], slot[t], k, C), gy, proj_site.scale);
      } else {
        a.gy[(r0 + t) * C + k] = g_of(t, k) + st.y * (gh - s1 - xh * s2);
      }
    }
  }
  for (int c = tid; c < C; c += kThreads) {
    float pg = 0.0f, pb = 0.0f;
    for (int t = 0; t < kT; ++t) {
      const float gl = rowbuf[t * C + c];
      pg = fmaf(gl, (y[static_cast<size_t>(t) * C + c] - st2[t].x) * st2[t].y, pg);
      pb += gl;
    }
    ln2_acc[c] += pg;
    ln2_acc[C + c] += pb;
  }
}

// drop: the tokens' unit hashes at the proj, hidden and out sites and their slots, after the
// tables.
struct SplitMlpLayout {
  int rowbuf, a1, u, tabs, keep, total;
};

__host__ __device__ inline SplitMlpLayout split_mlp_layout(int C, int hc, bool drop = false) {
  SplitMlpLayout L{};
  L.rowbuf = align16(b_bytes(false, max2(k3bwd::gx_width(C), round_up(hc, 4)), kRing));
  L.a1 = L.rowbuf + align16(kT * C * 4);
  L.u = L.a1 + align16(a_bytes(false, C));
  L.tabs = L.u + align16(a_bytes(false, round_up(hc, 4)));
  L.keep = L.tabs + align16(kRowsB * 8 + 2 * C * 4);
  L.total = L.keep + (drop ? align16(4 * kRowsB * 4) : 0);
  return L;
}

// Stepped (a.steps > 1: at pitch 48, split_mlp_steps): a block per (group of tiles, stream, hidden step), each writing its step's g_lny product to
// a.glny, and split_ln2_bwd_kernel the epilogue, which sums the steps in step order.
template <bool kDrop = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) split_mlp_bwd_kernel(const MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, hidden = a.hidden, tid = threadIdx.x, s = blockIdx.y;
  const bool stepped = a.steps > 1;
  const int j_begin = stepped ? blockIdx.z * a.hc : 0, j_end = stepped ? min(hidden, j_begin + a.hc) : hidden;
  const SplitMlpLayout L = split_mlp_layout(C, a.hc, kDrop);
  const int tiles = a.B * a.H * a.W / kT, cw = k3bwd::gx_width(C), cp = round_up(C, kKc);
  float* ring = reinterpret_cast<float*>(smem);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf);
  float* a1 = reinterpret_cast<float*>(smem + L.a1);
  float* ch = reinterpret_cast<float*>(smem + L.u);
  float2* st2 = reinterpret_cast<float2*>(smem + L.tabs);
  float* ln2_acc = reinterpret_cast<float*>(st2 + kRowsB);
  const float* gam = a.ln2g + s * C;
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + L.keep);  // kDrop: unit hashes, proj, hidden, out
  int* slot = reinterpret_cast<int*>(ph + 3 * kRowsB);
  const swin::DropSite& proj_site = a.drop.site[swin::kSiteProj];
  const swin::DropSite& hid_site = a.drop.site[swin::kSiteHidden];
  float* glny = stepped ? a.glny + static_cast<size_t>(blockIdx.z) * gridDim.y * tiles * kT * C : nullptr;
  const swin::DropSite& out_site = a.drop.site[swin::kSiteOut];

  zero_smem(smem, 0, L.total);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t r0 = static_cast<size_t>(s) * tiles * kT + static_cast<size_t>(tile) * kT;  // first row
    const float* y = a.y + r0 * C;
    __syncthreads();  // the previous tile's readers are done
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
                     if (k < C && j_begin == 0) a.gm[(r0 + t) * C + k] = v;
                   }
                   a_at(a1, t, k) = v;
                 });
    if (!stepped) {
      for (int e = tid; e < kT * C; e += kThreads) rowbuf[e] = 0.0f;
      row_stats(kT, C, [&](int t) { return y + static_cast<size_t>(t) * C; }, st2);
    }
    __syncthreads();
    for (int j0 = j_begin; j0 < j_end; j0 += a.hc) {
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
      for (int c0 = 0; c0 < C; c0 += cw) {  // g_lny += g_pre w1^T, a column group at a time
        const int nc = min(cw, C - c0);
        with_tn(cw, [&](auto tn) {
          Tile<decltype(tn)::value> acc;
          zero_tile(acc);
          gemm_tile<decltype(tn)::value, kRing>(
              acc, weights(a.w1T + (static_cast<size_t>(s) * hidden + j0) * C + c0, cw, C, nh, nc), ch, ch, ring);
          each(acc, nc, [&](int t, int col, float v) {
            if (stepped) glny[(r0 + t) * C + c0 + col] = v;
            else rowbuf[t * C + c0 + col] += v;
          });
        });
      }
    }
    if (stepped) continue;  // split_ln2_bwd_kernel sums the steps
    __syncthreads();
    ln2_epilogue<kDrop>(a, r0, y, rowbuf, st2, ln2_acc, gam, ph, slot, [&](int t, int k) { return a_at(a1, t, k); });
  }
  if (stepped) return;
  __syncthreads();
  float* part = a.ln2_part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = tid; c < 2 * C; c += kThreads) part[c] = ln2_acc[c];
}

// The stepped MLP backward's epilogue: a block per (group of 49-token tiles, stream), the tiles
// and blocks of split_mlp_bwd_kernel's, each tile's g_lny the sum of its steps' products in step
// order from 0 (as the unstepped kernel adds them), its y statistics, then ln2_epilogue and the
// block's LN2 gamma/beta partials. kDrop: the proj site's unit hashes for g_proj.
struct SplitLn2Layout {
  int tabs, keep, total;  // rowbuf [49][C] at 0
};

__host__ __device__ inline SplitLn2Layout split_ln2_layout(int C, bool drop = false) {
  SplitLn2Layout L{};
  L.tabs = align16(kT * C * 4);
  L.keep = L.tabs + align16(kRowsB * 8 + 2 * C * 4);
  L.total = L.keep + (drop ? align16(2 * kRowsB * 4) : 0);
  return L;
}

template <bool kDrop = false>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) split_ln2_bwd_kernel(const MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, tid = threadIdx.x, s = blockIdx.y;
  const SplitLn2Layout L = split_ln2_layout(C, kDrop);
  const int tiles = a.B * a.H * a.W / kT;
  const size_t plane = static_cast<size_t>(gridDim.y) * tiles * kT * C;  // one step's g_lny
  float* rowbuf = reinterpret_cast<float*>(smem);
  float2* st2 = reinterpret_cast<float2*>(smem + L.tabs);
  float* ln2_acc = reinterpret_cast<float*>(st2 + kRowsB);
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + L.keep);  // kDrop: the proj site's unit hashes
  int* slot = reinterpret_cast<int*>(ph + kRowsB);
  const float* gam = a.ln2g + s * C;

  zero_smem(smem, 0, L.total);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t r0 = static_cast<size_t>(s) * tiles * kT + static_cast<size_t>(tile) * kT;  // first row
    const float* y = a.y + r0 * C;
    __syncthreads();  // the previous tile's readers are done
    if constexpr (kDrop) {
      const int hw = a.H * a.W, b = tile * kT / hw, tok0 = tile * kT - b * hw, n = s * a.B + b;
      for (int t = tid; t < kT; t += kThreads)
        ph[t] = swin::token_hash(a.drop.site[swin::kSiteProj], n, tok0 + t, &slot[t]);
    }
    for (int e = 4 * tid; e < kT * C; e += 4 * kThreads) {  // C is a multiple of 8: 16-byte pieces
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int j = 0; j < a.steps; ++j) {
        const float4 p = *reinterpret_cast<const float4*>(a.glny + j * plane + r0 * C + e);
        v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
      }
      *reinterpret_cast<float4*>(rowbuf + e) = v;
    }
    row_stats(kT, C, [&](int t) { return y + static_cast<size_t>(t) * C; }, st2);
    __syncthreads();
    ln2_epilogue<kDrop>(a, r0, y, rowbuf, st2, ln2_acc, gam, ph, slot,
                        [&](int t, int k) { return act(a.g, (r0 + t) * C + k, a.bf16); });
  }
  __syncthreads();
  float* part = a.ln2_part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = tid; c < 2 * C; c += kThreads) part[c] = ln2_acc[c];
}

// The split route's g_ln product with the LN1 backward in its epilogue: a block per (group of
// 49-token tiles, stream) forms g_ln = [g_q | g_k' | g_v'] [wq | wk' | wv']^T for each tile (as
// k3_bwd.cuh's gx_kernel forms K3's g_x: the q side from the stream's g_q, the k/v side from
// the k/v stream's g_k, g_v and weights, A streamed through a ring, in column groups of at
// most kMaxCols) into rows of C in shared memory, under cross its q side and its k/v side
// apart, then g_x = g_y + LN1'(g_ln) of each row (rounded as the header says; kSplit: bf16
// under cross, the sides' input gradients rounded apart) and the tile's LN1 gamma/beta sums,
// added in the block in tile order.
struct GlnLayout {
  int ring_b, rowq, rowkv, tabs, total;
};

__host__ __device__ inline GlnLayout gln_layout(int C, bool cross) {
  GlnLayout L{};
  L.ring_b = ring_a_bytes(false, 1, kRing);
  L.rowq = align16(L.ring_b + b_bytes(false, k3bwd::gx_width(C), kRing));
  L.rowkv = L.rowq + align16(kT * C * 4);
  L.tabs = L.rowkv + (cross ? align16(kT * C * 4) : 0);
  L.total = L.tabs + align16(kRowsB * 4 + kRowsB * 8 + 2 * C * 4);
  return L;
}

struct GlnArgs {
  const void* x;                            // (S, M, C) TX
  const float *stats, *gamma, *gy;          // LN1's (mean, 1/std) (S, M, 2); (S, C); (S, M, C)
  const float *gq, *gk, *gv, *wqkvT;        // (S, M, inner) each; per stream (3 inner, C)
  void* gx;                                 // (S, M, C) TX
  float* part;                              // (S, blocks, 2C): column sums of g_ln * xhat, then of g_ln
  int S, M, C, inner;
  int groups;                               // 1, or the column groups each a block (grouped)
  float* gln;                               // grouped: g_ln's q side (or both), then its k/v side, (2, S, M, C)
};

// The g_x epilogue of one 49-token tile (rows r0.. of x): g_x = g_y + LN1'(g_ln) from g_ln's
// rows (rowq; under cross its q side, rowkv the k/v side) and the LN1 statistics st, eight
// lanes a row, rounded as the header says; the tile's LN1 gamma/beta sums added to sums.
template <typename TX, bool kCross, bool kSplit>
__device__ __forceinline__ void ln1_epilogue(const GlnArgs& a, size_t r0, const float* rowq, const float* rowkv,
                                             const float2* st, float* sums, const float* gamma) {
  const int C = a.C, tid = threadIdx.x;
  const TX* x = static_cast<const TX*>(a.x);
  {  // g_x = g_y + LN1'(g_ln), eight lanes a row
    const int lane8 = tid & 7;
    const unsigned mask = 0xffu << (tid & 24);
    auto sum8 = [&](float v) {
      for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
      return v;
    };
    for (int t = tid / 8; t < kT; t += kThreads / 8) {
      const float2 sv = st[t];
      const TX* xr = x + (r0 + t) * C;
      auto sides = [&](int k, float& xh, float& g1, float& g2) {
        xh = (to_f(xr[k]) - sv.x) * sv.y;
        g1 = rowq[t * C + k];
        g2 = kCross ? rowkv[t * C + k] : 0.0f;
        if (!kSplit) g1 += g2;
      };
      float s1 = 0.0f, s2 = 0.0f, t1 = 0.0f, t2 = 0.0f;
      for (int k = lane8; k < C; k += 8) {
        float xh, g1, g2;
        sides(k, xh, g1, g2);
        const float gh = g1 * gamma[k];
        s1 += gh;
        s2 = fmaf(gh, xh, s2);
        if (kSplit) {
          const float gh2 = g2 * gamma[k];
          t1 += gh2;
          t2 = fmaf(gh2, xh, t2);
        }
      }
      s1 = sum8(s1) / C;
      s2 = sum8(s2) / C;
      if (kSplit) {
        t1 = sum8(t1) / C;
        t2 = sum8(t2) / C;
      }
      TX* gx = static_cast<TX*>(a.gx) + (r0 + t) * C;
      for (int k = lane8; k < C; k += 8) {
        float xh, g1, g2;
        sides(k, xh, g1, g2);
        const float v = a.gy[(r0 + t) * C + k] + sv.y * (g1 * gamma[k] - s1 - xh * s2);
        if (kSplit)
          gx[k] = from_float<TX>(swin::round_bf16(v) + swin::round_bf16(sv.y * (g2 * gamma[k] - t1 - xh * t2)));
        else
          gx[k] = from_float<TX>(v);
      }
    }
  }
  for (int c = tid; c < C; c += kThreads) {  // the tile's gamma/beta sums, in row order
    float pg = 0.0f, pb = 0.0f;
    for (int t = 0; t < kT; ++t) {
      const float gl = rowq[t * C + c] + (kCross ? rowkv[t * C + c] : 0.0f);
      pg = fmaf(gl, (to_f(x[(r0 + t) * C + c]) - st[t].x) * st[t].y, pg);
      pb += gl;
    }
    sums[c] += pg;
    sums[C + c] += pb;
  }
}

// Grouped (a.groups > 1: at pitch 48, split_gln_groups): a block per (group of tiles, stream, column group), each writing its columns of g_ln to a.gln,
// and split_ln1_bwd_kernel the epilogue.
template <typename TX, bool kCross, bool kSplit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) gln_ln1_kernel(const GlnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, inner = a.inner, tid = threadIdx.x, s = blockIdx.y;
  const int kvs = kCross ? a.S - 1 - s : s;
  const GlnLayout L = gln_layout(C, kCross);
  const int width = k3bwd::gx_width(C), tiles = a.M / kT;
  const bool grouped = a.groups > 1;
  const int cg_begin = grouped ? blockIdx.z * width : 0, cg_end = grouped ? min(C, cg_begin + width) : C;
  float* ring = reinterpret_cast<float*>(smem);
  float* bring = reinterpret_cast<float*>(smem + L.ring_b);
  float* rowq = reinterpret_cast<float*>(smem + L.rowq);
  float* rowkv = reinterpret_cast<float*>(smem + L.rowkv);
  int* rows = reinterpret_cast<int*>(smem + L.tabs);
  float2* st = reinterpret_cast<float2*>(rows + kRowsB);
  float* sums = reinterpret_cast<float*>(st + kRowsB);
  const float* gamma = a.gamma + s * C;

  zero_smem(smem, 0, L.total);
  __syncthreads();
  for (int t = tid; t < kRowsB; t += kThreads) rows[t] = t < kT ? t * inner : 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t r0 = static_cast<size_t>(s) * a.M + static_cast<size_t>(tile) * kT;    // first row
    const size_t kv0 = static_cast<size_t>(kvs) * a.M + static_cast<size_t>(tile) * kT;  // its k/v side's
    __syncthreads();  // the previous tile's readers are done
    for (int t = tid; t < kT; t += kThreads) st[t] = reinterpret_cast<const float2*>(a.stats)[r0 + t];
    for (int cg0 = cg_begin; cg0 < cg_end; cg0 += width) {
      const int ncols = min(width, C - cg0);
      with_tn(width, [&](auto tn) {
        constexpr int TN = decltype(tn)::value;
        auto part = [&](Tile<TN>& acc, const float* src, int sw, int p) {
          Gemm gm{};
          gm.abase[0] = src;
          gm.aparts = 1;
          gm.rows = rows;
          gm.w[0] = a.wqkvT + (static_cast<size_t>(sw) * 3 + p) * inner * C + cg0;
          gm.n = gm.nb = width;
          gm.ldw = C;
          gm.K = inner;
          gm.ncols = ncols;
          gemm_stream<TN>(acc, gm, ring, bring, 0);
        };
        Tile<TN> acc;
        zero_tile(acc);
        part(acc, a.gq + r0 * inner, s, 0);
        each(acc, ncols, [&](int t, int col, float v) { rowq[t * C + cg0 + col] = v; });
        zero_tile(acc);
        part(acc, a.gk + kv0 * inner, kvs, 1);
        part(acc, a.gv + kv0 * inner, kvs, 2);
        each(acc, ncols, [&](int t, int col, float v) {
          if (kCross) rowkv[t * C + cg0 + col] = v;
          else rowq[t * C + cg0 + col] += v;
        });
      });
    }
    __syncthreads();
    if (grouped) {  // this group's columns of g_ln (both sides under cross) for split_ln1_bwd_kernel
      const size_t plane = static_cast<size_t>(a.S) * a.M * C;
      each_row_col(kT, cg_end - cg_begin, [&](int t, int k) {
        a.gln[(r0 + t) * C + cg_begin + k] = rowq[t * C + cg_begin + k];
        if (kCross) a.gln[plane + (r0 + t) * C + cg_begin + k] = rowkv[t * C + cg_begin + k];
      });
      continue;
    }
    ln1_epilogue<TX, kCross, kSplit>(a, r0, rowq, rowkv, st, sums, gamma);
  }
  if (grouped) return;
  __syncthreads();
  float* part = a.part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = tid; c < 2 * C; c += kThreads) part[c] = sums[c];
}

// The grouped g_ln product's epilogue: a block per (group of 49-token tiles, stream), the tiles
// and blocks of gln_ln1_kernel's, each tile's g_ln rows (both sides under cross) and LN1
// statistics into shared memory, then ln1_epilogue and the block's LN1 gamma/beta partials.
struct SplitLn1Layout {
  int rowkv, tabs, total;  // rowq [49][C] at 0
};

__host__ __device__ inline SplitLn1Layout split_ln1_layout(int C, bool cross) {
  SplitLn1Layout L{};
  L.rowkv = align16(kT * C * 4);
  L.tabs = L.rowkv + (cross ? align16(kT * C * 4) : 0);
  L.total = L.tabs + align16(kRowsB * 8 + 2 * C * 4);
  return L;
}

template <typename TX, bool kCross, bool kSplit>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) split_ln1_bwd_kernel(const GlnArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, tid = threadIdx.x, s = blockIdx.y, tiles = a.M / kT;
  const SplitLn1Layout L = split_ln1_layout(C, kCross);
  const size_t plane = static_cast<size_t>(a.S) * a.M * C;
  float* rowq = reinterpret_cast<float*>(smem);
  float* rowkv = reinterpret_cast<float*>(smem + L.rowkv);
  float2* st = reinterpret_cast<float2*>(smem + L.tabs);
  float* sums = reinterpret_cast<float*>(st + kRowsB);
  const float* gamma = a.gamma + s * C;

  zero_smem(smem, 0, L.total);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t r0 = static_cast<size_t>(s) * a.M + static_cast<size_t>(tile) * kT;  // first row
    __syncthreads();  // the previous tile's readers are done
    for (int t = tid; t < kT; t += kThreads) st[t] = reinterpret_cast<const float2*>(a.stats)[r0 + t];
    for (int e = 4 * tid; e < kT * C; e += 4 * kThreads) {  // C is a multiple of 8: 16-byte pieces
      *reinterpret_cast<float4*>(rowq + e) = *reinterpret_cast<const float4*>(a.gln + r0 * C + e);
      if (kCross)
        *reinterpret_cast<float4*>(rowkv + e) = *reinterpret_cast<const float4*>(a.gln + plane + r0 * C + e);
    }
    __syncthreads();
    ln1_epilogue<TX, kCross, kSplit>(a, r0, rowq, rowkv, st, sums, gamma);
  }
  __syncthreads();
  float* part = a.part + (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * 2 * C;
  for (int c = tid; c < 2 * C; c += kThreads) part[c] = sums[c];
}

// The split route's q/k row pitches: the default model's stages 2-4 (d = 12, 24 and 48), each
// d rounded up as the forward's pitches round it; other heads go to fused_block.cu's backward
// (ops/fused_block.py::SPLIT_PITCHES).
int split_pitch(int d) { return d > 8 && d <= 12 ? 12 : d > 16 && d <= 24 ? 24 : d > 32 && d <= 48 ? 48 : 0; }

// The hidden columns of the recompute's fc1 blocks (fused_block_fwd.cu's split route).
constexpr int kFc1Cols = k4fwd::max_cols(false);

// Dynamic shared memory of the split route's kernel `kind`: 0 the recomputed attention, 1 the
// projection rows, 2 the fc1, 3 the MLP backward, 4 K3's backward block, 5 the g_ln product
// with the LN1 backward, 6 the stepped MLP backward's LN2 epilogue, 7 the grouped g_ln
// product's LN1 epilogue; drop: the dropout form (the attention's hashes and keep words, the
// MLP backward's and the LN2 epilogue's hashes, K3's block's keep words).
int split_smem(int kind, int C, int inner, int d, int hidden, int hc, int hg_fwd, int hg_bwd, bool cross,
               bool drop = false) {
  const int dp = split_pitch(d);
  switch (kind) {
    case 0:
      return attention_layout(false, false, cross, C, inner, hg_fwd, d, dp).total +
             (drop ? drop_attention_bytes(hg_fwd) : 0);
    case 1: return k4fwd::k4_layout(k4fwd::kRows, false, cross, C, inner, hidden, hg_fwd, d, dp, kFc1Cols).total;
    case 2: return k4fwd::k4_layout(k4fwd::kFc1, false, cross, C, inner, hidden, hg_fwd, d, dp, kFc1Cols).total;
    case 3: return split_mlp_layout(C, hc, drop).total;
    case 4: return k3bwd::bwd_layout(false, cross, C, inner, hg_bwd, d, dp, drop).total;
    case 5: return gln_layout(C, cross).total;
    case 6: return split_ln2_layout(C, drop).total;
    case 7: return split_ln1_layout(C, cross).total;
    default: return 0;
  }
}
constexpr int kSplitKinds = 8;

// The blocks a 49-token tile of the MLP backward and of the g_ln product: at pitch 48 (C = 384,
// whose MLP backward holds one block an SM) a block each hidden step (stepped) and each column
// group (grouped); one at the other pitches, which keep their bits.
int split_mlp_steps(int d, int hidden, int hc) { return split_pitch(d) == 48 ? (hidden + hc - 1) / hc : 1; }
int split_gln_groups(int d, int C) {
  return split_pitch(d) == 48 ? (C + k3bwd::gx_width(C) - 1) / k3bwd::gx_width(C) : 1;
}

// Whether the split route takes the dimensions (ops/fused_block.py::block_bwd_plan makes the
// same checks): hg_fwd heads a block of the recomputed attention, hg_bwd of K3's backward
// block (each at most 48 columns a q/k/v part, a multiple of 8), hc hidden columns per MLP
// step, and every block within a block's shared memory (drop: in the dropout form).
bool split_supported(int C, int inner, int heads, int d, int hidden, int hc, int hg_fwd, int hg_bwd, bool cross,
                     bool drop) {
  if (split_pitch(d) == 0 || inner != heads * d || C % 8 != 0 || inner % 8 != 0 || hidden % 4 != 0 || C > 384)
    return false;
  if (hc < 4 || hc % 4 != 0 || hc > kMaxCols || hc > hidden) return false;
  for (int hg : {hg_fwd, hg_bwd}) {
    const int n = hg * d;
    if (hg < 1 || heads % hg != 0 || n % 8 != 0 || n > 48 || 3 * n > kMaxCols || 3 * n > kColTable) return false;
  }
  for (int kind = 0; kind < kSplitKinds; ++kind)
    if (split_smem(kind, C, inner, d, hidden, hc, hg_fwd, hg_bwd, cross, drop) > kSmemMax) return false;
  for (int b : {wg_smem(C, inner), wg_smem(inner, C), wg_smem(C, hidden), wg_smem(hidden, C)})
    if (b > kSmemMax) return false;
  return true;
}

// The workspace of one split-route call, carved in this order (ops/fused_block.py::
// split_workspace_floats mirrors it). av holds the recompute's AV window-major until the
// projection has read it, then K3's block writes AV to token rows into it.
struct SplitScratch {
  float *wqkvT, *wpT, *w1T, *w2T, *lnx, *stats1, *av, *y, *lny, *h, *gpre, *gy, *gq, *gk, *gv;
  float *tab_part, *ln2_part, *ln1_part, *wg_part;
  float *gm, *gproj;  // the dropout form: drop(g), drop(g_y)
  uint32_t* keep;     // the dropout form: the keep words of every (image, window, head)
  float* glny;        // the stepped MLP backward: each step's g_lny, (steps, S, M, C)
  float* gln;         // the grouped g_ln product: g_ln's q side (or both), its k/v side, (2, S, M, C)
  int chunk_rows, chunks;  // of the weight-gradient launch
};

// The blocks of one chunk of rows that do work in a stream's weight-gradient jobs (the
// launch's grid gives every job as many as the widest; the rest return at once): the chunks
// are cut for about sixteen working blocks an SM, two waves of the eight that fit (faster than
// one wave on an H100: 28.38 against 28.87 ms over the split route's calls of a 224² batch-20
// step, split_bwd_ab.py).
int wg_working_blocks(int C, int inner, int hidden) {
  int n = 0;
  for (int job = 0; job < kWgPerStream; ++job) {
    int ka, nb;
    wg_shape(job, C, inner, hidden, &ka, &nb);
    n += wg_groups_of_tiles(ka, nb);
  }
  return n;
}

// groups: heads / hg_bwd; blocks: per stream of the MLP backward, per (stream, group) of K3's
// block, per stream of the g_ln product, then the MLP backward's steps and the g_ln product's
// column groups a tile (1: unstepped, ungrouped); windows: per stream, of every image; drop: the
// dropout form's pieces after the others, then the stepped and grouped forms' buffers.
SplitScratch carve_split(swin::Arena& ar, int S, int M, int C, int heads, int inner, int hidden, int groups,
                         const int* blocks, int windows, bool drop) {
  SplitScratch sc;
  const size_t SM = static_cast<size_t>(S) * M;
  sc.wqkvT = ar.take(static_cast<size_t>(S) * 3 * inner * C);
  sc.wpT = ar.take(static_cast<size_t>(S) * C * inner);
  sc.w1T = ar.take(static_cast<size_t>(S) * hidden * C);
  sc.w2T = ar.take(static_cast<size_t>(S) * C * hidden);
  sc.lnx = ar.take(SM * C);
  sc.stats1 = ar.take(SM * 2);
  sc.av = ar.take(SM * inner);
  sc.y = ar.take(SM * C);
  sc.lny = ar.take(SM * C);
  sc.h = ar.take(SM * hidden);
  sc.gpre = ar.take(SM * hidden);
  sc.gy = ar.take(SM * C);
  sc.gq = ar.take(SM * inner);
  sc.gk = ar.take(SM * inner);
  sc.gv = ar.take(SM * inner);
  sc.tab_part = ar.take(static_cast<size_t>(S) * groups * blocks[1] * kT * kT);
  sc.ln2_part = ar.take(static_cast<size_t>(S) * blocks[0] * 2 * C);
  sc.ln1_part = ar.take(static_cast<size_t>(S) * blocks[2] * 2 * C);
  sc.chunk_rows = wg_chunk_rows(M, max2(1, S * wg_working_blocks(C, inner, hidden) / 2));
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
  const size_t words = static_cast<size_t>(S) * windows * heads * kT * swin::kKeepWords;
  sc.keep = drop ? reinterpret_cast<uint32_t*>(ar.take(words)) : nullptr;
  sc.glny = blocks[3] > 1 ? ar.take(static_cast<size_t>(blocks[3]) * SM * C) : nullptr;
  sc.gln = blocks[4] > 1 ? ar.take(2 * SM * C) : nullptr;
  return sc;
}

template <typename Kernel, typename KernelArgs>
cudaError_t launch_grid(Kernel kernel, dim3 grid, int smem, const KernelArgs& a, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// blocks: per stream of the MLP backward, per (stream, group of hg_bwd heads) of K3's block,
// per stream of the g_ln product; then the MLP backward's blocks a tile (1, or its hidden steps:
// stepped, with the LN2 epilogue's launch after it) and the g_ln product's (1, or its column
// groups: grouped, with the LN1 epilogue's launch after it).
template <int DP, typename TX>
int block_bwd_split(const float* const* in, float* const* out, float* ws, const swin::DropArgs* drop, int S, int B,
                    int H, int W, int C, int heads, int d, int hidden, int hc, int hg_fwd, int hg_bwd,
                    const int* blocks, int shift, int cross, int windows, float scale, int act, cudaStream_t st) {
  const int inner = heads * d, M = B * H * W, groups = heads / hg_bwd, nb = S * B;
  const int nwin = (H / 7) * (W / 7), top = shift ? 4 : 0;
  const bool kv = cross != 0, dropping = drop != nullptr;
  auto smem = [&](int kind) { return split_smem(kind, C, inner, d, hidden, hc, hg_fwd, hg_bwd, kv, dropping); };
  swin::Arena ar{ws};
  const SplitScratch sc = carve_split(ar, S, M, C, heads, inner, hidden, groups, blocks, B * nwin, dropping);
  const swin::BlockDrop sites = dropping ? swin::block_drop(drop, H * W, B) : swin::BlockDrop{};
  launch_transposes(in, sc.wqkvT, sc.wpT, sc.w1T, sc.w2T, S, C, inner, hidden, st);

  // the forward, recomputed (fp32 inside): LN1(x) and its statistics, AV, y, LN2(y), the hidden
  k4fwd::K4Args f = {in[kX], in[kLn1g], in[kLn1b], in[kWq], in[kBq], in[kWk], in[kBk], in[kWv], in[kBv], in[kWp],
                     in[kBp], in[kBias], in[kLn2g], in[kLn2b], in[kW1], in[kB1], in[kW2], in[kB2], nullptr, sc.lnx,
                     sc.av, sc.y, sc.h, S, B, H, W, C, inner, heads, d, hidden, hg_fwd, kFc1Cols, top, top, cross,
                     scale, windows != 0, sc.stats1, sites, swin::recompute_code(act)};
  const unsigned ln_blocks =
      static_cast<unsigned>((static_cast<size_t>(nb) * H * W + kThreads / 8 - 1) / (kThreads / 8));
  k4fwd::k4_ln_kernel<TX, false, false, true><<<ln_blocks, kThreads, 0, st>>>(f);
  const Args k3f = {sc.lnx, in[kWq], in[kBq], in[kWk], in[kBk], in[kWv], in[kBv], in[kWp], in[kBp], in[kBias],
                    nullptr, sc.av, S, B, H, W, C, inner, heads, d, hg_fwd, top, top, cross, scale, windows != 0,
                    sites.site[swin::kSiteAttn], sc.keep};
  const dim3 attn_grid(nwin, nb, heads / hg_fwd);
  cudaError_t err = dropping ? launch_grid(k3_attention_kernel<DP, false, false, true>, attn_grid, smem(0), k3f, st)
                             : launch_grid(k3_attention_kernel<DP, false, false>, attn_grid, smem(0), k3f, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_groups = (C + kProjCols - 1) / kProjCols, tiles = H * W / kT;
  const dim3 rows_grid(nwin, nb, col_groups);
  err = dropping ? launch_grid(k4fwd::k4_rows_kernel<TX, false, false, true>, rows_grid, smem(1), f, st)
                 : launch_grid(k4fwd::k4_rows_kernel<TX, false, false>, rows_grid, smem(1), f, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  f.ln = sc.lny;  // LN2(y) beside LN1(x), which the attention's backward reads
  k4fwd::k4_ln_kernel<TX, false, true><<<ln_blocks, kThreads, 0, st>>>(f);
  err = launch_grid(k4fwd::k4_fc1_kernel<false>, dim3(tiles, nb, (hidden + kFc1Cols - 1) / kFc1Cols), smem(2), f,
                    st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the MLP and LN2 backward: g_pre, g_y (stepped: a block a hidden step, then the LN2 epilogue)
  const int steps = blocks[3];
  const MlpArgs a = {in[kG], in[kLn2g], sc.w1T, sc.w2T, sc.y, sc.h, sc.gpre, sc.gy, sc.ln2_part,
                     B, H, W, C, hidden, hc, std::is_same<TX, bf16>::value, sites, sc.gm, sc.gproj, steps, sc.glny,
                     act};
  const dim3 mlp_grid(blocks[0], S, steps);
  err = dropping ? launch_grid(split_mlp_bwd_kernel<true>, mlp_grid, smem(3), a, st)
                 : launch_grid(split_mlp_bwd_kernel<false>, mlp_grid, smem(3), a, st);
  if (err == cudaSuccess && steps > 1)
    err = dropping ? launch_grid(split_ln2_bwd_kernel<true>, dim3(blocks[0], S), smem(6), a, st)
                   : launch_grid(split_ln2_bwd_kernel<false>, dim3(blocks[0], S), smem(6), a, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  // the attention's backward: K3's split-route block on (LN1(x), g_y), then g_ln and LN1's
  // backward; the dropout form's block takes g_proj = drop(g_y) and the recompute's keep words
  const k3bwd::BwdArgs k3 = {sc.lnx, dropping ? sc.gproj : sc.gy, in[kWq], in[kBq], in[kWk], in[kBk], in[kWv],
                             in[kBv], in[kBias], sc.wpT, sc.wqkvT, sc.av, sc.gq, sc.gk, sc.gv, nullptr, nullptr,
                             nullptr, sc.tab_part, S, B, H, W, C, inner, d, hg_bwd, top, top, cross, scale,
                             windows != 0, 0, sc.keep, sites.site[swin::kSiteAttn].scale};
  const dim3 k3_grid(blocks[1], S, groups);
  err = dropping ? launch_grid(k3bwd::k3_bwd_kernel<DP, false, true>, k3_grid, smem(4), k3, st)
                 : launch_grid(k3bwd::k3_bwd_kernel<DP, false>, k3_grid, smem(4), k3, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const GlnArgs gl = {in[kX], sc.stats1, in[kLn1g], sc.gy, sc.gq, sc.gk, sc.gv, sc.wqkvT, out[0], sc.ln1_part,
                      S, M, C, inner, blocks[4], sc.gln};
  const dim3 gl_grid(blocks[2], S, blocks[4]), ln1_grid(blocks[2], S);
  const bool grouped = blocks[4] > 1;
  auto gln = [&](auto product, auto epilogue) {
    cudaError_t e = launch_grid(product, gl_grid, smem(5), gl, st);
    return e == cudaSuccess && grouped ? launch_grid(epilogue, ln1_grid, smem(7), gl, st) : e;
  };
  if (!kv) err = gln(gln_ln1_kernel<TX, false, false>, split_ln1_bwd_kernel<TX, false, false>);
  else if constexpr (std::is_same<TX, bf16>::value)  // under cross a bf16 g_x's sides are rounded apart
    err = gln(gln_ln1_kernel<TX, true, true>, split_ln1_bwd_kernel<TX, true, true>);
  else err = gln(gln_ln1_kernel<TX, true, false>, split_ln1_bwd_kernel<TX, true, false>);
  if (err != cudaSuccess) return static_cast<int>(err);

  // wp's gradient reads g_proj and w2's g_m (and the dropped hidden) in the dropout form
  const Tail t = {dropping ? sc.gproj : sc.gy, sc.lnx, sc.av, sc.lny, sc.h, sc.gpre, sc.gq, sc.gk, sc.gv, sc.tab_part,
                  sc.ln2_part, sc.ln1_part, sc.wg_part, sc.chunk_rows, sc.chunks, groups * blocks[1], blocks[0],
                  blocks[2], sc.gm};
  return launch_tail<TX>(in, out, t, S, M, C, inner, hidden, kv, st);
}

template <typename TX>
int split_pitch_launch(int dp, const float* const* in, float* const* out, float* ws, const swin::DropArgs* drop,
                       int S, int B, int H, int W, int C, int heads, int d, int hidden, int hc, int hg_fwd,
                       int hg_bwd, const int* blocks, int shift, int cross, int windows, float scale, int act,
                       cudaStream_t st) {
  switch (dp) {
#define SWIN_SPLIT_CASE(P)                                                                                         \
  case P:                                                                                                          \
    return block_bwd_split<P, TX>(in, out, ws, drop, S, B, H, W, C, heads, d, hidden, hc, hg_fwd, hg_bwd, blocks, \
                                  shift, cross, windows, scale, act, st);
    SWIN_SPLIT_CASE(12)
    SWIN_SPLIT_CASE(24)
    SWIN_SPLIT_CASE(48)
#undef SWIN_SPLIT_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// swin_cuda_error_string comes with window_core.cuh.

// Dynamic shared memory in bytes of one block of the split route's kernel `kind` (0 the
// recomputed attention, 1 its projection rows, 2 its fc1, 3 the MLP backward, 4 K3's backward
// block, 5 the g_ln product with the LN1 backward, 6 the stepped MLP backward's LN2 epilogue, 7
// the grouped g_ln product's LN1 epilogue), or 0 where the split route does not take
// the dimensions (hc: hidden columns per MLP step; hg_fwd, hg_bwd: heads a block of the
// recomputed attention and of K3's backward block; drop: the dropout form).
size_t swin_block_bwd_split_smem(int kind, int C, int heads, int d, int hidden, int hc, int hg_fwd, int hg_bwd,
                                 int cross, int drop) {
  if (kind < 0 || kind >= kSplitKinds ||
      !split_supported(C, heads * d, heads, d, hidden, hc, hg_fwd, hg_bwd, cross != 0, drop != 0))
    return 0;
  return static_cast<size_t>(split_smem(kind, C, heads * d, d, hidden, hc, hg_fwd, hg_bwd, cross != 0, drop != 0));
}

// Floats of workspace one split-route call needs; mlp_blocks: blocks per stream of the MLP
// backward; k3_blocks: per (stream, group of hg_bwd heads) of K3's block; gln_blocks: per stream
// of the g_ln product; hc: hidden columns per MLP step; drop: the dropout form.
size_t swin_block_bwd_split_workspace(int S, int B, int H, int W, int C, int heads, int d, int hidden, int hc,
                                      int hg_bwd, int mlp_blocks, int k3_blocks, int gln_blocks, int drop) {
  const int blocks[5] = {mlp_blocks, k3_blocks, gln_blocks, split_mlp_steps(d, hidden, hc), split_gln_groups(d, C)};
  swin::Arena ar{nullptr};
  carve_split(ar, S, B * H * W, C, heads, heads * d, hidden, heads / hg_bwd, blocks, B * (H / 7) * (W / 7),
              drop != 0);
  return ar.used;
}

// The block's backward on the split route (eleven launches, with or without dropout, and at
// pitch 48 the LN2 and LN1 epilogues'; the header of the split route above). Arguments as
// swin_block_bwd's, `drop` included, with hg_fwd and hg_bwd the heads a block of the recomputed
// attention and of K3's backward block, mlp_blocks, k3_blocks and gln_blocks the blocks per
// stream of the MLP backward, per (stream, group of heads) of K3's block and per stream of the
// g_ln product, and ws at least swin_block_bwd_split_workspace(..., drop != nullptr) floats.
// Returns cudaGetLastError() after the launches (0 = ok), cudaErrorInvalidValue on dimensions
// this route does not take or a workspace too small.
int swin_block_bwd_split(const float* const* in, float* const* out, float* ws, size_t ws_floats,
                         const swin::DropArgs* drop, int S, int B, int H, int W, int C, int heads, int d, int hidden,
                         int hc, int hg_fwd, int hg_bwd, int mlp_blocks, int k3_blocks, int gln_blocks, int shift,
                         int cross, int windows, int bf16_io, float scale, int act, void* stream) {
  const int blocks[5] = {mlp_blocks, k3_blocks, gln_blocks, split_mlp_steps(d, hidden, hc), split_gln_groups(d, C)};
  const bool dropping = drop != nullptr;
  if (H % 7 != 0 || W % 7 != 0 || S < 1 || S > 2 || (cross && S != 2) || mlp_blocks < 1 || k3_blocks < 1 ||
      gln_blocks < 1 || !split_supported(C, heads * d, heads, d, hidden, hc, hg_fwd, hg_bwd, cross != 0, dropping) ||
      !swin::activation_ok(act) ||
      ws_floats < swin_block_bwd_split_workspace(S, B, H, W, C, heads, d, hidden, hc, hg_bwd, mlp_blocks, k3_blocks,
                                                 gln_blocks, dropping))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = split_pitch(d);
  return bf16_io ? split_pitch_launch<bf16>(dp, in, out, ws, drop, S, B, H, W, C, heads, d, hidden, hc, hg_fwd,
                                            hg_bwd, blocks, shift, cross, windows, scale, act, st)
                 : split_pitch_launch<float>(dp, in, out, ws, drop, S, B, H, W, C, heads, d, hidden, hc, hg_fwd,
                                             hg_bwd, blocks, shift, cross, windows, scale, act, st);
}

}  // extern "C"
