// K3's backward blocks, shared by window_attention_bwd.cu (K3 bwd without dropout) and the
// split route of fused_block_bwd_split.cu (K1 bwd and K4 bwd at stages 2-4, which runs
// k3_bwd_kernel<DP, false> on the stored LN1(x) and g_y): the block kernel (a block per group
// of windows, stream and group of heads recomputes q/k/v, g_o and AV and runs window_bwd.cuh's
// core backward), its shared-memory layout and arguments, and the split route's g_x kernel
// with its layout and column groups (gx_width, which fused_block_bwd.cu's split route uses
// for its own products of C columns). The block's kDrop form (k3_bwd_kernel<DP, kFused, true>)
// masks the attention weights: with a.keep set it reads the keep words that a recompute wrote
// (the split route of K1's and K4's dropout backward), else it hashes them itself once a window
// and head (K3's dropout backward, window_attention_bwd.cu). Above a row pitch of
// kPassesPitchMax (d = 48, stage 4) the block runs window_bwd.cuh's core_bwd_tiled, which forms
// AV too, in place of attention_core and core_bwd. window_attention_bwd.cu's header says what
// bounds them and why the design is so.

#pragma once

#include "window_bwd.cuh"
#include "window_core_bwd.cuh"

namespace k3bwd {

using namespace wbwd;

constexpr int kRing = 2;  // ring slots of every product

// Blocks an SM of the block kernel (its register bound): two up to a q/k row pitch of 16, one
// from 24 on. At 24 core_bwd's rows pass holds three rows of DP floats a lane and its columns
// pass four; above kPassesPitchMax core_bwd_tiled needs far fewer, but the block's streamed
// q/k/v product and g_o product alone spill at two blocks' 128 registers (so do the pitches up
// to 16, ~300-570 bytes), and at one block's 255 the block spills nothing.
__host__ __device__ constexpr int min_blocks(int dp) { return dp >= 24 ? 1 : 2; }

// Byte offsets of the block kernel's dynamic shared memory (ops/window_attention.py::bwd_smem
// mirrors them): the A ring (x, and under cross the kv rows; then g) and the weight ring at
// ring_b, over which the fused route keeps g_q | g_k | g_v resident after the core; q, k, v,
// g_o in the core layout [hg][49][DP] (the fused route's g_x products put their weight ring
// and a row buffer over them after the core); the rows pass's (1/sum, dot); the window's bias
// with the wrap mask as -inf; the row, region and token tables, the q/k/v column offsets and
// biases; above kPassesPitchMax, core_bwd_tiled's P and g_S rows of one head last.
struct BwdLayout {
  int ring_b, q, k, v, go, rd, bias, tabs, keep, ps, total;
};

// drop: the dropout form's keep words of the group's heads after the tables ([hg][T][2]); t:
// the any-window class's T (tokens()).
__host__ __device__ inline BwdLayout bwd_layout(bool fused, bool cross, int C, int inner, int hg, int d, int dp,
                                                bool drop = false, int t = kT) {
  const int T = tokens(t);
  BwdLayout L{};
  const int n = hg * d;
  const int qkv = align16(hg * T * dp * 4);
  L.ring_b = ring_a_bytes(false, cross ? 2 : 1, kRing);
  const int ring = L.ring_b + b_bytes(false, 3 * n, kRing);
  int off = align16(max2(ring, fused ? a_bytes(false, 3 * inner) : 0));
  L.q = off;
  L.k = off + qkv;
  L.v = off + 2 * qkv;
  L.go = off + 3 * qkv;
  off += max2(4 * qkv, fused ? align16(b_bytes(false, C, kRing)) + align16(T * C * 4) : 0);
  L.rd = off;
  off += align16(hg * T * 8);
  L.bias = off;
  off += align16(T * T * 4);
  L.tabs = off;
  off += align16((3 * kRowsB + 2 * kColTable) * 4);
  L.keep = off;
  if (drop) off += align16(hg * T * swin::kKeepWords * 4);
  L.ps = off;
  if (dp > kPassesPitchMax) off += tiled_core_bytes();
  L.total = off;
  return L;
}

struct BwdArgs {
  const void* x;  // (S, B, H, W, C) fp32 or bf16
  const void* g;  // dL/d out, same
  const float *wq, *bq, *wk, *bk, *wv, *bv, *bias;
  const float *wpT, *wqkvT;  // per stream (C, inner), (3 inner, C)
  float *av, *gq, *gk, *gv;  // (S, B*H*W, inner) token rows
  void* gx;                  // fused self: g_x, in x's type
  float *gxq, *gxkv;         // fused cross: its q side and k/v side, (S, B*H*W, C)
  float* tab_part;           // (S, groups, blocks, T*T)
  int S, B, H, W, C, inner, d, hg, top, left, cross;
  float scale;
  int windows;  // the token layout that window_rows reads: 0, the image
  int bf16;     // x, g and g_x bf16 (else fp32)
  // kDrop: the keep words of every (image, window, head), (S*B, windows, heads, T, 2), as the
  // recomputed forward wrote them, or nullptr for the block to hash them at `drop` (the
  // attention site, K3's keying); and the attention site's scale
  const uint32_t* keep;
  float drop_scale;
  swin::DropSite drop;
  int wh, ww, t;  // the any-window class's window and its tokens (window_hw(), tokens())
};

// Element i of x's type (fp32, or bf16 rounded once) from an fp32 value.
__device__ __forceinline__ void put_act(void* p, size_t i, float v, int is_bf16) {
  if (is_bf16) static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<float*>(p)[i] = v;
}

// One block per (group of windows, stream, group of hg heads): see the header. kDrop (K3's
// dropout backward, and the split route of K1's and K4's, on g = drop(g_y) at the proj site): the
// window's keep words of the group's heads, from a.keep or hashed here (the tokens' unit hashes
// and slots over the ring, free until the q/k/v product); AV recomputed from the dropped weights
// (wp's gradient reads it) and the core's backward with g_P masked and g_v from the dropped P.
template <int DP, bool kFused, bool kDrop = false>
__global__ void __launch_bounds__(kThreads, min_blocks(DP)) k3_bwd_kernel(const BwdArgs a) {
  static_assert(!(kFused && DP > kPassesPitchMax), "the fused route keeps core_bwd's pitches");
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C, inner = a.inner, d = a.d, hg = a.hg, n = hg * d;
  const int T = tokens(a.t);
  const int2 wd = window_hw(a);
  const BwdLayout L = bwd_layout(kFused, a.cross != 0, C, inner, hg, d, DP, kDrop, T);
  const int s = blockIdx.y, grp = blockIdx.z, c0 = grp * n;
  const int kvs = a.cross ? a.S - 1 - s : s;
  const int nwin = (a.H / wd.x) * (a.W / wd.y), hw = a.H * a.W;
  const size_t map = static_cast<size_t>(hw) * C;

  int* rows = reinterpret_cast<int*>(smem + L.tabs);
  int* region = rows + kRowsB;
  int* tok = region + kRowsB;
  int* col_ofs = tok + kRowsB;
  float* bqkv_s = reinterpret_cast<float*>(col_ofs + kColTable);
  float* ring = reinterpret_cast<float*>(smem);
  float* bring = reinterpret_cast<float*>(smem + L.ring_b);
  float* u = reinterpret_cast<float*>(smem);  // fused: g_q | g_k | g_v, channel-major, over the rings
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float* go_s = reinterpret_cast<float*>(smem + L.go);
  float2* rd = reinterpret_cast<float2*>(smem + L.rd);
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);

  zero_smem(smem, 0, L.total);  // the padded dims and channels stay finite
  __syncthreads();
  fill_col_table<DP, false>(col_ofs, n, d, T);
  for (int col = threadIdx.x; col < 3 * n; col += kThreads) {
    const int part = (col >= n) + (col >= 2 * n);
    const float* bsrc = part == 0 ? a.bq : part == 1 ? a.bk : a.bv;
    bqkv_s[col] = bsrc[s * inner + c0 + col - part * n];
  }
  TabSum tab[kQuarter];
#pragma unroll
  for (int uu = 0; uu < kQuarter; ++uu) tab[uu] = 0.0f;
  const size_t elem = a.bf16 ? 2 : 4;  // bytes of an x or g element
  const unsigned char* x = static_cast<const unsigned char*>(a.x);
  const unsigned char* g = static_cast<const unsigned char*>(a.g);

  for (int item = blockIdx.x; item < a.B * nwin; item += gridDim.x) {
    const int b = item / nwin, win = item - b * nwin;
    const size_t img = static_cast<size_t>(s) * a.B + b;      // (s, b)
    const size_t kv_img = static_cast<size_t>(kvs) * a.B + b;  // the image k/v come from
    const size_t hrow = img * hw;                              // its first token row
    __syncthreads();  // the previous window's readers are done
    if (kFused) zero_smem(smem, L.q, L.rd);  // q/k/v/g_o's padded dims, under the g_x products
    window_rows(a, win, rows, region);
    for (int t = threadIdx.x; t < kRowsB; t += kThreads) tok[t] = rows[t] / C;  // this thread's rows[t]
    __syncthreads();
    for (int e = threadIdx.x; e < T * T; e += kThreads)
      bias_s[e] = region[e / T] == region[e % T] ? a.bias[s * T * T + e] : -__int_as_float(0x7f800000);
    uint32_t* keep_s = reinterpret_cast<uint32_t*>(smem + L.keep);
    if constexpr (kDrop) {
      if (a.keep != nullptr) {
        const int words = hg * T * swin::kKeepWords;
        const uint32_t* keep = a.keep + ((img * nwin + win) * (inner / d) + grp * hg) * T * swin::kKeepWords;
        for (int i = threadIdx.x; i < words; i += kThreads) keep_s[i] = keep[i];
      } else {  // the query's unit keys the pair: image img, the window's tokens
        uint32_t* ph = reinterpret_cast<uint32_t*>(smem);
        int* slot = reinterpret_cast<int*>(ph + kRowsB);
        for (int t = threadIdx.x; t < T; t += kThreads)
          ph[t] = swin::token_hash(a.drop, static_cast<int>(img), tok[t], &slot[t]);
        __syncthreads();
        swin::attention_keep_words(a.drop, ph, slot, grp * hg, hg, inner / d, keep_s, T);
        __syncthreads();  // the q/k/v product's ring goes over the hashes
      }
    }
    {  // q (scaled), k, v of the group's heads
      Gemm gm{};
      gm.abase[0] = x + img * map * elem;
      gm.abase[1] = x + kv_img * map * elem;
      gm.aparts = a.cross ? 2 : 1;
      gm.rows = rows;
      const size_t wofs = static_cast<size_t>(s) * C * inner + c0;
      gm.w[0] = a.wq + wofs;
      gm.w[1] = a.wk + wofs;
      gm.w[2] = a.wv + wofs;
      gm.n = n;
      gm.ldw = inner;
      gm.nb = 3 * n;
      gm.K = C;
      gm.t = T;
      with_tn(gm.nb, [&](auto tn) {
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_stream<decltype(tn)::value>(acc, gm, ring, bring, a.bf16);
        each(
            acc, gm.nb,
            [&](int t, int col, float v) {
              const float y = v + bqkv_s[col];
              put_qkv<DP, false>(t, col, col < n ? y * a.scale : y, n, col_ofs, q_s, k_s, smem + L.v);
            },
            T);
      });
    }
    {  // g_o = g wp^T for the group's heads
      Gemm gm{};
      gm.abase[0] = g + img * map * elem;
      gm.aparts = 1;
      gm.rows = rows;
      gm.w[0] = a.wpT + static_cast<size_t>(s) * C * inner + c0;
      gm.n = gm.nb = n;
      gm.ldw = inner;
      gm.K = C;
      gm.t = T;
      with_tn(n, [&](auto tn) {
        Tile<decltype(tn)::value> acc;
        zero_tile(acc);
        gemm_stream<decltype(tn)::value>(acc, gm, ring, bring, a.bf16);
        each(acc, n, [&](int t, int col, float v) { go_s[col_ofs[col] + t * DP] = v; }, T);
      });
    }
    __syncthreads();
    float* av = a.av + hrow * inner + c0;
    auto av_out = [&](int t, int col, float v) { av[static_cast<size_t>(tok[t]) * inner + col] = v; };
    if constexpr (DP > kPassesPitchMax) {
      float* gq = a.gq + hrow * inner + c0;
      float* gk = a.gk + hrow * inner + c0;
      float* gv = a.gv + hrow * inner + c0;
      core_bwd_tiled<DP, kDrop>(
          q_s, k_s, v_s, go_s, bias_s, hg, d, a.scale, reinterpret_cast<float*>(smem + L.ps), tab, av_out,
          [&](int t, int col, float v) { gq[static_cast<size_t>(tok[t]) * inner + col] = v; },
          [&](int u, int col, float v) { gk[static_cast<size_t>(tok[u]) * inner + col] = v; },
          [&](int u, int col, float v) { gv[static_cast<size_t>(tok[u]) * inner + col] = v; }, keep_s,
          a.drop_scale, T);
    } else {
      attention_core<DP, false, kDrop>(q_s, k_s, smem + L.v, nullptr, bias_s, hg, d, av_out, keep_s, a.drop_scale,
                                       swin::AttnHash{}, T);
      if constexpr (kFused) {
        core_bwd<DP, kDrop>(
            q_s, k_s, v_s, go_s, bias_s, hg, d, a.scale, rd, tab,
            [&](int t, int col, float v) { a_at(u, t, col) = v; },
            [&](int t, int col, float gk, float gv) {
              a_at(u, t, inner + col) = gk;
              a_at(u, t, 2 * inner + col) = gv;
            },
            keep_s, a.drop_scale, T);
        __syncthreads();
        store_a(u, inner, a.gq + hrow * inner, inner, tok, T);
        store_a(u + inner * kPitchF, inner, a.gk + hrow * inner, inner, tok, T);
        store_a(u + 2 * inner * kPitchF, inner, a.gv + hrow * inner, inner, tok, T);
        // g_x = [g_q | g_k | g_v] [wq | wk | wv]^T, the weight ring and a row buffer over q/k/v/g_o
        float* rowbuf = reinterpret_cast<float*>(smem + L.q + align16(b_bytes(false, C, kRing)));
        const float* wt = a.wqkvT + static_cast<size_t>(s) * 3 * inner * C;
        auto product = [&](const float* a0, int K, const float* w, auto store) {
          const Gemm gm = weights(w, C, C, K);
          with_tn(C, [&](auto tn) {
            Tile<decltype(tn)::value> acc;
            zero_tile(acc);
            gemm_tile<decltype(tn)::value, kRing>(acc, gm, a0, a0, q_s);
            each(acc, C, [&](int t, int col, float v) { rowbuf[t * C + col] = v; }, T);
          });
          __syncthreads();
          each_row_col(T, C, [&](int t, int k) { store(static_cast<size_t>(tok[t]) * C + k, rowbuf[t * C + k]); });
        };
        if (a.cross) {
          product(u, inner, wt, [&](size_t at, float v) { a.gxq[img * map + at] = v; });
          __syncthreads();
          product(u + inner * kPitchF, 2 * inner, wt + static_cast<size_t>(inner) * C,
                  [&](size_t at, float v) { a.gxkv[kv_img * map + at] = v; });
        } else {
          product(u, 3 * inner, wt, [&](size_t at, float v) { put_act(a.gx, img * map + at, v, a.bf16); });
        }
      } else {
        float* gq = a.gq + hrow * inner + c0;
        float* gk = a.gk + hrow * inner + c0;
        float* gv = a.gv + hrow * inner + c0;
        core_bwd<DP, kDrop>(
            q_s, k_s, v_s, go_s, bias_s, hg, d, a.scale, rd, tab,
            [&](int t, int col, float v) { gq[static_cast<size_t>(tok[t]) * inner + col] = v; },
            [&](int t, int col, float gkv, float gvv) {
              gk[static_cast<size_t>(tok[t]) * inner + col] = gkv;
              gv[static_cast<size_t>(tok[t]) * inner + col] = gvv;
            },
            keep_s, a.drop_scale, T);
      }
    }
  }

  const int t = threadIdx.x >> 2, qd = threadIdx.x & 3;
  if (t < T) {
    float* tp = a.tab_part + ((static_cast<size_t>(s) * gridDim.z + grp) * gridDim.x + blockIdx.x) * T * T + t * T;
#pragma unroll
    for (int uu = 0; uu < kQuarter; ++uu)
      if (qd * kQuarter + uu < T) tp[qd * kQuarter + uu] = static_cast<float>(tab[uu]);
  }
}

// ---- the split route's g_x: [g_q | g_k' | g_v'] [wq | wk' | wv']^T over token rows ---------
// A block per (T-token tile, stream, group of `width` output columns): the q side from the
// stream's g_q and wq^T into a row buffer, then the k/v side from the k/v stream's g_k, g_v
// and wk^T, wv^T (the other stream under cross) added to it; g_x = q + kv, in bf16 under cross
// rnd(rnd(q) + rnd(kv)); from the row buffer to coalesced stores.
struct GxLayout {
  int ring_b, rowbuf, rows, total;
};

__host__ __device__ inline GxLayout gx_layout(int width, int t = kT) {
  GxLayout L{};
  L.ring_b = ring_a_bytes(false, 1, kRing);
  L.rowbuf = align16(L.ring_b + b_bytes(false, width, kRing));
  L.rows = L.rowbuf + align16(tokens(t) * width * 4);
  L.total = L.rows + align16(kRowsB * 4);
  return L;
}

// Output columns of a gx_kernel block: C in the fewest groups of at most kMaxCols, each a
// multiple of 4.
__host__ __device__ inline int gx_width(int C) {
  const int groups = (C + kMaxCols - 1) / kMaxCols;
  return round_up((C + groups - 1) / groups, 4);
}

struct GxArgs {
  const float *gq, *gk, *gv, *wqkvT;
  void* gx;
  int S, M, C, inner, width, cross, bf16;
  int t;  // the any-window class's T: the rows of a block's tile
};

__global__ void __launch_bounds__(kThreads) gx_kernel(const GxArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = tokens(a.t);
  const GxLayout L = gx_layout(a.width, T);
  float* ring = reinterpret_cast<float*>(smem);
  float* bring = reinterpret_cast<float*>(smem + L.ring_b);
  float* rowbuf = reinterpret_cast<float*>(smem + L.rowbuf);
  int* rows = reinterpret_cast<int*>(smem + L.rows);
  const int s = blockIdx.y, kvs = a.cross ? a.S - 1 - s : s;
  const int C = a.C, inner = a.inner, width = a.width;
  const int cg0 = blockIdx.z * width, ncols = min(width, C - cg0);
  const size_t r0 = static_cast<size_t>(s) * a.M + static_cast<size_t>(blockIdx.x) * T;
  const size_t kv0 = static_cast<size_t>(kvs) * a.M + static_cast<size_t>(blockIdx.x) * T;
  for (int t = threadIdx.x; t < kRowsB; t += kThreads) rows[t] = t < T ? t * inner : 0;
  __syncthreads();
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
      gm.t = T;
      gemm_stream<TN>(acc, gm, ring, bring, 0);
    };
    const bool apart = a.bf16 && a.cross;  // bf16 under cross: each side rounded
    Tile<TN> acc;
    zero_tile(acc);
    part(acc, a.gq + r0 * inner, s, 0);
    each(
        acc, ncols, [&](int t, int col, float v) { rowbuf[t * width + col] = apart ? swin::round_bf16(v) : v; }, T);
    zero_tile(acc);
    part(acc, a.gk + kv0 * inner, kvs, 1);
    part(acc, a.gv + kv0 * inner, kvs, 2);
    each(
        acc, ncols, [&](int t, int col, float v) { rowbuf[t * width + col] += apart ? swin::round_bf16(v) : v; }, T);
  });
  __syncthreads();
  each_row_col(T, ncols, [&](int t, int k) { put_act(a.gx, (r0 + t) * C + cg0 + k, rowbuf[t * width + k], a.bf16); });
}

}  // namespace k3bwd
