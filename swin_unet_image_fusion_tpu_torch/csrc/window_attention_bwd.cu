// Swin window attention (K3), the backward with and without dropout, fp32 and bf16, redesigned
// for Hopper (sm_90a).
//
// Replaces swin_unet_image_fusion_tpu/ops/pallas_attention.py::_attention_bwd_body (l.335-,
// through _attention_bwd_kernel / _attention_bwd_kernel_self from pallas_window_attention's
// _backward, l.770), dropout l.372-386 and 450-468. The function is that backward's: given x, the nine
// weights and g = dL/d out it recomputes q (scaled), k, v and AV and returns g_x and every
// weight's gradient; under cross the k/v gradients of stream s belong to stream 1-s's rows;
// the softmax clamp at 80 is not differentiated and a masked score gives P = g_S = 0. fp32
// inside in both dtypes (x and g upcast as they are loaded, as the JAX body upcasts, l.388-390);
// a bf16 g_x is rounded once in self mode, and under cross its q side and k/v side are rounded
// apart and added in bf16 (JAX's gx and gkv outputs, added by the caller, l.495-498).
//
// What bounds it, and the design. The backward does about three times the forward's matmul
// work at the same bytes, so the fp32 rate bounds it (4.62 ms per 224² batch-20 step;
// PERF.md §6). window_attention.cu's backward ran about ten launches over whole activations in
// device memory, its core one block per (16 windows, image, head) with scalar loops over three
// T x T buffers. Here one block kernel (k3_bwd_kernel) takes each window from x and g to its
// gradients in shared memory, walking a fixed list of windows (blockIdx.x, + gridDim.x, ...)
// of its stream and group of heads, one wave of the card:
//   q (scaled), k, v of its heads from x (and under cross the other stream's rows) and g_o =
//   g wp^T from g, both with A streamed through a ring (window_bwd.cuh's gemm_stream); AV, the
//   wp gradient's operand (window_fwd.cuh's attention core); window_bwd.cuh's core backward
//   (g_q, g_k, g_v; the bias-table gradient summed in the lane's registers across heads and
//   windows); g_q, g_k, g_v and AV to token rows for the weight gradients.
// Two routes (ops/window_attention.py::bwd_plan):
//   fused (every head in the block, d <= 8, 3 heads*d <= 144, C <= 144: stages 0-1 of the
//     default model): the block also forms g_x = [g_q | g_k | g_v] [wq | wk | wv]^T from the
//     resident gradients, under cross the q side to its own rows and the k/v side to the other
//     stream's rows of a second buffer, which sum_sides_kernel adds, so no block waits on
//     another;
//   split (a group of heads of at most 48 columns a q/k/v part: stages 2-4): the blocks write
//     g_q, g_k, g_v, and gx_kernel forms g_x over 49-token tiles and column groups, the q side
//     parked in a row buffer while the k/v side is summed. At d = 48 (stage 4, one head a block)
//     the block's core is window_bwd.cuh's core_bwd_tiled: core_bwd's rows and columns passes
//     held 144-192 floats a lane there (255 registers with ~800 bytes of spills, one block an
//     SM), and its columns pass and attention_core's AV gave a head's 49 keys or rows one thread
//     each; core_bwd_tiled keeps the head's P and g_S in shared memory and forms AV, g_q, g_k and
//     g_v as four 49 x 49 by 49 x 48 products on 224 threads, one block an SM (255 registers,
//     no spills).
// Then one wgrad_rows_kernel launch for wq, wk, wv, wp and their biases and one fixed-order
// reduction of every partial (window_core_bwd.cuh). The transposed weights (wp^T, [wq | wk |
// wv]^T) come first, so that every product streams its weights through the same ring.
// fp32 FMA throughout (TF32 off), no atomics: every sum has one fixed order, and the blocks
// per stream and group come from the caller, so a repeat gives the same bits. Built as it stands,
// the file takes 7x7 windows (T = 49 at compile time); window_attention_bwd_any.cu builds it in
// window_fwd.cuh's any-window class (SWIN_ANY_WINDOW: any window of T <= 64 tokens, T at run
// time, 64-row blocks).
// Dropout (the attention site of `drop`, keyed on K3's wrap windows, ops/dropout_layout.py "k3";
// the projection's dropout is the caller's): the same launches with the block's kDrop form
// (k3_bwd.cuh). The block hashes its window's keep words of its heads once (two 32-bit words a
// query row, hash_dropout.cuh::attention_keep_words) into shared memory; AV, wp's gradient's
// operand, comes from the dropped P = drop(p); the core backward masks g_P = drop(g_o v^T) with
// the same bits and scale, forms g_v from the dropped P and g_S = P (g_P - sum g_P P) from the
// undropped P. A masked score has P = 0, so its keep bit never shows. The forward is
// window_attention_fwd.cu's.

#include "k3_bwd.cuh"

// The block kernel's forms this build holds: both in the 7x7 build; the any-window backward is
// built once a form (SWIN_K3_BWD_DROP 0: without dropout, window_attention_bwd_any.cu; 1: with,
// window_attention_bwd_any_drop.cu), so that its two halves compile at once.
#if !defined(SWIN_K3_BWD_DROP) || SWIN_K3_BWD_DROP == 0
#define SWIN_K3_BWD_NODROP_FORM 1
#endif
#if !defined(SWIN_K3_BWD_DROP) || SWIN_K3_BWD_DROP == 1
#define SWIN_K3_BWD_DROP_FORM 1
#endif

namespace {

using namespace wbwd;
using namespace k3bwd;

// The fused route's g_x under cross: its q side and k/v side added, in bf16 rounded apart.
__global__ void __launch_bounds__(kThreads) sum_sides_kernel(const float* q, const float* kv, void* out, size_t n,
                                                           int is_bf16) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * kThreads)
    put_act(out, i, is_bf16 ? swin::round_bf16(q[i]) + swin::round_bf16(kv[i]) : q[i] + kv[i], is_bf16);
}

// ---- host side -------------------------------------------------------------------------
int pitch_for(int d, bool fused) {
  if (fused) return d <= 4 ? 4 : d <= 8 ? 8 : 0;
  for (int p : {4, 8, 12, 16, 24, 32, 48})
    if (d <= p) return p;
  return 0;
}

// Whether the route takes these dimensions (ops/window_attention.py::bwd_plan makes the same
// checks and raises first): every head in the block on the fused route, the weight-gradient
// launch's slabs and each block within a block's shared memory.
// drop: the dropout form, whose block holds its heads' keep words.
// t: the window's tokens, which this build must take (takes_window).
bool supported(int C, int inner, int heads, int d, int hg, bool fused, bool cross, bool drop, int t) {
  const int n = hg * d;
  if (pitch_for(d, fused) == 0 || hg < 1 || heads % hg != 0 || inner != heads * d || C % 8 != 0 || inner % 8 != 0 ||
      n % 8 != 0 || 3 * n > kMaxCols || 3 * n > kColTable || (fused && (hg != heads || C > kMaxCols)))
    return false;
  return bwd_layout(fused, cross, C, inner, hg, d, pitch_for(d, fused), drop, t).total <= kSmemMax &&
         gx_layout(gx_width(C), t).total <= kSmemMax && wg_smem(C, inner) <= kSmemMax && wg_smem(inner, C) <= kSmemMax;
}

// Whether this build takes a wh x ww window: 7 x 7 alone, or (the any-window class) any window
// of at most kT = 64 tokens.
bool takes_window(int wh, int ww) {
  if (!kAnyWindow) return wh == 7 && ww == 7;
  return wh >= 1 && ww >= 1 && wh * ww <= kT;
}

// Workspace of one call, carved in this order (ops/window_attention.py::bwd_workspace_floats
// mirrors it); with base == nullptr the walk sizes it.
struct BwdScratch {
  float *wpT, *wqkvT, *av, *gq, *gk, *gv, *gxq, *gxkv, *tab_part, *wg_part;
  int chunk_rows, chunks;  // of the weight-gradient launch
};

constexpr int kWgPerStream = 4;  // wq, wk, wv (A = the rows each read, B = g_q, g_k, g_v); wp (A = AV, B = g)

BwdScratch carve(swin::Arena& ar, int S, int M, int C, int inner, int groups, int blocks, bool fused, bool cross,
                 int T) {
  BwdScratch sc{};
  const size_t SM = static_cast<size_t>(S) * M;
  sc.wpT = ar.take(static_cast<size_t>(S) * C * inner);
  sc.wqkvT = ar.take(static_cast<size_t>(S) * 3 * inner * C);
  sc.av = ar.take(SM * inner);
  sc.gq = ar.take(SM * inner);
  sc.gk = ar.take(SM * inner);
  sc.gv = ar.take(SM * inner);
  sc.gxq = fused && cross ? ar.take(SM * C) : nullptr;
  sc.gxkv = fused && cross ? ar.take(SM * C) : nullptr;
  sc.tab_part = ar.take(static_cast<size_t>(S) * groups * blocks * T * T);
  sc.chunk_rows = wg_chunk_rows(M, kWgPerStream * S * max2(wg_groups_of_tiles(C, inner), wg_groups_of_tiles(inner, C)));
  sc.chunks = (M + sc.chunk_rows - 1) / sc.chunk_rows;
  sc.wg_part = ar.take(static_cast<size_t>(S) * sc.chunks * (3 * (C + 1) * inner + (inner + 1) * C));
  return sc;
}

// Argument slots, in the forward's order (ops/window_attention.py), then g; outputs: g_x, then
// the gradient of each weight in slot order (out[w] for In w).
enum In { kX, kWq, kBq, kWk, kBk, kWv, kBv, kWp, kBp, kBias, kG };

template <int DP, bool kFused, bool kDrop>
cudaError_t launch_block(int blocks, int groups, int smem, const BwdArgs& a, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(k3_bwd_kernel<DP, kFused, kDrop>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k3_bwd_kernel<DP, kFused, kDrop><<<dim3(blocks, a.S, groups), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kDrop>
cudaError_t launch_pitch(bool fused, int dp, int blocks, int groups, int smem, const BwdArgs& a, cudaStream_t st) {
  if (fused) {
    if (dp == 4) return launch_block<4, true, kDrop>(blocks, groups, smem, a, st);
    if (dp == 8) return launch_block<8, true, kDrop>(blocks, groups, smem, a, st);
    return cudaErrorInvalidValue;
  }
  switch (dp) {
    case 4: return launch_block<4, false, kDrop>(blocks, groups, smem, a, st);
    case 8: return launch_block<8, false, kDrop>(blocks, groups, smem, a, st);
    case 12: return launch_block<12, false, kDrop>(blocks, groups, smem, a, st);
    case 16: return launch_block<16, false, kDrop>(blocks, groups, smem, a, st);
    case 24: return launch_block<24, false, kDrop>(blocks, groups, smem, a, st);
    case 32: return launch_block<32, false, kDrop>(blocks, groups, smem, a, st);
    case 48: return launch_block<48, false, kDrop>(blocks, groups, smem, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// x, g and g_x fp32, or bf16 with `is_bf16` set (fp32 inside); drop: the attention site's
// dropout arguments, or nullptr.
int k3_bwd(const float* const* in, float* const* out, float* ws, const swin::DropArgs* drop, int S, int B, int H,
           int W, int C, int heads, int d, int hg, bool fused, int blocks, int shift, int cross, int is_bf16,
           float scale, int wh, int ww, cudaStream_t st) {
  const int inner = heads * d, M = B * H * W, groups = heads / hg, T = wh * ww;
  swin::Arena ar{ws};
  const BwdScratch sc = carve(ar, S, M, C, inner, groups, blocks, fused, cross != 0, T);

  Transposes tr = {};
  int jobs = 0, most = 0;
  auto add = [&](const float* src, float* dst, int rows, int cols) {
    tr.src[jobs] = src, tr.dst[jobs] = dst, tr.rows[jobs] = rows, tr.cols[jobs] = cols;
    most = max2(most, rows * cols);
    ++jobs;
  };
  const int w_of[3] = {kWq, kWk, kWv};
  for (int s = 0; s < S; ++s) {
    const size_t ci = static_cast<size_t>(s) * C * inner;
    add(in[kWp] + ci, sc.wpT + ci, inner, C);
    for (int p = 0; p < 3; ++p) add(in[w_of[p]] + ci, sc.wqkvT + 3 * ci + static_cast<size_t>(p) * inner * C, C, inner);
  }
  transpose_kernel<<<dim3(std::min((most + kThreads - 1) / kThreads, 64), jobs), kThreads, 0, st>>>(tr);

  const bool dropping = drop != nullptr;
  BwdArgs a = {in[kX], in[kG], in[kWq], in[kBq], in[kWk], in[kBk], in[kWv], in[kBv], in[kBias], sc.wpT,
               sc.wqkvT, sc.av, sc.gq, sc.gk, sc.gv, out[0], sc.gxq, sc.gxkv, sc.tab_part, S, B, H, W, C,
               inner, d, hg, shift ? wh - wh / 2 : 0, shift ? ww - ww / 2 : 0, cross, scale, /*windows=*/0, is_bf16};
  a.wh = wh, a.ww = ww, a.t = T;
  if (dropping) {  // the block hashes its keep words (a.keep stays nullptr)
    a.drop = swin::drop_site(drop, swin::kSiteAttn, H * W, B);
    a.drop_scale = a.drop.scale;
  }
  const int smem = bwd_layout(fused, cross != 0, C, inner, hg, d, pitch_for(d, fused), dropping, T).total;
  cudaError_t err = cudaErrorInvalidValue;  // swin_k3_bwd refuses a form the build leaves out
#ifdef SWIN_K3_BWD_DROP_FORM
  if (dropping) err = launch_pitch<true>(fused, pitch_for(d, fused), blocks, groups, smem, a, st);
#endif
#ifdef SWIN_K3_BWD_NODROP_FORM
  if (!dropping) err = launch_pitch<false>(fused, pitch_for(d, fused), blocks, groups, smem, a, st);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t n_x = static_cast<size_t>(S) * M * C;
  if (fused && cross) {
    sum_sides_kernel<<<static_cast<unsigned>(std::min<size_t>((n_x + kThreads - 1) / kThreads, 132 * 16)),
                       kThreads, 0, st>>>(sc.gxq, sc.gxkv, out[0], n_x, is_bf16);
  } else if (!fused) {
    const int width = gx_width(C);
    const GxArgs ga = {sc.gq, sc.gk, sc.gv, sc.wqkvT, out[0], S, M, C, inner, width, cross, is_bf16, T};
    const int gsmem = gx_layout(width, T).total;
    err = cudaFuncSetAttribute(gx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gsmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gx_kernel<<<dim3(M / T, S, (C + width - 1) / width), kThreads, gsmem, st>>>(ga);
  }

  // weight gradients from the stored operands, one launch; then every partial sum
  WgJobs wg = {};
  wg.rows = M;
  wg.chunk_rows = sc.chunk_rows;
  swin::ReduceJobs red = {};
  bool ok = true;
  const int grads[kWgPerStream][2] = {{kWq, kBq}, {kWk, kBk}, {kWv, kBv}, {kWp, kBp}};
  float* part = sc.wg_part;
  int tile_groups = 1, wg_bytes = 0;
  for (int s = 0; s < S; ++s) {
    const size_t tok = static_cast<size_t>(s) * M, s_kv = cross ? static_cast<size_t>(S - 1 - s) * M : tok;
    const size_t elem = is_bf16 ? 2 : 4;  // bytes of an x or g element
    const unsigned char* x = reinterpret_cast<const unsigned char*>(in[kX]);
    const unsigned char* g = reinterpret_cast<const unsigned char*>(in[kG]);
    const WgJob job[kWgPerStream] = {
        {x + tok * C * elem, sc.gq + tok * inner, nullptr, C, inner, 0, is_bf16},
        {x + s_kv * C * elem, sc.gk + tok * inner, nullptr, C, inner, 0, is_bf16},
        {x + s_kv * C * elem, sc.gv + tok * inner, nullptr, C, inner, 0, is_bf16},
        {sc.av + tok * inner, g + tok * C * elem, nullptr, inner, C, is_bf16, 0},
    };
    for (int j = 0; j < kWgPerStream; ++j) {
      WgJob jb = job[j];
      jb.part = part;
      wg.job[wg.count++] = jb;
      tile_groups = max2(tile_groups, wg_groups_of_tiles(jb.ka, jb.nb));
      wg_bytes = max2(wg_bytes, wg_smem(jb.ka, jb.nb));
      ok &= red.add(part, sc.chunks, (jb.ka + 1) * jb.nb, jb.ka * jb.nb,
                    out[grads[j][0]] + static_cast<size_t>(s) * jb.ka * jb.nb,
                    out[grads[j][1]] + static_cast<size_t>(s) * jb.nb);
      part += static_cast<size_t>(sc.chunks) * (jb.ka + 1) * jb.nb;
    }
  }
  err = cudaFuncSetAttribute(wgrad_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_rows_kernel<<<dim3(sc.chunks, wg.count, tile_groups), kThreads, wg_bytes, st>>>(wg);

  const int tab_chunks = groups * blocks;
  for (int s = 0; s < S; ++s)
    ok &= red.add(sc.tab_part + static_cast<size_t>(s) * tab_chunks * T * T, tab_chunks, T * T, T * T,
                  out[kBias] + static_cast<size_t>(s) * T * T, nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  swin::launch_reduce(red, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// swin_cuda_error_string comes with window_core.cuh.

// Dynamic shared memory in bytes of one block of the block kernel (kind 0) or of the split
// route's g_x kernel (kind 1) at wh x ww windows, or 0 where the route does not take the
// dimensions (hg: heads a block; fused: every head, hg == heads; drop: the dropout form, its
// block holding the keep words of its heads).
size_t swin_k3_bwd_smem(int kind, int fused, int cross, int C, int heads, int d, int hg, int drop, int wh, int ww) {
  const int inner = heads * d, T = wh * ww;
  if (kind < 0 || kind > 1 || !takes_window(wh, ww) ||
      !supported(C, inner, heads, d, hg, fused != 0, cross != 0, drop != 0, T))
    return 0;
  if (kind == 1) return static_cast<size_t>(gx_layout(gx_width(C), T).total);
  return static_cast<size_t>(
      bwd_layout(fused != 0, cross != 0, C, inner, hg, d, pitch_for(d, fused != 0), drop != 0, T).total);
}

// Floats of workspace one call needs at wh x ww windows; blocks: blocks per (stream, group of
// heads). The dropout form needs no more: its keep words live in each block's shared memory.
size_t swin_k3_bwd_workspace(int S, int B, int H, int W, int C, int heads, int d, int hg, int fused, int blocks,
                             int cross, int wh, int ww) {
  swin::Arena ar{nullptr};
  carve(ar, S, B * H * W, C, heads * d, heads / hg, blocks, fused != 0, cross != 0, wh * ww);
  return ar.used;
}

// The backward on `stream`, with dropout where `drop` (the forward's dropout arguments, K3's
// keying; its attention site) is not nullptr. in: x, wq, bq, wk, bk, wv, bv, wp, bp, bias, then
// g = dL/d out; out: g_x, then the gradients of those nine weights in that order and shapes. x,
// g and g_x are (S, B, H, W, C) fp32, or bf16 when `bf16_io` is set (fp32 inside); the weights
// and their gradients fp32, the bias (S, T, T); wh x ww windows of T tokens (7 x 7 in this
// build, any of T <= 64 in the any-window build). hg: heads a block (fused: every head, g_x in the
// block); blocks: blocks per (stream, group of heads); ws: ws_floats floats of workspace, at
// least swin_k3_bwd_workspace(...). Every output is written in full. Returns
// cudaGetLastError() after the launches (0 = ok), cudaErrorInvalidValue on dimensions the
// route does not take or a workspace too small.
int swin_k3_bwd(const float* const* in, float* const* out, float* ws, size_t ws_floats, const swin::DropArgs* drop,
                int S, int B, int H, int W, int C, int heads, int d, int hg, int fused, int blocks, int shift,
                int cross, int bf16_io, float scale, int wh, int ww, void* stream) {
  if (!swin::drop_on(drop, swin::kSiteAttn)) drop = nullptr;
#ifndef SWIN_K3_BWD_DROP_FORM
  if (drop != nullptr) return static_cast<int>(cudaErrorInvalidValue);
#endif
#ifndef SWIN_K3_BWD_NODROP_FORM
  if (drop == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#endif
  if (!takes_window(wh, ww) || H % wh != 0 || W % ww != 0 || S < 1 || S > 2 || (cross && S != 2) || blocks < 1 ||
      !supported(C, heads * d, heads, d, hg, fused != 0, cross != 0, drop != nullptr, wh * ww) ||
      ws_floats < swin_k3_bwd_workspace(S, B, H, W, C, heads, d, hg, fused, blocks, cross, wh, ww))
    return static_cast<int>(cudaErrorInvalidValue);
  return k3_bwd(in, out, ws, drop, S, B, H, W, C, heads, d, hg, fused != 0, blocks, shift, cross, bf16_io != 0,
                scale, wh, ww, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
