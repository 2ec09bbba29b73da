// Fused pre-norm Swin block, forward in fp32 or bf16, for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute the same function:
//   K1  swin_unet_image_fusion_tpu/ops/pallas_pack.py::_packed_block_fwd_body (entered
//       through _packed_fwd_kernel / _packed_fwd_kernel_self from
//       pallas_packed_block_strips), on window-packed tokens;
//   K4  swin_unet_image_fusion_tpu/ops/pallas_block.py::_block_fwd_body (entered through
//       _block_fwd_kernel / _block_fwd_kernel_self from pallas_fused_block), on the image.
// One whole BasicBlock per call, for both streams at once:
//   y   = x + proj(attention(LN1(x), kv)) + bp
//   out = y + fc2(act(fc1(LN2(y)) + b1)) + b2, act ELU, ReLU or GELU (activation.cuh)
// LayerNorm in fp32 with the biased variance and eps 1e-5. Under cross, k/v come from the
// other stream normalised with THAT stream's LN1; attention is K3's (window_core.cuh):
// scale folded into q, the shared relative-position bias, the wrap-seam mask setting
// scores to -1e10, the clamped fast softmax.
//
// Layouts. The TPU's K1 packs two 64-token windows into 128 lanes only to dodge the
// TPU's (8, 128) tile padding; Hopper has no such padding, so one source serves both
// configurations and the layout is a template parameter of the attention core's
// addressing alone (every other launch works on token rows, the same in both):
//   image    x, out (S, B, H, W, C); the (shifted) window partition is address arithmetic;
//   windows  x, out (S, B, nWin, T, C) as ops/window_pack.py::pack_windows lays them out
//            for this block's geometry (between blocks, ops/window_pack.py re-partitions).
//
// What bounds it, and the design. Per window the block does ~24*T*C^2 + 4*T^2*C FLOP
// (q/k/v, proj, and an MLP of hidden 4C) against 8*T*C bytes in and out, so the fp32 rate
// bounds it at every stage. One block per window holding x, LN1(x), LN1(kv) and a (T, C)
// accumulator needs 4 x 75 KB at C = 384, and the 4C-wide MLP hidden another 301 KB; the
// deep stages have only 18-50 windows for 132 SMs (K3's first design, one block per
// window, took 13.7 ms per C = 384 launch). So this version runs five launches, every one
// a kernel of this file or of window_core.cuh, with no PyTorch op between them:
//   1. q/k/v GEMM with LN1 in its prologue (each block computes its rows' statistics),
//      the kv rows and their LN1 weights taken from the other stream under cross;
//   2. K3's attention core, one block per (window, stream*batch, head);
//   3. proj GEMM + bias + the residual x, writing y into `out`;
//   4. fc1 GEMM with LN2 in its prologue, + b1, the activation in its epilogue, into `hid`;
//   5. fc2 GEMM + b2 + the residual y, in place in `out`.
// Every block is small and the card is full at every stage; the price is writing q, k,
// v, AV, y and the hidden activations to device memory and reading them back: at stage 0 of
// a 512² request (67,081 tokens a stream) about 0.3 GB a call against 26 MB of x in and
// out, and the two streams' 96-wide hidden alone (51.5 MB) exceeds the 50 MB L2. fp32 FMA
// throughout; TF32 and the tensor cores are off.
// These five launches now serve the recompute of the backward below and the timings in turns;
// the forward, K4 and K1 alike, with and without dropout, runs fused_block_fwd.cu and
// fused_block_fwd_drop.cu (one launch a block at C <= 48, six above; K4's bf16 products on the
// tensor cores, K1 fp32 inside in both dtypes). The backward below runs only where
// ops/fused_block.py::block_bwd_plan routes "five": shapes that neither redesigned route takes
// (another window, d = 13-16 or 25-32, ...), none of them in the default model, with and without
// dropout; every stage of the default model, C = 384 included, runs fused_block_bwd.cu or
// fused_block_bwd_split.cu, dropout forms included.
//
// bf16 (x and out bf16, the weights fp32). The two TPU kernels round differently, so the
// rounding is a template parameter beside the layout, and the dispatch below ties K4's
// rounding to the image layout and K1's to the windows layout:
//   K4 (pallas_block.py:111-190) takes bf16 operands (kBf16Ops): x is upcast on load;
//       LN1(x) and LN1(kv) are rounded as the q/k/v GEMM loads them, the weights as every
//       GEMM loads them; p and v are rounded before AV and AV is stored rounded; LN2(y) is
//       rounded in fc1's prologue and the hidden on its store; the sums are fp32;
//   K1 (pallas_pack.py:563-688) is the fp32 block with bf16 input and output: every
//       product takes fp32 operands, the weights included (l.617-618).
// In both, y = x + proj is never rounded: it goes to an fp32 scratch (in fp32 it is
// `out` itself, as above), and fc2's epilogue rounds y + m once on the store.
//
// Backward (swin_fused_block_bwd) replaces K1 bwd (pallas_pack.py::_packed_block_bwd_body,
// through _packed_bwd_kernel / _packed_bwd_kernel_self) and K4 bwd
// (pallas_block.py::_block_bwd_body, through _block_bwd_kernel / _block_bwd_kernel_self).
// Like the JAX custom VJPs it is given only x, the weights and g = dL/d out, recomputes
// the forward into scratch and backpropagates the whole block:
//   recompute   LN1(x) with its row statistics; q/k/v; the attention core; y = x + proj;
//               LN2(y); h = act(fc1) (under GELU z = fc1 itself, activation.cuh);
//   backward    g_pre1 = (g w2^T) * act'(z) (under GELU the erf hidden then replaces z for
//               w2's gradient); g_lny = g_pre1 w1^T; g_y = g + LN2 bwd;
//               then the attention half (window_core_bwd.cuh): g_o = g_y wp^T, the core
//               backward, g_ln = g_q wq^T + g_k wk^T + g_v wv^T; g_x = g_y + LN1 bwd;
//   weights     every dense weight and bias gradient as [A | 1]^T B over the tokens, the
//               LayerNorm and relative-position bias gradients as column sums, each
//               summed from per-block partials by one fixed-order reduction launch.
// Cross routing. Stream s's k/v are stream 1-s's rows normalised with stream 1-s's LN1,
// i.e. LN1(x)[1-s] itself. So the k/v gradients of stream s are added to g_ln[1-s], and
// one LayerNorm backward per stream (x[r], gamma[r]) then serves both the q side of r
// and the k/v side that read r: the JAX kernels' kv-slot LN1 gradients land in the other
// stream's slot, here by construction. In self mode the same sum is the JAX kernels' LN
// backward of g_lnx + g_lnkv.
// bf16 backward (training at compute_dtype=bfloat16): both JAX bodies upcast x, kv and g
// and recompute and backpropagate in fp32 with fp32 weights (K4 l.278-293, 337-340,
// 397-400; K1 l.792-794), so K1 and K4 alike run the fp32 code above with x and g upcast
// as they are loaded; the weight gradients stay fp32 and g_x is rounded once on the LN1
// backward's store. Under cross JAX writes gx (the residual and q side) and gkv (the k/v
// side, at the stream whose rows k/v read) in x's dtype and adds the two in bf16 (K4
// l.439-449), so here the attention backward keeps the k/v side of LN1's gradient apart
// and the LN1 backward stores rnd(rnd(g_y + q side) + rnd(k/v side)).
// What bounds it: the fp32 rate, as the forward, at about three times the forward's
// matmul work (recompute, input gradients, weight gradients). The scratch of a stage-0
// block at 224x224 batch 20 is about 1.1 GB (activations and gradients of 250,880 tokens
// per stream), allocated by the wrapper for the call.
//
// Dropout (training; the seed_ref paths of K1, pallas_pack.py:581-686 and 808-929, and of
// K4, pallas_block.py:87-187 and 257-411): the four sites of the reference, with the hash
// masks of hash_dropout.cuh keyed on each TPU kernel's own geometry (ops/dropout_layout.py:
// "k1" window pairs for the windows layout, "k4" padded windows for the image layout):
//   forward     p masked before AV (the core); y = x + drop(proj + bp) (proj epilogue);
//               h = drop(act(fc1)) (fc1 epilogue); out = y + drop(fc2 + b2) (fc2 epilogue);
//   backward    the recompute masks p and proj as the forward and keeps h unmasked for
//               act'; g_m = drop(g) (dropout_rows_kernel) feeds fc2's input and weight
//               gradients; g_pre1 = drop(g_m w2^T) * act'(z) (gpre epilogue); h is then
//               masked in place for w2's gradient; g_proj = drop(g_y) feeds the attention
//               backward (proj's gradients and g_o), whose core masks g_P and P as the
//               JAX body does; the residual paths (g, g_y) stay unmasked.
// A site of rate 0 runs the launch without the mask, so every rate 0 is the code above.
// The masks add ~11 integer operations per masked element, the backward two elementwise
// launches and 2 x (S, M, C) fp32 scratch.

#include <type_traits>

#include "window_core_bwd.cuh"

using namespace swin;

namespace {

// Launch sequence of one block; returns cudaGetLastError() after it (0 = ok). x and out
// are TX; AV (o) and the MLP hidden (hid) are bf16 under kBf16Ops, else fp32; y is fp32
// (it may be `out` when TX is float).
template <bool kWindows, typename TX, bool kBf16Ops>
int fused_block(const void* xv, const float* ln1g, const float* ln1b, const float* wq,
                const float* bq, const float* wk, const float* bk, const float* wv,
                const float* bv, const float* wp, const float* bp, const float* bias,
                const float* ln2g, const float* ln2b, const float* w1, const float* b1,
                const float* w2, const float* b2, void* outv, float* q, float* k, float* v,
                void* ov, void* hidv, float* y, int S, int B, int H, int W, int C, int heads,
                int d, int hidden, int wh, int ww, int shift, int cross, float scale, int act,
                const DropArgs* drop, cudaStream_t st) {
  using TM = typename std::conditional<kBf16Ops, bf16, float>::type;
  const TX* x = static_cast<const TX*>(xv);
  TX* out = static_cast<TX*>(outv);
  TM* o = static_cast<TM*>(ov);
  TM* hid = static_cast<TM*>(hidv);
  const int inner = heads * d;
  const int M = B * H * W;  // tokens per stream
  const size_t x_stream = static_cast<size_t>(M) * C;
  const size_t h_stream = static_cast<size_t>(M) * inner;
  const size_t m_stream = static_cast<size_t>(M) * hidden;

  launch_gemm<true, false, false, true, false, false, kBf16Ops>(
      qkv_batch(x, wq, bq, wk, bk, wv, bv, q, k, v, S, M, C, inner, cross != 0, scale, ln1g,
                ln1b),
      M, inner, C, 3 * S, st);

  const cudaError_t err = launch_core<kWindows, kBf16Ops>(q, k, v, bias, o, S, B, H, W, heads,
                                                          d, wh, ww, shift != 0, st, drop);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmBatchT<TM, TX, float> proj = {};
  GemmBatchT<float, float, TM> fc1 = {};
  GemmBatchT<TM, float, TX> fc2 = {};
  fc1.act = act;
  for (int s = 0; s < S; ++s) {
    proj.a[s] = o + s * h_stream;
    proj.b[s] = wp + static_cast<size_t>(s) * inner * C;
    proj.bias[s] = bp + static_cast<size_t>(s) * C;
    proj.res[s] = x + s * x_stream;
    proj.c[s] = y + s * x_stream;
    proj.alpha[s] = 1.0f;

    fc1.a[s] = y + s * x_stream;
    fc1.ln_g[s] = ln2g + static_cast<size_t>(s) * C;
    fc1.ln_b[s] = ln2b + static_cast<size_t>(s) * C;
    fc1.b[s] = w1 + static_cast<size_t>(s) * C * hidden;
    fc1.bias[s] = b1 + static_cast<size_t>(s) * hidden;
    fc1.c[s] = hid + s * m_stream;
    fc1.alpha[s] = 1.0f;

    fc2.a[s] = hid + s * m_stream;
    fc2.b[s] = w2 + static_cast<size_t>(s) * hidden * C;
    fc2.bias[s] = b2 + static_cast<size_t>(s) * C;
    fc2.res[s] = y + s * x_stream;
    fc2.c[s] = out + s * x_stream;
    fc2.alpha[s] = 1.0f;
  }
  const int hw = H * W;
  launch_gemm_site<false, false, true, true, false, false, kBf16Ops>(proj, M, C, inner, S, st,
                                                                     drop, kSiteProj, hw, B);
  launch_gemm_site<true, true, false, true, false, false, kBf16Ops>(fc1, M, hidden, C, S, st,
                                                                    drop, kSiteHidden, hw, B);
  launch_gemm_site<false, false, true, true, false, false, kBf16Ops>(fc2, M, C, hidden, S, st,
                                                                     drop, kSiteOut, hw, B);
  return static_cast<int>(cudaGetLastError());
}

// Argument slots of the backward, in the forward's order (ops/fused_block.py).
enum In { kX, kLn1g, kLn1b, kWq, kBq, kWk, kBk, kWv, kBv, kWp, kBp, kBias, kLn2g, kLn2b,
          kW1, kB1, kW2, kB2, kG, kNumIn };
// outputs: g_x, then the gradient of each weight in slot order (out[w] for In w)

struct BlockBwdScratch {
  float *lnx, *stats1, *q, *k, *v, *o, *y, *lny, *stats2, *h, *gpre, *glny, *gy, *gln;
  float *gm, *gproj;  // the masked gradients of the MLP output and of proj (dropout only)
  float *glnkv;       // the k/v side of LN1's gradient, kept apart (bf16 under cross only)
  float *ln1_part, *ln2_part, *w1_part, *w2_part;
  WgradPlan w1_plan, w2_plan;
  AttnBwdScratch attn;
};

BlockBwdScratch carve_block_bwd(Arena& ar, int S, int B, int H, int W, int C, int heads,
                                int d, int hidden, int wh, int ww, const DropArgs* drop,
                                bool split_kv) {
  BlockBwdScratch sc;
  const int inner = heads * d;
  const size_t M = static_cast<size_t>(B) * H * W;
  sc.lnx = ar.take(S * M * C);
  sc.stats1 = ar.take(S * M * 2);
  sc.q = ar.take(S * M * inner);
  sc.k = ar.take(S * M * inner);
  sc.v = ar.take(S * M * inner);
  sc.o = ar.take(S * M * inner);
  sc.y = ar.take(S * M * C);
  sc.lny = ar.take(S * M * C);
  sc.stats2 = ar.take(S * M * 2);
  sc.h = ar.take(S * M * hidden);
  sc.gpre = ar.take(S * M * hidden);
  sc.glny = ar.take(S * M * C);
  sc.gy = ar.take(S * M * C);
  sc.gln = ar.take(S * M * C);
  sc.gm = drop_on(drop, kSiteOut) ? ar.take(S * M * C) : nullptr;
  sc.gproj = drop_on(drop, kSiteProj) ? ar.take(S * M * C) : nullptr;
  sc.glnkv = split_kv ? ar.take(S * M * C) : nullptr;
  const size_t ln_blocks = ln_bwd_blocks(static_cast<int>(M));
  sc.ln1_part = ar.take(S * ln_blocks * 2 * C);
  sc.ln2_part = ar.take(S * ln_blocks * 2 * C);
  sc.w2_plan = wgrad_plan(static_cast<int>(M), hidden, C, S);
  sc.w2_part = ar.take(static_cast<size_t>(S) * sc.w2_plan.chunks * (hidden + 1) * C);
  sc.w1_plan = wgrad_plan(static_cast<int>(M), C, hidden, S);
  sc.w1_part = ar.take(static_cast<size_t>(S) * sc.w1_plan.chunks * (C + 1) * hidden);
  sc.attn = carve_attn_bwd(ar, S, B, H, W, C, heads, d, wh, ww);
  return sc;
}

// The MLP's backward from the gradient gmlp of its output (TG: the block's g, or its
// masked fp32 copy under the MLP-out dropout): g_pre1 = drop(gmlp w2^T) * act'(z), the
// hidden masked in place for w2's gradient, g_lny = g_pre1 w1^T, and the w1, w2 weight
// gradients' partials, whose reductions it queues.
template <typename TG>
bool mlp_bwd(const BlockBwdScratch& sc, const TG* gmlp, const float* const* in,
             float* const* out, ReduceJobs& jobs, int S, int M, int C, int hidden, int hw, int B,
             int act, const DropArgs* drop, cudaStream_t st) {
  const size_t x_stream = static_cast<size_t>(M) * C;
  const size_t m_stream = static_cast<size_t>(M) * hidden;
  GemmBatchT<TG> gpre = {};
  GemmBatch glny = {};
  gpre.act = act;  // GELU: the epilogue replaces z in h with the erf hidden
  for (int s = 0; s < S; ++s) {
    gpre.a[s] = gmlp + s * x_stream;
    gpre.b[s] = in[kW2] + static_cast<size_t>(s) * hidden * C;  // (hidden, C) = (N, K)
    gpre.res[s] = sc.h + s * m_stream;
    gpre.c[s] = sc.gpre + s * m_stream;
    gpre.alpha[s] = 1.0f;

    glny.a[s] = sc.gpre + s * m_stream;
    glny.b[s] = in[kW1] + static_cast<size_t>(s) * C * hidden;  // (C, hidden) = (N, K)
    glny.c[s] = sc.glny + s * x_stream;
    glny.alpha[s] = 1.0f;
  }
  launch_gemm_site<false, false, false, false, true, true>(gpre, M, hidden, C, S, st, drop,
                                                           kSiteHidden, hw, B);
  if (drop_on(drop, kSiteHidden))  // the dropped hidden that fc2 read, for w2's gradient
    launch_dropout_rows(sc.h, sc.h, drop_site(drop, kSiteHidden, hw, B), M, hidden, S, st);
  launch_gemm<false, false, false, false, true>(glny, M, C, hidden, S, st);

  WgradBatchT<float, TG> w2b = {};
  WgradBatch w1b = {};
  for (int s = 0; s < S; ++s) {
    w2b.a[s] = sc.h + s * m_stream;
    w2b.b[s] = gmlp + s * x_stream;
    w2b.part[s] = sc.w2_part + static_cast<size_t>(s) * sc.w2_plan.chunks * (hidden + 1) * C;
    w1b.a[s] = sc.lny + s * x_stream;
    w1b.b[s] = sc.gpre + s * m_stream;
    w1b.part[s] = sc.w1_part + static_cast<size_t>(s) * sc.w1_plan.chunks * (C + 1) * hidden;
  }
  launch_wgrad(w2b, sc.w2_plan, M, hidden, C, S, st);
  launch_wgrad(w1b, sc.w1_plan, M, C, hidden, S, st);
  bool ok = true;
  for (int s = 0; s < S; ++s) {
    ok &= jobs.add(w2b.part[s], sc.w2_plan.chunks, (hidden + 1) * C, hidden * C,
                   out[kW2] + static_cast<size_t>(s) * hidden * C, out[kB2] + static_cast<size_t>(s) * C);
    ok &= jobs.add(w1b.part[s], sc.w1_plan.chunks, (C + 1) * hidden, C * hidden,
                   out[kW1] + static_cast<size_t>(s) * C * hidden,
                   out[kB1] + static_cast<size_t>(s) * hidden);
  }
  return ok;
}

// The backward with x, g and g_x of type TX (fp32 arithmetic in both: the JAX bodies
// upcast a bf16 x and g). A bf16 g_x under cross is rnd(rnd(g_y + LN1 bwd of the q side)
// + rnd(LN1 bwd of the k/v side that read these rows)), the sum of the JAX kernels' gx
// and gkv outputs in x's dtype; otherwise it is rounded once.
template <bool kWindows, typename TX>
int fused_block_bwd(const float* const* in, float* const* out, float* ws, int S, int B, int H,
                    int W, int C, int heads, int d, int hidden, int wh, int ww, int shift,
                    int cross, float scale, int act, const DropArgs* drop, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<TX, bf16>::value;
  const bool split_kv = kBf16 && cross != 0;
  const int inner = heads * d;
  const int M = B * H * W;
  const size_t x_stream = static_cast<size_t>(M) * C;
  const size_t h_stream = static_cast<size_t>(M) * inner;
  const size_t m_stream = static_cast<size_t>(M) * hidden;
  Arena ar{ws};
  const BlockBwdScratch sc =
      carve_block_bwd(ar, S, B, H, W, C, heads, d, hidden, wh, ww, drop, split_kv);
  const TX* x = reinterpret_cast<const TX*>(in[kX]);
  const TX* g = reinterpret_cast<const TX*>(in[kG]);
  TX* gx = reinterpret_cast<TX*>(out[0]);
  const int hw = H * W;

  // ---- recompute the forward (fp32 throughout, x upcast as it is loaded) ----
  LnBatchT<TX> ln1 = {};
  for (int s = 0; s < S; ++s) {
    ln1.x[s] = x + s * x_stream;
    ln1.gamma[s] = in[kLn1g] + static_cast<size_t>(s) * C;
    ln1.beta[s] = in[kLn1b] + static_cast<size_t>(s) * C;
    ln1.out[s] = sc.lnx + s * x_stream;
    ln1.stats[s] = sc.stats1 + s * 2 * static_cast<size_t>(M);
  }
  launch_ln_fwd(ln1, M, C, S, st);

  launch_gemm<false, false, false>(
      qkv_batch(sc.lnx, in[kWq], in[kBq], in[kWk], in[kBk], in[kWv], in[kBv], sc.q, sc.k, sc.v,
                S, M, C, inner, cross != 0, scale),
      M, inner, C, 3 * S, st);
  cudaError_t err = launch_core<kWindows>(sc.q, sc.k, sc.v, in[kBias], sc.o, S, B, H, W, heads,
                                          d, wh, ww, shift != 0, st, drop);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmBatchT<float, TX, float> proj = {};
  GemmBatch fc1 = {};
  LnBatch ln2 = {};
  fc1.act = recompute_code(act);
  for (int s = 0; s < S; ++s) {
    proj.a[s] = sc.o + s * h_stream;
    proj.b[s] = in[kWp] + static_cast<size_t>(s) * inner * C;
    proj.bias[s] = in[kBp] + static_cast<size_t>(s) * C;
    proj.res[s] = x + s * x_stream;
    proj.c[s] = sc.y + s * x_stream;
    proj.alpha[s] = 1.0f;

    ln2.x[s] = sc.y + s * x_stream;
    ln2.gamma[s] = in[kLn2g] + static_cast<size_t>(s) * C;
    ln2.beta[s] = in[kLn2b] + static_cast<size_t>(s) * C;
    ln2.out[s] = sc.lny + s * x_stream;
    ln2.stats[s] = sc.stats2 + s * 2 * static_cast<size_t>(M);

    fc1.a[s] = sc.lny + s * x_stream;
    fc1.b[s] = in[kW1] + static_cast<size_t>(s) * C * hidden;
    fc1.bias[s] = in[kB1] + static_cast<size_t>(s) * hidden;
    fc1.c[s] = sc.h + s * m_stream;
    fc1.alpha[s] = 1.0f;
  }
  launch_gemm_site<false, false, true>(proj, M, C, inner, S, st, drop, kSiteProj, hw, B);
  launch_ln_fwd(ln2, M, C, S, st);
  launch_gemm<false, true, false>(fc1, M, hidden, C, S, st);  // h (GELU: z) unmasked: act' needs it

  // ---- MLP and LN2 backward; under dropout the MLP sees the masked g ----
  ReduceJobs jobs = {};
  bool ok;
  if (drop_on(drop, kSiteOut)) {
    launch_dropout_rows(g, sc.gm, drop_site(drop, kSiteOut, hw, B), M, C, S, st);
    ok = mlp_bwd(sc, static_cast<const float*>(sc.gm), in, out, jobs, S, M, C, hidden, hw, B,
                 act, drop, st);
  } else {
    ok = mlp_bwd(sc, g, in, out, jobs, S, M, C, hidden, hw, B, act, drop, st);
  }
  LnBwdBatchT<float, TX, float> ln2b = {};
  for (int s = 0; s < S; ++s) {
    ln2b.g[s] = sc.glny + s * x_stream;
    ln2b.x[s] = sc.y + s * x_stream;
    ln2b.stats[s] = sc.stats2 + s * 2 * static_cast<size_t>(M);
    ln2b.gamma[s] = in[kLn2g] + static_cast<size_t>(s) * C;
    ln2b.res[s] = g + s * x_stream;
    ln2b.gx[s] = sc.gy + s * x_stream;
    ln2b.part[s] = sc.ln2_part + s * static_cast<size_t>(ln_bwd_blocks(M)) * 2 * C;
  }
  launch_ln_bwd(ln2b, M, C, S, st);

  // ---- attention backward, into g_ln (and g_lnkv); proj's gradient is g_y through
  // proj's mask ----
  const float* gattn = sc.gy;
  if (drop_on(drop, kSiteProj)) {
    launch_dropout_rows(sc.gy, sc.gproj, drop_site(drop, kSiteProj, hw, B), M, C, S, st);
    gattn = sc.gproj;
  }
  const AttnGrads ag = {out[kWq], out[kBq], out[kWk], out[kBk], out[kWv],
                        out[kBv], out[kWp], out[kBp], out[kBias]};
  err = attention_bwd<kWindows>(sc.attn, static_cast<const float*>(sc.lnx), sc.q, sc.k, sc.v,
                                sc.o, gattn, in[kWq], in[kWk], in[kWv], in[kWp], in[kBias],
                                sc.gln, sc.glnkv, ag, jobs, S, B, H, W, C, heads, d, wh, ww,
                                shift != 0, cross != 0, scale, st, drop);
  if (err != cudaSuccess) return static_cast<int>(err);

  // ---- LN1 backward: g_x = g_y + LN1 bwd(g_ln) ----
  LnBwdBatchT<TX, float, TX> ln1b = {};
  for (int s = 0; s < S; ++s) {
    ln1b.g[s] = sc.gln + s * x_stream;
    if (split_kv) ln1b.g2[s] = sc.glnkv + s * x_stream;
    ln1b.x[s] = x + s * x_stream;
    ln1b.stats[s] = sc.stats1 + s * 2 * static_cast<size_t>(M);
    ln1b.gamma[s] = in[kLn1g] + static_cast<size_t>(s) * C;
    ln1b.res[s] = sc.gy + s * x_stream;
    ln1b.gx[s] = gx + s * x_stream;
    ln1b.part[s] = sc.ln1_part + s * static_cast<size_t>(ln_bwd_blocks(M)) * 2 * C;
  }
  if (split_kv) launch_ln_bwd<true>(ln1b, M, C, S, st);
  else launch_ln_bwd(ln1b, M, C, S, st);

  // ---- every reduction ----
  const int ln_chunks = ln_bwd_blocks(M);
  for (int s = 0; s < S; ++s) {
    ok &= jobs.add(ln2b.part[s], ln_chunks, 2 * C, C, out[kLn2g] + static_cast<size_t>(s) * C,
                   out[kLn2b] + static_cast<size_t>(s) * C);
    ok &= jobs.add(ln1b.part[s], ln_chunks, 2 * C, C, out[kLn1g] + static_cast<size_t>(s) * C,
                   out[kLn1b] + static_cast<size_t>(s) * C);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  launch_reduce(jobs, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one attention-core block, in bytes, with the dropout's per-token arrays
// when `drop` is set.
size_t swin_fused_block_fwd_smem(int d, int wh, int ww, int drop) {
  return core_smem_bytes(d, wh, ww, drop != 0);
}

// One block on `stream`. H, W are the block's map (the window-multiple stage map, also
// under the windows layout, where the tokens of each (s, b) are H*W in window order).
// x and out are fp32, or bf16 when `bf16_io` is set (K4's rounding under the image layout,
// K1's under the windows layout). q, k, v are (S, M, heads*d) fp32 scratch, o the same
// and hid (S, M, hidden) bf16 for K4 in bf16 and fp32 otherwise, y (S, M, C) fp32 scratch
// that may be `out` in fp32; M = B*H*W. `out` must not alias x. `drop`: the dropout's
// arguments, or nullptr for none. Returns cudaGetLastError() after the launches (0 = ok).
int swin_fused_block_fwd(const void* x, const float* ln1g, const float* ln1b, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, const float* wp, const float* bp, const float* bias,
                         const float* ln2g, const float* ln2b, const float* w1, const float* b1,
                         const float* w2, const float* b2, void* out, float* q, float* k,
                         float* v, void* o, void* hid, float* y, const DropArgs* drop, int S,
                         int B, int H, int W, int C, int heads, int d, int hidden, int wh,
                         int ww, int shift, int cross, int windows, int bf16_io, float scale,
                         int act, void* stream) {
  if (S * 3 > kMaxBatch || !activation_ok(act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launcher = decltype(&fused_block<true, float, false>);
  const Launcher run = !bf16_io ? (windows ? &fused_block<true, float, false>
                                           : &fused_block<false, float, false>)
                                : (windows ? &fused_block<true, bf16, false>    // K1
                                           : &fused_block<false, bf16, true>);  // K4
  return run(x, ln1g, ln1b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2g, ln2b, w1, b1, w2, b2,
             out, q, k, v, o, hid, y, S, B, H, W, C, heads, d, hidden, wh, ww, shift, cross,
             scale, act, drop, st);
}

// Floats of scratch the backward needs for one block of these dimensions, dropout, dtype
// and mode.
size_t swin_fused_block_bwd_workspace(int S, int B, int H, int W, int C, int heads, int d,
                                      int hidden, int wh, int ww, const DropArgs* drop,
                                      int bf16_io, int cross) {
  Arena ar{nullptr};
  carve_block_bwd(ar, S, B, H, W, C, heads, d, hidden, wh, ww, drop, bf16_io != 0 && cross != 0);
  return ar.used;
}

// The block's backward on `stream`. in: x, the 17 weights in the forward's order, then
// g = dL/d out (same shape as x); out: g_x, then the 17 weight gradients in that order
// and shapes. x, g and g_x are fp32, or bf16 when `bf16_io` is set; the weights and their
// gradients are fp32. ws: swin_fused_block_bwd_workspace(...) floats of scratch. `drop`:
// the forward's dropout arguments, or nullptr. Every output is written in full. Returns
// cudaGetLastError() after the launches (0 = ok).
int swin_fused_block_bwd(const float* const* in, float* const* out, float* ws,
                         const DropArgs* drop, int S, int B, int H, int W, int C, int heads,
                         int d, int hidden, int wh, int ww, int shift, int cross, int windows,
                         int bf16_io, float scale, int act, void* stream) {
  if (S * 3 > kMaxBatch || C > kLnMaxC || !activation_ok(act)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launcher = decltype(&fused_block_bwd<true, float>);
  const Launcher run = bf16_io ? (windows ? &fused_block_bwd<true, bf16>     // K1 bf16
                                          : &fused_block_bwd<false, bf16>)   // K4 bf16
                               : (windows ? &fused_block_bwd<true, float>
                                          : &fused_block_bwd<false, float>);
  return run(in, out, ws, S, B, H, W, C, heads, d, hidden, wh, ww, shift, cross, scale, act,
             drop, st);
}

}  // extern "C"
