// Swin window attention, forward in fp32 or bf16, for Hopper (sm_90a).
//
// Replaces swin_unet_image_fusion_tpu/ops/pallas_attention.py::_attention_fwd_kernel
// (entered through _attention_fwd_kernel_self / _attention_fwd_kernel_cross from
// pallas_window_attention's _forward). It computes, per window and stream: q/k/v
// projections (+bias, the scale folded into q), scores q.k plus the shared relative-
// position bias, the shift mask that SETS scores to -1e10, the TPU kernel's fast softmax
// (one-sided clamp at 80, exp without max subtraction, multiply by 1/(sum + 1e-30)), AV,
// and the output projection + bias. Cross attention takes k/v from the other stream's
// tokens of the same input, with this stream's weights.
//
// Layout. x and out are (S, B, H, W, C), fp32 or bf16, with H, W multiples of the window. The
// window partition and the shifted partition are address arithmetic: the shifted grid
// is the map rolled by (top, left) = (wh - wh/2, ww - ww/2), so token (i, j) of window
// (wr, wc) is pixel ((wr*wh + i - top) mod H, (wc*ww + j - left) mod W). The wrap seams
// are masked by region: a token's region is whether its rolled row is < top and whether
// its rolled column is < left; scores between regions are set to -1e10, whose exp is
// exactly 0. Without shift, top = left = 0 and all tokens share one region.
//
// What bounds it, and the design. At the model's shapes (C = 24..384, d = C/8 = 3..48,
// T = 49) the work is ~8*T*C^2 + 4*T^2*C FLOP per window against 16*T*C bytes in and out:
// the fp32 rate bounds it, not device memory. A call WITHOUT dropout runs the redesigned
// forward of window_attention_fwd.cu (one launch at C <= 64, two above: a block per window
// holds q, k, v in shared memory; see that file). This file keeps the three launches that
// the dropout forms run and that the backward recomputes:
//   1. one batched tiled GEMM computes q (scaled), k and v for both streams into
//      (S, B, H, W, inner) scratch, k/v from the other stream under cross;
//   2. one block per (window, stream*batch, head) gathers that head's q/k/v tokens,
//      keeps the (T, T) probabilities in shared memory and writes AV to scratch;
//   3. one batched tiled GEMM applies the output projection + bias.
// Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W), a 512² request's 40 calls spent 8.8
// ms in them, 6.0 ms of it in launch 2 (chip_smoke.py's [split] lines; PERF.md). The GEMM
// and the core kernel live in window_core.cuh, shared with the fused block (fused_block.cu).
//
// bf16 (the TPU kernel with a bf16 x, as the JAX package serves). The weights stay fp32 in
// memory and are rounded to bf16 as the GEMMs load them, as the TPU body casts them
// (pallas_attention.py:311-313, 328): no extra launch and no cached copy. q, k, v (+ the
// fp32 biases), the scores and the fast softmax stay fp32; p and v are rounded before AV
// (l.325) and AV is stored rounded (l.327); the projection sums in fp32, adds bp and
// rounds once on the store (l.331-332). The same three launches, on half the activation
// bytes; the FMAs stay fp32 here (window_attention_fwd.cu runs these products on the
// tensor cores for a call without dropout).
//
// Backward (swin_window_attention_bwd) replaces
// pallas_attention.py::_attention_bwd_body (through _attention_bwd_kernel /
// _attention_bwd_kernel_self from pallas_window_attention's _backward). Given x, the
// weights and g = dL/d out it recomputes q/k/v and AV (launches 1-2 above), then runs the
// attention half of window_core_bwd.cuh, shared with the fused block: g_o = g wp^T, the
// core backward (g_q, g_k, g_v and per-block partials of the (S, T, T) bias gradient),
// g_x[r] = g_q[r] wq[r]^T + g_k[kv(r)] wk[kv(r)]^T + g_v[kv(r)] wv[kv(r)]^T (under cross
// the k/v gradients go to the other stream's rows, pallas_attention.py:816-819), the
// weight gradients as [rows | 1]^T g over every token, and one fixed-order reduction
// launch for every weight, bias and relative-position bias gradient. Like the forward it
// is bound by the fp32 rate, at about three times the forward's matmul work.
// bf16 backward (training at compute_dtype=bfloat16): the JAX body upcasts x, kv and g
// and runs the recompute and the backward in fp32 with fp32 weights (l.388-390, 432-435),
// so this is the fp32 backward with x and g upcast as they are loaded (the recompute does
// not take the bf16 forward's rounding points); the weight gradients stay fp32 and g_x is
// rounded once from the fp32 sums by one more elementwise launch: rnd(q side + k/v side)
// in self mode, rnd(rnd(q side) + rnd(k/v side)) under cross, where JAX writes gx and gkv
// in x's dtype (l.495-498) and its caller adds the two in bf16.
//
// Dropout (training, the TPU kernels' seed_ref paths, l.278-290, 322-323, 366-382): with the
// attention site of `drop` on, the core masks p before AV with the hash masks of
// hash_dropout.cuh keyed on the wrap windows (ops/dropout_layout.py, "k3"), and the
// backward's recompute and core backward apply the same masks. The projection's dropout is
// the caller's, on the output, as in the JAX package. The hash adds ~11 integer operations
// per attention weight to a core that is bound by its per-head products.

#include <type_traits>

#include "window_core_bwd.cuh"

using namespace swin;

namespace {

// The three launches with x, out and AV of type T (float or bf16); bf16 rounds the
// products' operands (kBf16Ops).
template <typename T>
int attention_fwd(const void* xv, const float* wq, const float* bq, const float* wk,
                  const float* bk, const float* wv, const float* bv, const float* wp,
                  const float* bp, const float* bias, void* outv, float* q, float* k, float* v,
                  void* ov, int S, int B, int H, int W, int C, int heads, int d, int wh, int ww,
                  int shift, int cross, float scale, const DropArgs* drop, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const T* x = static_cast<const T*>(xv);
  T* out = static_cast<T*>(outv);
  T* o = static_cast<T*>(ov);
  const int inner = heads * d;
  const int M = B * H * W;  // tokens per stream
  const size_t x_stream = static_cast<size_t>(M) * C;
  const size_t h_stream = static_cast<size_t>(M) * inner;

  launch_gemm<false, false, false, true, false, false, kBf16>(
      qkv_batch(x, wq, bq, wk, bk, wv, bv, q, k, v, S, M, C, inner, cross != 0, scale), M,
      inner, C, 3 * S, st);

  const cudaError_t err = launch_core<false, kBf16>(q, k, v, bias, o, S, B, H, W, heads, d, wh,
                                                    ww, shift != 0, st, drop);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmBatchT<T, float, T> proj = {};
  for (int s = 0; s < S; ++s) {
    proj.a[s] = o + s * h_stream;
    proj.b[s] = wp + static_cast<size_t>(s) * inner * C;
    proj.bias[s] = bp + static_cast<size_t>(s) * C;
    proj.c[s] = out + s * x_stream;
    proj.alpha[s] = 1.0f;
  }
  launch_gemm<false, false, false, true, false, false, kBf16>(proj, M, C, inner, S, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one attention-core block, in bytes, with the dropout's per-token
// arrays when `drop` is set.
size_t swin_window_attention_fwd_smem(int d, int wh, int ww, int drop) {
  return core_smem_bytes(d, wh, ww, drop != 0);
}

// Launches the three kernels on `stream`. x and out are fp32, or bf16 when `bf16` is set;
// q, k, v are (S, B, H, W, heads*d) fp32 scratch and o (AV) the same in x's type. `drop`:
// the dropout's arguments (its attention site), or nullptr for none. Returns
// cudaGetLastError() after the launches (0 = ok).
int swin_window_attention_fwd(const void* x, const float* wq, const float* bq, const float* wk,
                              const float* bk, const float* wv, const float* bv, const float* wp,
                              const float* bp, const float* bias, void* out, float* q, float* k,
                              float* v, void* o, const DropArgs* drop, int S, int B, int H, int W,
                              int C, int heads, int d, int wh, int ww, int shift, int cross,
                              int bf16_io, float scale, void* stream) {
  if (S * 3 > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = bf16_io ? &attention_fwd<bf16> : &attention_fwd<float>;
  return run(x, wq, bq, wk, bk, wv, bv, wp, bp, bias, out, q, k, v, o, S, B, H, W, C, heads, d,
             wh, ww, shift, cross, scale, drop, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

namespace {

// Argument slots of the backward, in the forward's order (ops/window_attention.py).
enum In { kX, kWq, kBq, kWk, kBk, kWv, kBv, kWp, kBp, kBias, kG, kNumIn };
// outputs: g_x, then the gradient of each weight in slot order (out[w] for In w)

struct AttentionBwdScratch {
  float *q, *k, *v, *o;
  float *gx, *gkv;  // bf16 only: the fp32 q-side (all of g_x in self mode) and k/v-side sums
  AttnBwdScratch attn;
};

AttentionBwdScratch carve_attention_bwd(Arena& ar, int S, int B, int H, int W, int C,
                                        int heads, int d, int wh, int ww, bool bf16,
                                        bool cross) {
  AttentionBwdScratch sc;
  const size_t n = static_cast<size_t>(S) * B * H * W * heads * d;
  const size_t nx = static_cast<size_t>(S) * B * H * W * C;
  sc.q = ar.take(n);
  sc.k = ar.take(n);
  sc.v = ar.take(n);
  sc.o = ar.take(n);
  sc.gx = bf16 ? ar.take(nx) : nullptr;
  sc.gkv = bf16 && cross ? ar.take(nx) : nullptr;
  sc.attn = carve_attn_bwd(ar, S, B, H, W, C, heads, d, wh, ww);
  return sc;
}

// The backward with x, g and g_x of type T; the arithmetic is fp32 in both (the JAX body
// upcasts a bf16 x and g, l.388-390), and a bf16 g_x is rounded once from the fp32 sums:
// rnd(q side + k/v side) in self mode, rnd(rnd(q side) + rnd(k/v side)) under cross, as
// the JAX kernel writes its gx and gkv in x's dtype and the caller adds them (l.495-498).
template <typename T>
int attention_bwd_as(const float* const* in, float* const* out, float* ws, const DropArgs* drop,
                     int S, int B, int H, int W, int C, int heads, int d, int wh, int ww,
                     int shift, int cross, float scale, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  const T* x = reinterpret_cast<const T*>(in[kX]);
  const T* g = reinterpret_cast<const T*>(in[kG]);
  const int inner = heads * d;
  const int M = B * H * W;
  Arena ar{ws};
  const AttentionBwdScratch sc =
      carve_attention_bwd(ar, S, B, H, W, C, heads, d, wh, ww, kBf16, cross != 0);

  launch_gemm<false, false, false>(
      qkv_batch(x, in[kWq], in[kBq], in[kWk], in[kBk], in[kWv], in[kBv], sc.q, sc.k, sc.v, S, M,
                C, inner, cross != 0, scale),
      M, inner, C, 3 * S, st);
  cudaError_t err = launch_core<false>(sc.q, sc.k, sc.v, in[kBias], sc.o, S, B, H, W, heads, d,
                                       wh, ww, shift != 0, st, drop);
  if (err != cudaSuccess) return static_cast<int>(err);

  ReduceJobs jobs = {};
  const AttnGrads ag = {out[kWq], out[kBq], out[kWk], out[kBk], out[kWv],
                        out[kBv], out[kWp], out[kBp], out[kBias]};
  err = attention_bwd<false>(sc.attn, x, sc.q, sc.k, sc.v, sc.o, g, in[kWq], in[kWk], in[kWv],
                             in[kWp], in[kBias], kBf16 ? sc.gx : out[0], sc.gkv, ag, jobs, S, B,
                             H, W, C, heads, d, wh, ww, shift != 0, cross != 0, scale, st, drop);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kBf16)
    launch_store_rounded(sc.gx, sc.gkv, reinterpret_cast<bf16*>(out[0]),
                         static_cast<size_t>(S) * M * C, st);
  launch_reduce(jobs, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of scratch the backward needs for these dimensions, dtype and mode.
size_t swin_window_attention_bwd_workspace(int S, int B, int H, int W, int C, int heads, int d,
                                           int wh, int ww, int bf16_io, int cross) {
  Arena ar{nullptr};
  carve_attention_bwd(ar, S, B, H, W, C, heads, d, wh, ww, bf16_io != 0, cross != 0);
  return ar.used;
}

// The backward on `stream`. in: x, wq, bq, wk, bk, wv, bv, wp, bp, bias, then
// g = dL/d out; out: g_x, then the gradients of those nine weights in that order and
// shapes. x, g and g_x are fp32, or bf16 when `bf16_io` is set; the weights and their
// gradients are fp32. ws: swin_window_attention_bwd_workspace(...) floats of scratch.
// `drop`: the forward's dropout arguments, or nullptr. Every output is written in full.
// Returns cudaGetLastError() after the launches (0 = ok).
int swin_window_attention_bwd(const float* const* in, float* const* out, float* ws,
                              const DropArgs* drop, int S, int B, int H, int W, int C, int heads,
                              int d, int wh, int ww, int shift, int cross, int bf16_io,
                              float scale, void* stream) {
  if (S * 3 > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = bf16_io ? &attention_bwd_as<bf16> : &attention_bwd_as<float>;
  return run(in, out, ws, drop, S, B, H, W, C, heads, d, wh, ww, shift, cross, scale,
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
