// Fused pre-norm Swin block, forward, fp32, for Hopper (sm_90a).
//
// Replaces two TPU kernels that compute the same function:
//   K1  swin_unet_image_fusion_tpu/ops/pallas_pack.py::_packed_block_fwd_body (entered
//       through _packed_fwd_kernel / _packed_fwd_kernel_self from
//       pallas_packed_block_strips), on window-packed tokens;
//   K4  swin_unet_image_fusion_tpu/ops/pallas_block.py::_block_fwd_body (entered through
//       _block_fwd_kernel / _block_fwd_kernel_self from pallas_fused_block), on the image.
// One whole BasicBlock per call, for both streams at once:
//   y   = x + proj(attention(LN1(x), kv)) + bp
//   out = y + fc2(ELU(fc1(LN2(y)) + b1)) + b2
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
//   4. fc1 GEMM with LN2 in its prologue, + b1, ELU in its epilogue, into `hid`;
//   5. fc2 GEMM + b2 + the residual y, in place in `out`.
// Every block is small and the card is full at every stage; the price is writing q, k,
// v, AV and the hidden activations to device memory once (mostly L2-resident at these
// sizes). fp32 FMA throughout; TF32 and the tensor cores are off.

#include "window_core.cuh"

using namespace swin;

namespace {

// Launch sequence of one block; returns cudaGetLastError() after it (0 = ok).
template <bool kWindows>
int fused_block(const float* x, const float* ln1g, const float* ln1b, const float* wq,
                const float* bq, const float* wk, const float* bk, const float* wv,
                const float* bv, const float* wp, const float* bp, const float* bias,
                const float* ln2g, const float* ln2b, const float* w1, const float* b1,
                const float* w2, const float* b2, float* out, float* q, float* k, float* v,
                float* o, float* hid, int S, int B, int H, int W, int C, int heads, int d,
                int hidden, int wh, int ww, int shift, int cross, float scale,
                cudaStream_t st) {
  const int inner = heads * d;
  const int M = B * H * W;  // tokens per stream
  const size_t x_stream = static_cast<size_t>(M) * C;
  const size_t h_stream = static_cast<size_t>(M) * inner;
  const size_t m_stream = static_cast<size_t>(M) * hidden;

  GemmBatch qkv = {};
  for (int s = 0; s < S; ++s) {
    const int s_kv = cross ? S - 1 - s : s;
    const float* w[3] = {wq, wk, wv};
    const float* bb[3] = {bq, bk, bv};
    float* dst[3] = {q, k, v};
    for (int part = 0; part < 3; ++part) {
      const int z = s * 3 + part;
      const int src = part == 0 ? s : s_kv;
      qkv.a[z] = x + src * x_stream;
      qkv.ln_g[z] = ln1g + static_cast<size_t>(src) * C;
      qkv.ln_b[z] = ln1b + static_cast<size_t>(src) * C;
      qkv.b[z] = w[part] + static_cast<size_t>(s) * C * inner;
      qkv.bias[z] = bb[part] + static_cast<size_t>(s) * inner;
      qkv.c[z] = dst[part] + s * h_stream;
      qkv.alpha[z] = part == 0 ? scale : 1.0f;
    }
  }
  launch_gemm<true, false, false>(qkv, M, inner, C, 3 * S, st);

  const cudaError_t err = launch_core<kWindows>(q, k, v, bias, o, S, B, H, W, heads, d, wh,
                                                ww, shift != 0, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  GemmBatch proj = {}, fc1 = {}, fc2 = {};
  for (int s = 0; s < S; ++s) {
    proj.a[s] = o + s * h_stream;
    proj.b[s] = wp + static_cast<size_t>(s) * inner * C;
    proj.bias[s] = bp + static_cast<size_t>(s) * C;
    proj.res[s] = x + s * x_stream;
    proj.c[s] = out + s * x_stream;
    proj.alpha[s] = 1.0f;

    fc1.a[s] = out + s * x_stream;
    fc1.ln_g[s] = ln2g + static_cast<size_t>(s) * C;
    fc1.ln_b[s] = ln2b + static_cast<size_t>(s) * C;
    fc1.b[s] = w1 + static_cast<size_t>(s) * C * hidden;
    fc1.bias[s] = b1 + static_cast<size_t>(s) * hidden;
    fc1.c[s] = hid + s * m_stream;
    fc1.alpha[s] = 1.0f;

    fc2.a[s] = hid + s * m_stream;
    fc2.b[s] = w2 + static_cast<size_t>(s) * hidden * C;
    fc2.bias[s] = b2 + static_cast<size_t>(s) * C;
    fc2.res[s] = out + s * x_stream;
    fc2.c[s] = out + s * x_stream;
    fc2.alpha[s] = 1.0f;
  }
  launch_gemm<false, false, true>(proj, M, C, inner, S, st);
  launch_gemm<true, true, false>(fc1, M, hidden, C, S, st);
  launch_gemm<false, false, true>(fc2, M, C, hidden, S, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory of one attention-core block, in bytes.
size_t swin_fused_block_fwd_smem(int d, int wh, int ww) { return core_smem_bytes(d, wh, ww); }

// One block on `stream`. H, W are the block's map (the window-multiple stage map, also
// under the windows layout, where the tokens of each (s, b) are H*W in window order).
// q, k, v, o are (S, M, heads*d) and hid (S, M, hidden) scratch, M = B*H*W. `out` must not
// alias x. Returns cudaGetLastError() after the launches (0 = ok).
int swin_fused_block_fwd(const float* x, const float* ln1g, const float* ln1b, const float* wq,
                         const float* bq, const float* wk, const float* bk, const float* wv,
                         const float* bv, const float* wp, const float* bp, const float* bias,
                         const float* ln2g, const float* ln2b, const float* w1, const float* b1,
                         const float* w2, const float* b2, float* out, float* q, float* k,
                         float* v, float* o, float* hid, int S, int B, int H, int W, int C,
                         int heads, int d, int hidden, int wh, int ww, int shift, int cross,
                         int windows, float scale, void* stream) {
  if (S * 3 > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using Launcher = decltype(&fused_block<true>);
  const Launcher run = windows ? &fused_block<true> : &fused_block<false>;
  return run(x, ln1g, ln1b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2g, ln2b, w1, b1, w2, b2,
             out, q, k, v, o, hid, S, B, H, W, C, heads, d, hidden, wh, ww, shift, cross,
             scale, st);
}

}  // extern "C"
