// Fused pre-norm Swin block, the forward (K4 and K1), fp32 and bf16, the forms without dropout:
// a call with dropout arguments returns cudaErrorInvalidValue (it goes to fused_block_fwd_drop.cu).
// The kernels, their design and what bounds them are fused_block_fwd.cuh's; the two libraries
// export the same C interface and build at once.

#include "fused_block_fwd.cuh"

extern "C" {

const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory in bytes of one block of kernel `kind` (0 the one-launch block, 1 the split
// route's attention, 2 its projection and fc2, 3 its fc1, 4 its LN1 and LN2 passes, which
// have none), with bf16 operands (K4 bf16) or fp32 ones (fp32, and K1 in either I/O type), in
// the dropout form with `drop` set, or 0 where the kernels do not take the dimensions.
size_t swin_k4_fwd_smem(int kind, int bf16_ops, int cross, int C, int inner, int heads, int d, int hidden,
                        int hg, int hc, int drop) {
  return k4_fwd_smem(kind, bf16_ops, cross, C, inner, heads, d, hidden, hg, hc, drop);
}

// The block's forward on `stream`, with dropout where `drop` (ops/dropout_layout.py's keying of
// the layout: K4's for the image, K1's for the windows; a site off is the identity) is not
// nullptr: x and out fp32, or bf16 when `bf16_io` is set, (S, B, H, W, C) in the image layout
// or (S, B, nWin, 49, C) in the windows layout (`windows`); `bf16_ops`: K4's rounding (bf16
// operands; needs bf16_io), else the block in fp32 inside (fp32, and K1 with bf16 I/O: x upcast
// on load, out rounded once on the store); the weights fp32 as fused_block.cu's; 7x7 windows.
// fused: one launch, hc hidden columns per MLP step (ln, av, y and hid unused, may be null);
// else hg heads per attention block and hc hidden columns per fc1 block, with the scratch ln
// (S*B, H*W, C), av (S*B, windows, 49, heads*d) and hid (S*B, H*W, hidden) in the operands'
// type and y (S*B, H*W, C) fp32. `shift`: 0 the normal partition, 1 the shifted one, 2
// (windows layout only) the shifted windows of a band of whole window rows that does not hold
// the map's first: the rolled-row seam (row region "rolled row < 4") lies outside the band, so
// top = 0 and only the column seam is masked (ops/window_pack_spmd.py). `top` enters nothing
// else in the windows layout (window_fwd.cuh::window_rows). `act`: the MLP's activation
// (activation.cuh: 0 ELU, 1 ReLU, 2 GELU in the tanh form). Returns cudaGetLastError() after
// the launches (0 = ok), cudaErrorInvalidValue on dimensions the kernels do not take.
int swin_k4_fwd(const void* x, const float* ln1g, const float* ln1b, const float* wq, const float* bq,
                const float* wk, const float* bk, const float* wv, const float* bv, const float* wp,
                const float* bp, const float* bias, const float* ln2g, const float* ln2b, const float* w1,
                const float* b1, const float* w2, const float* b2, void* out, void* ln, void* av, float* y,
                void* hid, const swin::DropArgs* drop,
                int S, int B, int H, int W, int C, int heads, int d, int hidden, int hg, int hc, int fused,
                int shift, int cross, int windows, int bf16_io, int bf16_ops, float scale, int act, void* stream) {
  return k4_fwd<false>(x, ln1g, ln1b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2g, ln2b, w1, b1, w2, b2, out, ln, av,
                       y, hid, drop, S, B, H, W, C, heads, d, hidden, hg, hc, fused, shift, cross, windows, bf16_io,
                       bf16_ops, scale, act, stream);
}

}  // extern "C"
