// Swin window attention (K3), the forward at any window of up to 64 tokens (8x8, 4x4, 7x8, ...),
// with and without dropout, fp32 and bf16, for Hopper (sm_90a).
//
// Replaces swin_unet_image_fusion_tpu/ops/pallas_attention.py::_attention_fwd_kernel (its
// pallas_call at l.756) at every window other than 7x7: pallas_window_attention takes any
// window, padding T = wh * ww to a multiple of 8 (l.602-603). The kernels and the launches are
// window_attention_fwd.cu's, built here in window_fwd.cuh's any-window class: T, wh and ww are
// arguments of the launch, a block holds up to 64 token rows (eight fp32 row groups of 8 x 8
// register tiles; the bf16 forms' mma rows are 64 in both classes), the keys' loops and masks run
// to T, and the relative-position bias is (S, T, T). The 7x7 build keeps its compile-time T = 49,
// so its code and its bits stay as they were; ops/window_attention.py::fwd_plan picks this
// library for any other window. What bounds the forward and why the design is so: the header of
// window_attention_fwd.cu.
#define SWIN_ANY_WINDOW 1
#include "window_attention_fwd.cu"
