// Swin window attention (K3), the backward at any window of up to 64 tokens (8x8, 4x4, 7x8, ...),
// without dropout (window_attention_bwd_any_drop.cu builds its dropout form), fp32 and bf16, for
// Hopper (sm_90a).
//
// Replaces swin_unet_image_fusion_tpu/ops/pallas_attention.py::_attention_bwd_body (its
// pallas_call at l.796) at every window other than 7x7. The kernels and the launches are
// window_attention_bwd.cu's, built here in window_fwd.cuh's any-window class: T, wh and ww are
// arguments of the launch; a block's products take 64 rows (eight row groups, register tiles
// up to 8 x 8, so a product of 144 columns still takes one tile a thread); the rows pass gives
// each of a query row's four lanes 16 keys; core_bwd_tiled (d = 48) forms its products on all
// 256 threads in 8-row tiles; a lane sums its bias-table gradient in double (its block walks up
// to twice the 7x7 build's windows); the partials and their reduction are T x T; the g_x kernel
// takes T-token tiles. The 7x7 build keeps its compile-time T = 49, so its code and its bits stay
// as they were; ops/window_attention.py::WindowClass.bwd_build picks this library for any other
// window without dropout. What bounds the backward and why the design is so: the header of
// window_attention_bwd.cu.
#define SWIN_ANY_WINDOW 1
#define SWIN_K3_BWD_DROP 0
#include "window_attention_bwd.cu"
