// Swin window attention (K3), the backward's dropout form at any window of up to 64 tokens, fp32
// and bf16, for Hopper (sm_90a): window_attention_bwd_any.cu's build (see its header) with the
// block kernel's kDrop form in place of the form without dropout. The two build at once;
// ops/window_attention.py::WindowClass.bwd_build picks the library by the call's dropout.
#define SWIN_ANY_WINDOW 1
#define SWIN_K3_BWD_DROP 1
#include "window_attention_bwd.cu"
