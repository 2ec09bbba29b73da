// Hash-dropout masks of the composition's sites, fp32 or bf16, for Hopper (sm_90a).
//
// The JAX package applies flax's nn.Dropout where a block runs outside its Pallas kernels
// (swin_unet_image_fusion_tpu/models/layers.py:248 on the attention weights, l.259 and
// l.331 on the projection's output, l.365 and l.367 on the MLP's hidden and output). The
// port draws those masks from the kernels' counter-based hash instead (hash_dropout.cuh),
// keyed on K4's geometry (ops/dropout_layout.py, "k4"), so a dropout step is the same
// function on the CPU and on a card. Each mask is one launch here, where the plain version
// (ops/dropout_layout.py's masks on int64 tensors) takes some 25 elementwise launches:
//   dropout_rows_kernel  (window_core.cuh) a token site on (S, B*H*W, cols) rows in image
//                        order: the projection's output, the MLP hidden and the MLP output;
//                        a group of threads a token row, its unit hash once, the columns in
//                        16-byte vectors (swin_dropout_tokens_elementwise keeps the first
//                        form, a thread an element, for the timings in turns alone);
//   dropout_attn_kernel  the attention weights (S, B*nWin, heads, T, T) of the composition's
//                        windows, whose tokens' (unit, slot) a (nWin, T) table gives.
// out = keep ? in * scale : 0, with scale = float32(1 / (1 - rate)): the plain version's
// torch.where(keep, x * scale, 0) bit for bit. In bf16 (the composition of a bf16 training
// step) the product is taken in fp32 and rounded once, as PyTorch multiplies a bf16
// tensor by a float. The backward of a mask is the same launch on the output's gradient.
// `out` may be `in`.
//
// What bounds it: each element is read and written once (8 bytes in fp32, 4 in bf16)
// against ~11 integer operations of the hash, so device memory bounds it.

#include "window_core.cuh"

using namespace swin;

namespace {

constexpr int kAttnThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    dropout_attn_kernel(const T* in, T* out, DropSite d, const int2* windows, int n_win, int t,
                        int heads) {
  const size_t per_stream = static_cast<size_t>(d.B) * n_win * heads * t * t;
  const size_t i = static_cast<size_t>(blockIdx.x) * kAttnThreads + threadIdx.x;
  if (i >= per_stream) return;
  const int tk = static_cast<int>(i % t);
  const size_t row = i / t;  // (b, window, head, tq)
  const int tq = static_cast<int>(row % t);
  const size_t bwh = row / t;
  const int h = static_cast<int>(bwh % heads);
  const size_t bw = bwh / heads;
  const int b = static_cast<int>(bw / n_win), w = static_cast<int>(bw % n_win);
  const int2 eq = windows[w * t + tq], ek = windows[w * t + tk];
  const uint32_t unit = (blockIdx.y * static_cast<uint32_t>(d.B) + static_cast<uint32_t>(b)) *
                            static_cast<uint32_t>(d.units) + static_cast<uint32_t>(eq.x);
  const size_t at = blockIdx.y * per_stream + i;
  const float v = to_float(in[at]);
  out[at] = from_float<T>(
      hash_keep(fmix32(unit ^ d.base), attn_intra(d, h, eq.y, ek.y, heads), d.threshold)
          ? v * d.scale : 0.0f);
}

}  // namespace

extern "C" {

// The mask of token site `site` (kSiteProj, kSiteHidden or kSiteOut) applied to `in`
// (S, B, H*W tokens in image order, cols) into `out`, both fp32 or both bf16 (`bf16`), on
// `stream`. drop->table holds each token's (unit, slot). Returns cudaGetLastError() after
// the launch (0 = ok).
int swin_dropout_tokens(const void* in, void* out, const DropArgs* drop, int site, int S, int B,
                        int hw, int cols, int bf16_io, void* stream) {
  if (site <= kSiteAttn || site >= kNumSites || !drop_on(drop, site))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(B) * hw * cols == 0) return 0;
  const DropSite d = drop_site(drop, site, hw, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_io)
    launch_dropout_rows(static_cast<const bf16*>(in), static_cast<bf16*>(out), d, B * hw, cols, S,
                        st);
  else
    launch_dropout_rows(static_cast<const float*>(in), static_cast<float*>(out), d, B * hw, cols,
                        S, st);
  return static_cast<int>(cudaGetLastError());
}

// swin_dropout_tokens with the first form of the kernel (a thread an element): the same
// result, for chip_smoke.py's timings in turns; no call of the model launches it.
int swin_dropout_tokens_elementwise(const void* in, void* out, const DropArgs* drop, int site,
                                    int S, int B, int hw, int cols, int bf16_io, void* stream) {
  if (site <= kSiteAttn || site >= kNumSites || !drop_on(drop, site))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(B) * hw * cols == 0) return 0;
  const DropSite d = drop_site(drop, site, hw, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_io)
    launch_dropout_rows_elementwise(static_cast<const bf16*>(in), static_cast<bf16*>(out), d,
                                    B * hw, cols, S, st);
  else
    launch_dropout_rows_elementwise(static_cast<const float*>(in), static_cast<float*>(out), d,
                                    B * hw, cols, S, st);
  return static_cast<int>(cudaGetLastError());
}

// The attention site's mask applied to the weights `in` (S, B*n_win, heads, t, t) into
// `out`, both fp32 or both bf16 (`bf16`), on `stream`; `windows` (n_win, t, 2) holds the
// (unit, slot) of each window's tokens. Returns cudaGetLastError() after the launch (0 = ok).
int swin_dropout_attention(const void* in, void* out, const DropArgs* drop, const int* windows,
                           int S, int B, int n_win, int t, int heads, int bf16_io, void* stream) {
  if (!drop_on(drop, kSiteAttn)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(B) * n_win * heads * t * t;
  if (n == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kAttnThreads - 1) / kAttnThreads), S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DropSite d = drop_site(drop, kSiteAttn, 0, B);
  const int2* win = reinterpret_cast<const int2*>(windows);
  if (bf16_io)
    dropout_attn_kernel<<<grid, kAttnThreads, 0, st>>>(static_cast<const bf16*>(in),
                                                       static_cast<bf16*>(out), d, win, n_win, t,
                                                       heads);
  else
    dropout_attn_kernel<<<grid, kAttnThreads, 0, st>>>(static_cast<const float*>(in),
                                                       static_cast<float*>(out), d, win, n_win, t,
                                                       heads);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
