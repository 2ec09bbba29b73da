// Window re-partition between the normal and the shifted window grid, for Hopper (sm_90a),
// on tokens of any element type (fp32 or bf16).
//
// Replaces swin_unet_image_fusion_tpu/ops/pallas_pack.py::_repart_standalone_call (the
// kernel of repartition_packed_pallas), which moves packed strips between the two grids
// with one-hot tap matmuls over a one-strip-row halo. Here tokens are (S*B, nWin, T, C)
// rows as ops/window_pack.py::pack_windows lays them out, and the change of grid is a
// pure permutation of tokens: the shifted grid is the map rolled by
// (top, left) = (wh - wh/2, ww - ww/2), so token (i, j) of window (wr, wc) holds pixel
// ((wr*wh + i - top) mod H, (wc*ww + j - left) mod W). A token is a row of bytes (C times
// the element size); each thread copies one 16-, 4- or 2-byte piece of a destination
// token from its source slot, the widest that divides the row and the alignment;
// neighbouring threads write neighbouring addresses of a token and of the next token of
// the same window. Bit-exact by construction, in any dtype.
//
// What bounds it: bytes. Each token is read once and written once; there is no
// arithmetic beyond the index computation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Token slot, in the `from` grid, of the pixel that token `tok` holds in the `to` grid.
__device__ __forceinline__ int source_token(int tok, int H, int W, int wh, int ww,
                                            int top_from, int left_from, int top_to,
                                            int left_to) {
  const int T = wh * ww;
  const int nw = W / ww;
  const int win = tok / T, t = tok % T;
  const int rr = (win / nw) * wh + t / ww;  // rolled coordinates in the `to` grid
  const int rc = (win % nw) * ww + t % ww;
  const int ph = (rr - top_to + H) % H;     // the pixel
  const int pw = (rc - left_to + W) % W;
  const int fr = (ph + top_from) % H;       // rolled coordinates in the `from` grid
  const int fc = (pw + left_from) % W;
  return ((fr / wh) * nw + fc / ww) * T + (fr % wh) * ww + fc % ww;
}

template <typename V>
__global__ void __launch_bounds__(kThreads) repartition_kernel(
    const V* __restrict__ in, V* __restrict__ out, int vec, int H, int W, int wh, int ww,
    int top_from, int left_from, int top_to, int left_to) {
  const size_t per_map = static_cast<size_t>(H) * W * vec;  // pieces of one (s, b) map
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= per_map) return;
  const int tok = static_cast<int>(i / vec), piece = static_cast<int>(i % vec);
  const int src = source_token(tok, H, W, wh, ww, top_from, left_from, top_to, left_to);
  const size_t map = static_cast<size_t>(blockIdx.y) * per_map;
  out[map + i] = in[map + static_cast<size_t>(src) * vec + piece];
}

}  // namespace

extern "C" {

// out = `in` re-partitioned from the `from_shift` to the `to_shift` grid; both
// (N, H*W tokens, row_bytes) with N = S*B and row_bytes = C times the element size (a
// multiple of 2). Returns cudaGetLastError() after the launch (0 = ok).
int swin_repartition_fwd(const void* in, void* out, int N, int H, int W, int row_bytes, int wh,
                         int ww, int from_shift, int to_shift, void* stream) {
  if (row_bytes % 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int top = wh - wh / 2, left = ww - ww / 2;
  const int tf = from_shift ? top : 0, lf = from_shift ? left : 0;
  const int tt = to_shift ? top : 0, lt = to_shift ? left : 0;
  const size_t align = reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out);
  const int piece = row_bytes % 16 == 0 && align % 16 == 0 ? 16
                    : row_bytes % 4 == 0 && align % 4 == 0 ? 4 : 2;
  const int vec = row_bytes / piece;
  const size_t per_map = static_cast<size_t>(H) * W * vec;
  const dim3 grid(static_cast<unsigned>((per_map + kThreads - 1) / kThreads), N);
  if (piece == 16) {
    repartition_kernel<uint4><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), vec, H, W, wh, ww, tf, lf, tt,
        lt);
  } else if (piece == 4) {
    repartition_kernel<unsigned><<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned*>(in), static_cast<unsigned*>(out), vec, H, W, wh, ww, tf,
        lf, tt, lt);
  } else {
    repartition_kernel<unsigned short><<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned short*>(in), static_cast<unsigned short*>(out), vec, H, W,
        wh, ww, tf, lf, tt, lt);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
