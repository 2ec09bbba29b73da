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
//
// The halo form (swin_repartition_halo_fwd) re-partitions one band of n window rows of a
// map split into row bands (ops/window_pack_spmd.py::repartition_halo): its output is the
// band's n window rows of the re-partition of the (n + 1)-row map [halo; band] (normal ->
// shifted, side -1) or [band; halo] (shifted -> normal, side +1), where `halo` is the
// neighbouring band's window row. One launch over the n output rows only: each destination
// token's source in that (n + 1)-row geometry is read from the halo row or from the band at
// its row offset, so nothing is concatenated and no dropped row is computed. The kept rows
// never read across the extended map's wrap (pallas_pack_spmd.py:355-367). A block first
// forms the sources of its tokens once into shared memory, then copies its tokens' pieces.

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

constexpr int kHaloPieces = 1024;  // pieces a block of the halo form copies, 4 a thread

// The band's tokens [tok0, tok0 + tokens) of stream blockIdx.y; band: (N, rows * row_tok,
// vec) pieces, halo: (N, row_tok, vec), out: as band.
template <typename V>
__global__ void __launch_bounds__(kThreads) repartition_halo_kernel(
    const V* __restrict__ band, const V* __restrict__ halo, V* __restrict__ out, int vec,
    int tokens, int rows, int W, int wh, int ww, int top_from, int left_from, int top_to,
    int left_to, int side) {
  __shared__ int src[kHaloPieces];  // per token: >= 0 a band token, < 0 ~(a halo token)
  const int row_tok = (W / ww) * wh * ww;  // tokens of one window row
  const int band_tok = rows * row_tok;
  const int H = (rows + 1) * wh;  // the extended map
  const int halo_at = side < 0 ? 0 : band_tok;  // first extended token of the halo row
  const int skip = side < 0 ? row_tok : 0;      // extended tokens before the band's first
  const int tok0 = blockIdx.x * tokens;
  const int count = min(tokens, band_tok - tok0);
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const int s = source_token(tok0 + t + skip, H, W, wh, ww, top_from, left_from, top_to,
                               left_to);
    const int r = s - halo_at;
    src[t] = r >= 0 && r < row_tok ? ~r : s - skip;
  }
  __syncthreads();
  const size_t n = blockIdx.y;
  const V* b = band + n * band_tok * vec;
  const V* h = halo + n * row_tok * vec;
  V* o = out + (n * band_tok + tok0) * vec;
  // piece j = t * vec + p of the block's tokens, stepped by kThreads without a division
  const int dt = kThreads / vec, dp = kThreads % vec;
  int t = threadIdx.x / vec, p = threadIdx.x % vec;
  for (int j = threadIdx.x; j < count * vec; j += kThreads) {
    const int s = src[t];
    o[j] = s >= 0 ? b[s * vec + p] : h[~s * vec + p];
    t += dt;
    p += dp;
    if (p >= vec) {
      p -= vec;
      ++t;
    }
  }
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

// The halo form: `out` (N, rows*W tokens, row_bytes) = window rows [1, n] (side -1, the
// normal -> shifted direction, `halo` the previous band's last window row) or [0, n)
// (side +1, shifted -> normal, `halo` the next band's first) of the (n + 1)-row map [halo;
// band] or [band; halo] re-partitioned from the `from_shift` to the `to_shift` grid;
// `band` (N, rows*W, row_bytes) holds n = rows / wh window rows of a map W wide, `halo`
// (N, wh*W, row_bytes). Returns cudaGetLastError() after the launch (0 = ok).
int swin_repartition_halo_fwd(const void* band, const void* halo, void* out, int N, int rows,
                              int W, int row_bytes, int wh, int ww, int from_shift,
                              int to_shift, int side, void* stream) {
  if (row_bytes % 2 || rows % wh || W % ww || !from_shift == !to_shift ||
      side != (to_shift ? -1 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int band_tok = rows * W;
  if (static_cast<size_t>(N) * band_tok == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int top = wh - wh / 2, left = ww - ww / 2;
  const int tf = from_shift ? top : 0, lf = from_shift ? left : 0;
  const int tt = to_shift ? top : 0, lt = to_shift ? left : 0;
  const size_t align = reinterpret_cast<size_t>(band) | reinterpret_cast<size_t>(halo) |
                       reinterpret_cast<size_t>(out);
  const int piece = row_bytes % 16 == 0 && align % 16 == 0 ? 16
                    : row_bytes % 4 == 0 && align % 4 == 0 ? 4 : 2;
  const int vec = row_bytes / piece;
  const int tokens = vec >= kHaloPieces ? 1 : kHaloPieces / vec;
  const dim3 grid(static_cast<unsigned>((band_tok + tokens - 1) / tokens), N);
  const int n = rows / wh;
  if (piece == 16) {
    repartition_halo_kernel<uint4><<<grid, kThreads, 0, st>>>(
        static_cast<const uint4*>(band), static_cast<const uint4*>(halo),
        static_cast<uint4*>(out), vec, tokens, n, W, wh, ww, tf, lf, tt, lt, side);
  } else if (piece == 4) {
    repartition_halo_kernel<unsigned><<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned*>(band), static_cast<const unsigned*>(halo),
        static_cast<unsigned*>(out), vec, tokens, n, W, wh, ww, tf, lf, tt, lt, side);
  } else {
    repartition_halo_kernel<unsigned short><<<grid, kThreads, 0, st>>>(
        static_cast<const unsigned short*>(band), static_cast<const unsigned short*>(halo),
        static_cast<unsigned short*>(out), vec, tokens, n, W, wh, ww, tf, lf, tt, lt, side);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
