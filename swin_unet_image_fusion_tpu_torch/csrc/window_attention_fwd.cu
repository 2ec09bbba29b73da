// Swin window attention (K3), the forward with and without dropout, fp32 and bf16, redesigned
// for Hopper (sm_90a).
//
// Replaces swin_unet_image_fusion_tpu/ops/pallas_attention.py::_attention_fwd_kernel (body
// l.249-332) for every call; window_attention.cu's three launches serve only as the form the
// card checks time this one against. The function is the one window_attention.cu
// computes: per window and stream, q/k/v projections (+bias, the scale folded into q), fp32
// scores q.k plus the shared relative-position bias, region masks that SET scores to -1e10,
// the fast softmax (one-sided clamp at 80, exp without max subtraction, 1/(sum + 1e-30)), AV,
// and the output projection summed over heads in fp32 + bp; under cross k/v come from the
// other stream's tokens with this stream's weights. x and out are (S, B, H, W, C) in the
// image layout; the window and the shifted window are address arithmetic (the map rolled
// by (top, left) = (wh - wh/2, ww - ww/2), regions by rolled row < top, column < left).
// Dropout (the attention site of `drop`, keyed on K3's wrap windows, ops/dropout_layout.py
// "k3", l.278-290, 322-323 of the TPU body; the projection's dropout is the caller's): the same
// launches with the attention block's kDrop form (window_fwd.cuh). The block hashes its
// tokens' unit hashes and slots after its layout; the fp32 core hashes each weight's keep bit
// where it uses it (kDropHashed), the bf16 core reads keep words that the block hashes once per
// head before the q/k/v product (kDropWords), and masks p = e * r times 1 / (1 - rate) before
// its rounding, as the TPU body masks before its cast for AV. No keep word is stored: the
// backward (window_attention_bwd.cu) hashes its own.
//
// What bounds it, and the design. A 512² request runs ~40.5 GFLOP of K3 in 40 calls against
// ~20 MB of activations: the arithmetic bounds it, not device memory. The three launches
// spent it on 64x64 SIMT tiles with 4x4 register tiles, on 128-wide column tiles for 72
// columns, and on one tiny block per (window, stream, head) whose core took 6.0 of 8.8 ms.
// Here a block owns one window of one stream (T = 49 tokens), k3_attention_kernel:
//   q, k, v of its heads (every head, or a group of them) from x and the weights, both
//   streamed through shared memory in chunks of 16 channels by a three-deep cp.async ring,
//   stay in shared memory; the region mask is folded into the block's bias table (-inf);
//   then one warp per (head, 32 query rows), each lane a query row walking the 49 keys
//   (scores, bias, exp, sum) and AV.
//   fused (every head, where two such blocks fit an SM: C <= 64, stages 0-1 at 512²): wp
//   streams into the freed rings under the core, and the block projects AV from shared
//   memory and stores the output: ONE launch.
//   split (stages 2-4: 200, 50 and 18 windows): the block writes its heads' AV to a
//   window-major scratch and k3_proj_kernel projects each window onto 48 output columns
//   (a six-deep ring over K = heads * d): TWO launches, parallel over heads and columns.
// The earlier one-block-per-window design held x, kv and a (T, C) accumulator for all heads
// (~190 KB at C = 384) on 18 blocks and took 13.7 ms per launch; here a block at C = 384
// holds one head in ~90 KB and 144 blocks run.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py [split]): 4.50 ms of device time per
// 512² request in fp32 and 3.39 in bf16, against 8.78 for the three launches. It is bound by
// latency, not FMAs: each small block waits on its own loads and barriers (PERF.md §6).
// fp32: FMA only (TF32 stays off). GEMM tiles of 8 rows x 4 columns per thread, one tile a
// thread: two float4 loads of x^T and one float4 of w feed 32 FMAs; the A rows are pitched
// so that a quarter-warp's loads fall in distinct banks. The core folds 1/(sum + 1e-30) in
// after the AV sum (sum_u e_u v_u * r instead of sum_u (e_u r) v_u: fp32 reassociation).
// bf16 (x bf16, weights fp32 rounded to bf16 as the fragments are built, as the TPU body
// casts them, pallas_attention.py:311-313, 328): the projections, AV and the output
// projection run on the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32 accumulators:
// a product of two bf16 values is exact in fp32, so this is what the MXU computes up to the
// order of the sums); q and k stay fp32 and the scores fp32 FMA (l.319); p = rnd(e * r) and
// rnd(v) before AV (l.325), AV rounded (l.327), the projection summed in fp32 + bp and
// rounded once on the store (l.331-332). Rows pad to 64 and keys to 64 with zeros, so
// padding adds exactly 0.
// Every sum runs in a fixed order in one thread or one mma; no atomics: a repeat gives the
// same bits, with and without dropout. Built as it stands, the file takes 7x7 windows (T = 49
// at compile time); window_attention_fwd_any.cu builds it in window_fwd.cuh's any-window class
// (SWIN_ANY_WINDOW: any window of T <= 64 tokens, T at run time, 64-row blocks). The attention kernel and the device code under it
// (rings, GEMMs, the core) are window_fwd.cuh's, which K4's forward (fused_block_fwd.cu)
// shares; this file holds the projection kernel and the launches.

#include "window_fwd.cuh"

namespace {

using namespace wfwd;

// The projection kernel's layout.
__host__ __device__ inline Layout proj_layout(bool bf16_io) {
  Layout L{};
  L.b = ring_a_bytes(bf16_io, 1, kProjStages);
  L.rows = align16(L.b + b_bytes(bf16_io, kProjCols, kProjStages));
  L.total = L.rows + align16(2 * kRowsB * 4);
  return L;
}

// ---- the projection kernel ---------------------------------------------------------------
// One block per (window, stream * batch, 48 output columns): out = AV @ wp + bp, AV from the
// attention kernel's scratch, every head's sum in one fixed order.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2) k3_proj_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using IO = Act<kBf16>;  // AV and out
  const Layout L = proj_layout(kBf16);
  const int T = tokens(a.t);
  const int2 wd = window_hw(a);
  const int win = blockIdx.x, nb = blockIdx.y, c0 = blockIdx.z * kProjCols;
  const int s = nb / a.B, b = nb % a.B;
  const int nwin = (a.H / wd.x) * (a.W / wd.y);
  int* orows = reinterpret_cast<int*>(smem + L.rows);  // output rows: pixel * C
  int* arows = orows + kRowsB;                           // AV rows in the scratch
  window_rows(a, win, orows, arows);
  for (int t = threadIdx.x; t < kRowsB; t += kThreads) arows[t] = t * a.inner;
  __syncthreads();

  Gemm g{};
  g.abase[0] = static_cast<const IO*>(a.av) + (static_cast<size_t>(nb) * nwin + win) * T * a.inner;
  g.aparts = 1;
  g.rows = arows;
  g.w[0] = a.wp + static_cast<size_t>(s) * a.inner * a.C + c0;
  g.n = g.nb = a.C - c0 < kProjCols ? a.C - c0 : kProjCols;
  g.ldw = a.C;
  g.K = a.inner;
  g.t = T;
  IO* out = static_cast<IO*>(a.out) + static_cast<size_t>(s * a.B + b) * a.H * a.W * a.C + c0;
  if constexpr (kBf16) {
    float acc[kMaxNTilesB][4][4];
    gemm_bf16<kProjStages>(g, reinterpret_cast<bf16*>(smem + L.a), reinterpret_cast<float*>(smem + L.b), acc);
    store_proj_bf16(acc, g.nb, orows, a.bp + s * a.C + c0, out, T);
  } else {
    float acc[8][kTileN];
    const int tile =
        gemm_f32<kProjStages>(g, reinterpret_cast<float*>(smem + L.a), reinterpret_cast<float*>(smem + L.b), acc);
    store_proj_f32(acc, tile, orows, a.bp + s * a.C + c0, out, T);
  }
}

// ---- host side -------------------------------------------------------------------------
constexpr int kPitches[] = {4, 8, 12, 16, 24, 32, 48};

// q/k rows' pitch for d dims per head: the smallest instantiated pitch >= d (0: none).
int pitch_for(int d) {
  for (int p : kPitches)
    if (d <= p) return p;
  return 0;
}

cudaError_t set_smem(const void* kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The attention kernel over (window, stream * batch, head group); on the split route then the
// projection kernel over (window, stream * batch, 48 columns). kDrop: the attention kernel's
// dropout form, fp32 hashing each weight's bit in the core, bf16 reading keep words.
template <int DP, bool kBf16, bool kDrop>
cudaError_t launch_route(bool fused, int smem, const Args& a, cudaStream_t st) {
  constexpr int kCore = !kDrop ? swin::kNoDrop : kBf16 ? swin::kDropWords : swin::kDropHashed;
  const int2 wd = window_hw(a);
  const dim3 grid((a.H / wd.x) * (a.W / wd.y), a.S * a.B, a.heads / a.hg);
  const void* kernel = fused ? reinterpret_cast<const void*>(k3_attention_kernel<DP, kBf16, true, kCore>)
                             : reinterpret_cast<const void*>(k3_attention_kernel<DP, kBf16, false, kCore>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (fused) {
    k3_attention_kernel<DP, kBf16, true, kCore><<<grid, kThreads, smem, st>>>(a);
    return cudaGetLastError();
  }
  k3_attention_kernel<DP, kBf16, false, kCore><<<grid, kThreads, smem, st>>>(a);
  const int psmem = proj_layout(kBf16).total;
  err = set_smem(reinterpret_cast<const void*>(k3_proj_kernel<kBf16>), psmem);
  if (err != cudaSuccess) return err;
  k3_proj_kernel<kBf16><<<dim3(grid.x, grid.y, (a.C + kProjCols - 1) / kProjCols), kThreads, psmem, st>>>(a);
  return cudaGetLastError();
}

template <bool kBf16, bool kDrop>
cudaError_t launch_pitch(bool fused, int dp, int smem, const Args& a, cudaStream_t st) {
  switch (dp) {
    case 4: return launch_route<4, kBf16, kDrop>(fused, smem, a, st);
    case 8: return launch_route<8, kBf16, kDrop>(fused, smem, a, st);
    case 12: return launch_route<12, kBf16, kDrop>(fused, smem, a, st);
    case 16: return launch_route<16, kBf16, kDrop>(fused, smem, a, st);
    case 24: return launch_route<24, kBf16, kDrop>(fused, smem, a, st);
    case 32: return launch_route<32, kBf16, kDrop>(fused, smem, a, st);
    case 48: return launch_route<48, kBf16, kDrop>(fused, smem, a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kBf16>
cudaError_t launch_drop(bool fused, bool drop, int dp, int smem, const Args& a, cudaStream_t st) {
  return drop ? launch_pitch<kBf16, true>(fused, dp, smem, a, st) : launch_pitch<kBf16, false>(fused, dp, smem, a, st);
}

// Whether the kernels take these dimensions and this head grouping (ops/window_attention.py
// ::fwd_plan makes the same checks and raises first).
bool supported(int C, int inner, int heads, int d, int hg, bool fused) {
  if (pitch_for(d) == 0 || hg < 1 || heads % hg != 0 || (fused && hg != heads)) return false;
  if (C % 8 != 0 || inner % 8 != 0 || inner != heads * d) return false;
  const int n = hg * d;
  const int cols = kMaxNTilesB * kWarps * 8;  // bf16: column tiles; fp32: a tile per thread
  if (n % 8 != 0 || 3 * n > cols || 3 * n > kColTable || f32_tiles(3 * n) > kThreads) return false;
  if (fused && (C > cols || C > kColTable || f32_tiles(C) > kThreads)) return false;
  return true;
}

// drop: the dropout form's token hashes and slots after the layout, and bf16's keep words
int block_smem(bool bf16_io, bool fused, bool cross, int C, int inner, int d, int hg, bool drop, int t) {
  return attention_layout(bf16_io, fused, cross, C, inner, hg, d, pitch_for(d), t).total +
         (drop ? drop_attention_bytes(hg, bf16_io, t) : 0);
}

// Whether this build takes a wh x ww window: 7 x 7 alone, or (the any-window class) any window
// of at most kT = 64 tokens.
bool takes_window(int wh, int ww) {
  if (!kAnyWindow) return wh == 7 && ww == 7;
  return wh >= 1 && ww >= 1 && wh * ww <= kT;
}

}  // namespace

extern "C" {

const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Shared memory in bytes of one block of the attention kernel (fused: every head and the
// projection; else hg heads; drop: its dropout form) with proj = 0, or of the projection
// kernel with proj = 1, at wh x ww windows; 0 where the kernels do not take the dimensions.
size_t swin_k3_fwd_smem(int bf16_io, int fused, int cross, int C, int inner, int heads, int d,
                        int hg, int proj, int drop, int wh, int ww) {
  if (!takes_window(wh, ww) || !supported(C, inner, heads, d, hg, fused != 0)) return 0;
  if (proj) return static_cast<size_t>(proj_layout(bf16_io != 0).total);
  return static_cast<size_t>(
      block_smem(bf16_io != 0, fused != 0, cross != 0, C, inner, d, hg, drop != 0, wh * ww));
}

// The forward on `stream`, with dropout where `drop` (ops/dropout_layout.py's "k3" keying; its
// attention site) is not nullptr: x and out (S, B, H, W, C) fp32, or bf16 when `bf16_io` is
// set; the weights fp32 as window_attention.cu's, the bias (S, T, T); wh x ww windows of T
// tokens (7 x 7 in this build, any of T <= 64 in the any-window build). fused: one launch with
// every head in a block (hg == heads); else hg heads per block and av, a (S*B, windows, T,
// heads*d) scratch in x's type, then the projection launch. Returns cudaGetLastError() after
// the launches (0 = ok), cudaErrorInvalidValue on dimensions the kernels do not take.
int swin_k3_fwd(const void* x, const float* wq, const float* bq, const float* wk, const float* bk,
                const float* wv, const float* bv, const float* wp, const float* bp,
                const float* bias, void* out, void* av, const swin::DropArgs* drop, int S, int B, int H,
                int W, int C, int heads, int d, int hg, int fused, int shift, int cross, int bf16_io,
                float scale, int wh, int ww, void* stream) {
  const int inner = heads * d;
  if (!takes_window(wh, ww) || H % wh != 0 || W % ww != 0 || S < 1 || S > 2 || (cross && S != 2) ||
      !supported(C, inner, heads, d, hg, fused != 0) || (!fused && av == nullptr) ||
      (drop != nullptr && !swin::drop_on(drop, swin::kSiteAttn)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool dropping = drop != nullptr;
  const Args a = {x, wq, bq, wk, bk, wv, bv, wp, bp, bias, out, av, S, B, H, W, C, inner, heads,
                  d, hg, shift ? wh - wh / 2 : 0, shift ? ww - ww / 2 : 0, cross, scale, /*windows=*/0,
                  dropping ? swin::drop_site(drop, swin::kSiteAttn, H * W, B) : swin::DropSite{}, nullptr,
                  wh, ww, wh * ww};
  const int smem = block_smem(bf16_io != 0, fused != 0, cross != 0, C, inner, d, hg, dropping, wh * ww);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = pitch_for(d);
  return static_cast<int>(bf16_io ? launch_drop<true>(fused != 0, dropping, dp, smem, a, st)
                                  : launch_drop<false>(fused != 0, dropping, dp, smem, a, st));
}

}  // extern "C"
