// Device code shared by the window-attention kernel (K3, window_attention.cu) and the
// fused Swin block (K1/K4, fused_block.cu), for Hopper (sm_90a):
//
//   gemm_kernel         batched row-major C[z] = act((LN(A[z]) @ B[z] + bias[z]) * alpha[z])
//                       + res[z], with the LayerNorm of A's rows optional in the prologue
//                       (row statistics computed by each block for its own rows) and the
//                       MLP's activation (activation.cuh) and a residual optional in the
//                       epilogue; for the backward also C = A @ B^T (B stored (N, K)) without
//                       bias, and an epilogue that multiplies by the activation's derivative
//                       from the hidden `res` holds (under GELU z, replaced by the erf hidden);
//   window_core_kernel  one block per (window, stream*batch, head): scores q.k plus the
//                       shared relative-position bias, the shift mask that SETS scores to
//                       -1e10, the TPU kernels' fast softmax (one-sided clamp at 80, exp
//                       without max subtraction, multiply by 1/(sum + 1e-30)), and AV;
//   dropout_rows_kernel the hash-dropout mask of a token site applied to (S, M, N) rows,
//                       fp32 or bf16 in and out: a group of threads a token row, its unit
//                       hash once, the columns in 16-byte vectors.
//
// Dropout (kDrop, a template flag of the GEMM and of the core, so that a launch without
// dropout compiles to the code it had before): the masks of hash_dropout.cuh. The GEMM's
// epilogue masks its result after the bias, the scale and the activation and before the
// residual or the activation's derivative: proj (x + drop(proj + bp)), the MLP hidden
// (drop(act(fc1))), the MLP output (y + drop(fc2 + b2)) and, in the backward, the
// gradient of the hidden (drop(g w2^T) * act'). The core masks the normalised weights p
// before AV. Batch entry z of a masked GEMM is stream z.
//
// Precision. Every sum is fp32 FMA. A, the residual and C are fp32 or bf16 in memory
// (B, the weights, always fp32); a bf16 element is converted to fp32 on load and rounded
// to nearest even on store, as XLA's convert does. Under kBf16Ops the GEMM rounds both
// operands to bf16 as they enter shared memory (A after the LayerNorm prologue), and the
// core rounds p and v before AV and stores AV rounded: the TPU bodies' bf16 operands. A
// product of two bf16 values is exact in fp32, so this computes what the MXU computes up
// to the order of the sums.
//
// Token layouts of the core kernel, both (S*B, H*W tokens, heads*d) in device memory:
//   image    tokens in (H, W) row-major order; the window partition and the shifted
//            partition are address arithmetic: the shifted grid is the map rolled by
//            (top, left) = (wh - wh/2, ww - ww/2), so token (i, j) of window (wr, wc) is
//            pixel ((wr*wh + i - top) mod H, (wc*ww + j - left) mod W);
//   windows  tokens already grouped by window (nWin, T) in that same geometry, as
//            ops/window_pack.py::pack_windows lays them out.
// In both, the wrap seams are masked by region: a token's region is whether its rolled
// row is < top and whether its rolled column is < left; scores between regions are set
// to -1e10, whose exp is exactly 0. Without shift, top = left = 0 and all tokens share
// one region.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "activation.cuh"
#include "hash_dropout.cuh"

namespace swin {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

constexpr float kMaskFill = -1e10f;
constexpr float kSoftmaxClamp = 80.0f;
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- batched GEMM with optional LayerNorm prologue, activation and residual epilogue ---
constexpr int kBM = 64, kBN = 64, kBK = 16, kTM = 4, kTN = 4;
constexpr int kGemmThreads = (kBM / kTM) * (kBN / kTN);  // 256
constexpr int kMaxBatch = 6;

// TA, TR, TC: the element types of A, res and C (float or bf16).
template <typename TA = float, typename TR = float, typename TC = float>
struct GemmBatchT {
  const TA* a[kMaxBatch];        // (M, K)
  const float* b[kMaxBatch];     // (K, N), or (N, K) under kBT
  const float* bias[kMaxBatch];  // (N) (kBias only)
  const float* ln_g[kMaxBatch];  // (K) LayerNorm scale of A's rows (kLn only)
  const float* ln_b[kMaxBatch];  // (K) LayerNorm bias (kLn only)
  const TR* res[kMaxBatch];      // (M, N) added last (kRes), or the hidden whose activation
                                 // derivative scales the result (kDElu); may alias c
  TC* c[kMaxBatch];              // (M, N)
  float alpha[kMaxBatch];
  int act;                       // the activation of kElu and kDElu (activation.cuh), ELU = 0
};
using GemmBatch = GemmBatchT<>;

template <bool kLn, bool kElu, bool kRes, bool kBias, bool kBT, bool kDElu, bool kBf16Ops,
          bool kDrop, typename TA, typename TR, typename TC>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(GemmBatchT<TA, TR, TC> p, int M, int N, int K, DropSite drop) {
  __shared__ float as[kBK][kBM];  // A tile, transposed
  __shared__ float bs[kBK][kBN + (kBT ? 1 : 0)];  // padded when stored along K
  __shared__ float row_mean[kLn ? kBM : 1], row_rstd[kLn ? kBM : 1];
  const int z = blockIdx.z;
  const TA* __restrict__ a = p.a[z];
  const float* __restrict__ b = p.b[z];
  const int row0 = blockIdx.x * kBM, col0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);

  if (kLn) {  // one warp per row: mean, then the biased variance about it
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const int gr = row0 + r;
      float mean = 0.0f, rstd = 0.0f;
      if (gr < M) {
        const TA* row = a + static_cast<size_t>(gr) * K;
        float sum = 0.0f;
        for (int k = lane; k < K; k += 32) sum += to_float(row[k]);
        mean = warp_sum(sum) / K;
        float sq = 0.0f;
        for (int k = lane; k < K; k += 32) {
          const float dev = to_float(row[k]) - mean;
          sq = fmaf(dev, dev, sq);
        }
        rstd = 1.0f / sqrtf(warp_sum(sq) / K + kLnEps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }
  const float* __restrict__ ln_g = kLn ? p.ln_g[z] : nullptr;
  const float* __restrict__ ln_b = kLn ? p.ln_b[z] : nullptr;

  float acc[kTM][kTN] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      const int r = i / kBK, kk = i % kBK;  // consecutive threads walk along K
      const int gr = row0 + r, gk = k0 + kk;
      float val = 0.0f;
      if (gr < M && gk < K) {
        val = to_float(a[static_cast<size_t>(gr) * K + gk]);
        if (kLn) val = (val - row_mean[r]) * row_rstd[r] * ln_g[gk] + ln_b[gk];
        if (kBf16Ops) val = round_bf16(val);
      }
      as[kk][r] = val;
    }
    if (kBT) {
      for (int i = tid; i < kBK * kBN; i += kGemmThreads) {
        const int n = i / kBK, kk = i % kBK;  // consecutive threads walk along K
        const int gk = k0 + kk, gn = col0 + n;
        const float val = (gk < K && gn < N) ? b[static_cast<size_t>(gn) * K + gk] : 0.0f;
        bs[kk][n] = kBf16Ops ? round_bf16(val) : val;
      }
    } else {
      for (int i = tid; i < kBK * kBN; i += kGemmThreads) {
        const int kk = i / kBN, n = i % kBN;
        const int gk = k0 + kk, gn = col0 + n;
        const float val = (gk < K && gn < N) ? b[static_cast<size_t>(gk) * N + gn] : 0.0f;
        bs[kk][n] = kBf16Ops ? round_bf16(val) : val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float alpha = p.alpha[z];
  const TR* res = (kRes || kDElu) ? p.res[z] : nullptr;
  TC* c = p.c[z];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gr = row0 + ty * kTM + i;
    if (gr >= M) continue;
    uint32_t ph = 0;
    int slot = 0;
    if (kDrop) {
      const int b = gr / drop.hw;
      ph = token_hash(drop, z * drop.B + b, gr - b * drop.hw, &slot);
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = col0 + tx * kTN + j;
      if (gn >= N) continue;
      const size_t at = static_cast<size_t>(gr) * N + gn;
      float v = acc[i][j];
      if (kBias) v += p.bias[z][gn];
      v *= alpha;
      if (kElu) v = activate(p.act, v);
      if (kDrop)
        v = hash_keep(ph, token_intra(drop, slot, gn, N), drop.threshold) ? v * drop.scale : 0.0f;
      if (kDElu) {  // act'(z) from the stored hidden; under GELU the erf hidden replaces z
        float hv = to_float(res[at]);
        v *= act_grad(p.act, hv);
        if (p.act == kActGelu) const_cast<TR*>(res)[at] = from_float<TR>(hv);
      } else if (kRes) v += to_float(res[at]);  // read and written by this thread only
      c[at] = from_float<TC>(v);
    }
  }
}

template <bool kLn, bool kElu, bool kRes, bool kBias = true, bool kBT = false, bool kDElu = false,
          bool kBf16Ops = false, bool kDrop = false, typename TA, typename TR, typename TC>
void launch_gemm(const GemmBatchT<TA, TR, TC>& p, int M, int N, int K, int batch, cudaStream_t st,
                 const DropSite& drop = DropSite{}) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, batch);
  gemm_kernel<kLn, kElu, kRes, kBias, kBT, kDElu, kBf16Ops, kDrop, TA, TR, TC>
      <<<grid, kGemmThreads, 0, st>>>(p, M, N, K, drop);
}

// launch_gemm with the epilogue's dropout at `site` when `drop` has it on, without it else.
template <bool kLn, bool kElu, bool kRes, bool kBias = true, bool kBT = false, bool kDElu = false,
          bool kBf16Ops = false, typename TA, typename TR, typename TC>
void launch_gemm_site(const GemmBatchT<TA, TR, TC>& p, int M, int N, int K, int batch,
                      cudaStream_t st, const DropArgs* drop, int site, int hw, int B) {
  if (drop_on(drop, site))
    launch_gemm<kLn, kElu, kRes, kBias, kBT, kDElu, kBf16Ops, true>(p, M, N, K, batch, st,
                                                                      drop_site(drop, site, hw, B));
  else
    launch_gemm<kLn, kElu, kRes, kBias, kBT, kDElu, kBf16Ops>(p, M, N, K, batch, st);
}

// ---- the mask of a token site on (S, M, N) rows, z = stream; `out` may be `in` -------
// TI, TO: the element types of in and out (float or bf16); a kept element is in * scale
// in fp32, rounded once on the store.
//
// dropout_rows_kernel: a group of `group` threads (a power of two <= 32, the fewest that
// span a row's vectors) takes a token row: its image, table entry, slot and unit hash once,
// then the columns in vectors of V elements (16 bytes of the wider type, 4 fp32 or 8 bf16,
// where the row and both pointers allow; else 8 bytes; else V = 1), each element's keep bit
// from the row's unit hash and its intra offset. A group holds kDropRows rows at once (their
// loads all issued before any store, so `out` may be `in`) and strides over the S*M rows of
// every stream; the grid fills the SMs.
constexpr int kDropThreads = 256;
constexpr int kDropRows = 4;

// V elements of E as 32-bit words (V * sizeof(E) = 16 or 8 bytes), or one element (V = 1).
template <typename E, int V>
struct DropChunk {
  static constexpr int kWords = V * static_cast<int>(sizeof(E)) / 4;
  unsigned w[kWords];
  __device__ __forceinline__ void load(const E* p) {
    static_assert(kWords == 4 || kWords == 2 || kWords == 1, "16-, 8- or 4-byte vectors");
    if constexpr (kWords == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (kWords == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
  }
  __device__ __forceinline__ void store(E* p) const {
    if constexpr (kWords == 4)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (kWords == 2)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<unsigned*>(p) = w[0];
  }
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(E) == 4) return __uint_as_float(w[j]);
    const unsigned v = w[j >> 1];  // element 2k in the low half (little-endian)
    return __uint_as_float(j & 1 ? v & 0xffff0000u : v << 16);
  }
  __device__ __forceinline__ void set(const float* y) {
    if constexpr (sizeof(E) == 4) {
#pragma unroll
      for (int j = 0; j < V; ++j) w[j] = __float_as_uint(y[j]);
    } else {
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        w[k] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(y[2 * k]))) |
               static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(y[2 * k + 1]))) << 16;
    }
  }
};

template <typename E>
struct DropChunk<E, 1> {
  E e;
  __device__ __forceinline__ void load(const E* p) { e = *p; }
  __device__ __forceinline__ void store(E* p) const { *p = e; }
  __device__ __forceinline__ float get(int) const { return to_float(e); }
  __device__ __forceinline__ void set(const float* y) { e = from_float<E>(y[0]); }
};

template <typename TI, typename TO, int V>
__global__ void __launch_bounds__(kDropThreads)
    dropout_rows_kernel(const TI* in, TO* out, DropSite d, int M, int N, int S, int group) {
  const int lane = threadIdx.x & (group - 1);
  const int groups = gridDim.x * (kDropThreads / group);
  const int rows = S * M, vecs = N / V;
  const uint32_t step = d.pairs ? static_cast<uint32_t>(kPackLanes) : 1u;  // intra per column
  for (int r0 = (blockIdx.x * kDropThreads + threadIdx.x) / group; r0 < rows;
       r0 += kDropRows * groups) {
    uint32_t ph[kDropRows], intra0[kDropRows];
    size_t at[kDropRows];
    bool live[kDropRows];
#pragma unroll
    for (int i = 0; i < kDropRows; ++i) {
      live[i] = r0 + i * groups < rows;
      const int r = live[i] ? r0 + i * groups : r0;
      const int s = r / M, gr = r - s * M, b = gr / d.hw;
      int slot;
      ph[i] = token_hash(d, s * d.B + b, gr - b * d.hw, &slot);
      intra0[i] = token_intra(d, slot, 0, N);  // column c adds c * step
      at[i] = static_cast<size_t>(r) * N;
    }
    for (int v = lane; v < vecs; v += group) {
      const int c0 = v * V;
      DropChunk<TI, V> x[kDropRows];
#pragma unroll
      for (int i = 0; i < kDropRows; ++i)
        if (live[i]) x[i].load(in + at[i] + c0);
#pragma unroll
      for (int i = 0; i < kDropRows; ++i) {
        if (!live[i]) continue;
        float y[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          y[j] = hash_keep(ph[i], intra0[i] + static_cast<uint32_t>(c0 + j) * step, d.threshold)
                     ? x[i].get(j) * d.scale : 0.0f;
        DropChunk<TO, V> o;
        o.set(y);
        o.store(out + at[i] + c0);
      }
    }
  }
}

// The SMs of the current card, read once a card.
inline int drop_sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && counts[dev] > 0) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) n = 132;
  if (dev >= 0 && dev < 64) counts[dev] = n;
  return n;
}

template <typename TI, typename TO, int V>
void launch_dropout_rows_v(const TI* in, TO* out, const DropSite& d, int M, int N, int S,
                           cudaStream_t st) {
  const int vecs = N / V;
  int group = 1;
  while (group < vecs && group < 32) group *= 2;
  const long long sets = (static_cast<long long>(S) * M + kDropRows - 1) / kDropRows;
  const long long want = (sets * group + kDropThreads - 1) / kDropThreads;
  const int blocks = static_cast<int>(want < 8LL * drop_sm_count() ? want : 8LL * drop_sm_count());
  dropout_rows_kernel<TI, TO, V><<<blocks, kDropThreads, 0, st>>>(in, out, d, M, N, S, group);
}

template <typename TI, typename TO>
void launch_dropout_rows(const TI* in, TO* out, const DropSite& d, int M, int N, int S,
                         cudaStream_t st) {
  if (static_cast<long long>(S) * M * N == 0) return;
  constexpr int kWide = sizeof(TI) > sizeof(TO) ? sizeof(TI) : sizeof(TO);
  constexpr int V = 16 / kWide;  // 16 bytes of the wider type; else 8 bytes; else one element
  const auto fits = [&](int v) {
    return N % v == 0 && reinterpret_cast<size_t>(in) % (v * sizeof(TI)) == 0 &&
           reinterpret_cast<size_t>(out) % (v * sizeof(TO)) == 0;
  };
  if (fits(V))
    launch_dropout_rows_v<TI, TO, V>(in, out, d, M, N, S, st);
  else if (fits(V / 2))
    launch_dropout_rows_v<TI, TO, V / 2>(in, out, d, M, N, S, st);
  else
    launch_dropout_rows_v<TI, TO, 1>(in, out, d, M, N, S, st);
}

// The first form: a thread an element, its row's unit hash hashed again for every
// column. Kept only for chip_smoke.py's timings in turns; no call of the model runs it.
template <typename TI, typename TO>
__global__ void __launch_bounds__(kDropThreads)
    dropout_rows_elementwise_kernel(const TI* in, TO* out, DropSite d, int M, int N) {
  const size_t per_stream = static_cast<size_t>(M) * N;
  const size_t i = static_cast<size_t>(blockIdx.x) * kDropThreads + threadIdx.x;
  if (i >= per_stream) return;
  const int gr = static_cast<int>(i / N), gn = static_cast<int>(i % N);
  const int b = gr / d.hw;
  int slot;
  const uint32_t ph = token_hash(d, blockIdx.y * d.B + b, gr - b * d.hw, &slot);
  const size_t at = blockIdx.y * per_stream + i;
  const float v = to_float(in[at]);
  out[at] = from_float<TO>(hash_keep(ph, token_intra(d, slot, gn, N), d.threshold) ? v * d.scale
                                                                                    : 0.0f);
}

template <typename TI, typename TO>
void launch_dropout_rows_elementwise(const TI* in, TO* out, const DropSite& d, int M, int N,
                                     int S, cudaStream_t st) {
  const size_t n = static_cast<size_t>(M) * N;
  const dim3 grid(static_cast<unsigned>((n + kDropThreads - 1) / kDropThreads), S);
  dropout_rows_elementwise_kernel<TI, TO><<<grid, kDropThreads, 0, st>>>(in, out, d, M, N);
}

// The q/k/v GEMM of S streams as one batch, z = s*3 + part: q (times `scale`) from stream
// s's rows, k and v from the rows of stream kv(s) (1 - s under cross), all with stream s's
// weights. rows: (S, M, C); q, k, v: (S, M, inner), fp32 in every mode. With ln_g/ln_b
// (S, C) the GEMM normalises each row in its prologue with the LayerNorm of the stream the
// row comes from (launch it with kLn).
template <typename TA>
GemmBatchT<TA> qkv_batch(const TA* rows, const float* wq, const float* bq,
                         const float* wk, const float* bk, const float* wv, const float* bv,
                         float* q, float* k, float* v, int S, int M, int C, int inner,
                         bool cross, float scale, const float* ln_g = nullptr,
                         const float* ln_b = nullptr) {
  GemmBatchT<TA> p = {};
  const float* w[3] = {wq, wk, wv};
  const float* bb[3] = {bq, bk, bv};
  float* dst[3] = {q, k, v};
  for (int s = 0; s < S; ++s) {
    for (int part = 0; part < 3; ++part) {
      const int z = s * 3 + part;
      const int src = part == 0 || !cross ? s : S - 1 - s;
      p.a[z] = rows + static_cast<size_t>(src) * M * C;
      if (ln_g != nullptr) {
        p.ln_g[z] = ln_g + static_cast<size_t>(src) * C;
        p.ln_b[z] = ln_b + static_cast<size_t>(src) * C;
      }
      p.b[z] = w[part] + static_cast<size_t>(s) * C * inner;
      p.bias[z] = bb[part] + static_cast<size_t>(s) * inner;
      p.c[z] = dst[part] + static_cast<size_t>(s) * M * inner;
      p.alpha[z] = part == 0 ? scale : 1.0f;
    }
  }
  return p;
}

// ---- per (window, stream*batch, head): scores, mask, softmax, AV -----------------------
constexpr int kCoreThreads = 128;

// TO: AV's element type; under kBf16Ops p and v are rounded to bf16 before AV (and TO is
// bf16, so AV is rounded on its store). Under kDrop p is masked (the query's unit hash and
// every token's slot kept in shared memory) before the rounding and AV.
template <bool kWindows, bool kBf16Ops = false, typename TO = float, bool kDrop = false>
__global__ void __launch_bounds__(kCoreThreads) window_core_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, TO* __restrict__ o, int B, int H, int W, int heads,
    int d, int wh, int ww, int top, int left, DropSite drop) {
  extern __shared__ float smem[];
  const int T = wh * ww;
  const int inner = heads * d;
  const int nw = W / ww;
  const int wr = blockIdx.x / nw, wc = blockIdx.x % nw;
  const int n = blockIdx.y;  // s * B + b
  const int s = n / B;
  const int h = blockIdx.z;
  const int tid = threadIdx.x;

  float* qs = smem;          // [T][d]
  float* ks = qs + T * d;    // [T][d]
  float* vs = ks + T * d;    // [T][d]
  float* ps = vs + T * d;    // [T][T]
  int* pix = reinterpret_cast<int*>(ps + T * T);  // [T] token index in the (s, b) map
  int* region = pix + T;                           // [T] wrap-seam region
  uint32_t* phs = reinterpret_cast<uint32_t*>(region + T);  // [T] unit hash (kDrop)
  int* slots = reinterpret_cast<int*>(phs + T);              // [T] slot (kDrop)

  for (int t = tid; t < T; t += kCoreThreads) {
    const int rr = wr * wh + t / ww;  // row and column in the rolled map
    const int rc = wc * ww + t % ww;
    pix[t] = kWindows ? blockIdx.x * T + t : ((rr - top + H) % H) * W + (rc - left + W) % W;
    region[t] = ((rr < top) << 1) | (rc < left);
    if (kDrop) phs[t] = token_hash(drop, n, pix[t], &slots[t]);
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(n) * H * W * inner + static_cast<size_t>(h) * d;
  for (int i = tid; i < T * d; i += kCoreThreads) {
    const size_t at = base + static_cast<size_t>(pix[i / d]) * inner + i % d;
    qs[i] = q[at];
    ks[i] = k[at];
    vs[i] = kBf16Ops ? round_bf16(v[at]) : v[at];
  }
  __syncthreads();

  const float* __restrict__ bias_s = bias + static_cast<size_t>(s) * T * T;
  for (int i = tid; i < T * T; i += kCoreThreads) {
    const int t = i / T, u = i % T;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) acc = fmaf(qs[t * d + j], ks[u * d + j], acc);
    acc += bias_s[i];
    if (region[t] != region[u]) acc = kMaskFill;
    ps[i] = expf(fminf(acc, kSoftmaxClamp));
  }
  __syncthreads();
  // one warp per row: p = e * (1 / (sum + 1e-30))
  const int warp = tid / 32, lane = tid % 32;
  for (int t = warp; t < T; t += kCoreThreads / 32) {
    float sum = 0.0f;
    for (int u = lane; u < T; u += 32) sum += ps[t * T + u];
    const float r = 1.0f / (warp_sum(sum) + 1e-30f);
    for (int u = lane; u < T; u += 32) {
      float p = ps[t * T + u] * r;
      if (kDrop)
        p = hash_keep(phs[t], attn_intra(drop, h, slots[t], slots[u], heads), drop.threshold)
                ? p * drop.scale : 0.0f;
      ps[t * T + u] = kBf16Ops ? round_bf16(p) : p;
    }
  }
  __syncthreads();
  for (int i = tid; i < T * d; i += kCoreThreads) {
    const int t = i / d, j = i % d;
    float acc = 0.0f;
    for (int u = 0; u < T; ++u) acc = fmaf(ps[t * T + u], vs[u * d + j], acc);
    o[base + static_cast<size_t>(pix[t]) * inner + j] = from_float<TO>(acc);
  }
}

inline size_t core_smem_bytes(int d, int wh, int ww, bool drop = false) {
  const size_t T = static_cast<size_t>(wh) * ww;
  return (3 * T * d + T * T) * sizeof(float) + (drop ? 4 : 2) * T * sizeof(int);
}

// Sets the core kernel's shared memory and launches it over every window, stream*batch
// and head of an (S*B, H, W) map; returns the attribute call's error (0 = ok).
template <bool kWindows, bool kBf16Ops = false, typename TO = float, bool kDrop = false>
cudaError_t launch_core_as(const float* q, const float* k, const float* v, const float* bias,
                           TO* o, int S, int B, int H, int W, int heads, int d, int wh,
                           int ww, bool shift, cudaStream_t st, const DropSite& drop) {
  const size_t smem = core_smem_bytes(d, wh, ww, kDrop);
  const cudaError_t err = cudaFuncSetAttribute(
      window_core_kernel<kWindows, kBf16Ops, TO, kDrop>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((H / wh) * (W / ww), S * B, heads);
  window_core_kernel<kWindows, kBf16Ops, TO, kDrop><<<grid, kCoreThreads, smem, st>>>(
      q, k, v, bias, o, B, H, W, heads, d, wh, ww, shift ? wh - wh / 2 : 0,
      shift ? ww - ww / 2 : 0, drop);
  return cudaSuccess;
}

// The core with the attention-site dropout of `drop` where it is on (nullptr: none).
template <bool kWindows, bool kBf16Ops = false, typename TO = float>
cudaError_t launch_core(const float* q, const float* k, const float* v, const float* bias,
                        TO* o, int S, int B, int H, int W, int heads, int d, int wh,
                        int ww, bool shift, cudaStream_t st, const DropArgs* drop = nullptr) {
  if (drop_on(drop, kSiteAttn))
    return launch_core_as<kWindows, kBf16Ops, TO, true>(q, k, v, bias, o, S, B, H, W, heads, d,
                                                        wh, ww, shift, st,
                                                        drop_site(drop, kSiteAttn, H * W, B));
  return launch_core_as<kWindows, kBf16Ops, TO>(q, k, v, bias, o, S, B, H, W, heads, d, wh, ww,
                                                shift, st, DropSite{});
}

}  // namespace swin

extern "C" const char* swin_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
