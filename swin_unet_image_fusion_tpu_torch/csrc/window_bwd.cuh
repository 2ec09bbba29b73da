// Device code of the window-attention backward, redesigned for Hopper (sm_90a): what the
// fused block's backward (fused_block_bwd.cu, K1 bwd and K4 bwd) and K3's backward
// (window_attention_bwd.cu) run in their blocks of one window. Built on window_fwd.cuh: one
// 7x7 window of T = 49 tokens per block (the any-window class: up to 64), 256 threads, GEMM operands resident in shared memory
// channel-major ([k][kPitchF], row groups at a_col) or streamed through a ring in that layout,
// with the weights streamed through a cp.async ring.
//
//   gemm_tile    Y[49, nb] += A[49, K] @ B[K, nb] with fp32 FMA, each thread holding an 8 x
//                TN register tile (TN = 1, 2 or 4, chosen by with_tn from nb so that the
//                narrow products of the backward (nb = C = 24 or 48) keep 168-252 threads
//                busy where window_fwd.cuh's fixed 8 x 4 tile keeps 42-84);
//   gemm_stream  the same product with A streamed from device memory (fp32, or bf16 upcast
//                as it is loaded) through a two-slot ring, each thread staging its share of
//                the next chunk in registers while the current one is multiplied;
//   core_bwd_rows / core_bwd_cols
//                the attention core's backward for every head of one window, from q
//                (scaled), k, v and g_o in the core layout [head][49][DP]: the rows pass
//                (four lanes a query row, the heads in turn) recomputes the scores and P,
//                forms g_P = g_o v^T, dot = rowsum(g_P P) and g_S = P (g_P - dot), adds
//                g_S to a register accumulator of the relative-position bias gradient that
//                the lane owns across heads and windows (so the sum has one fixed order and
//                needs no atomics), and writes g_q = scale g_S k; the columns pass (a lane
//                per key of a head) recomputes P and g_S from the rows pass's 1/sum and dot
//                and writes g_k = g_S^T q and g_v = P^T g_o. The softmax clamp at 80 is not
//                differentiated and a masked score (-inf in the bias) gives P = g_S = 0,
//                as in window_core_bwd.cuh and the JAX bodies; core_bwd runs both passes for
//                any group of heads, so a block may take all of a window's heads or some;
//   wgrad_rows_kernel
//                weight gradients [A | 1]^T B over token rows, every weight of a call in one
//                launch: a block per (chunk of rows, weight, group of output tiles), 4 x 4
//                register tiles, rows in slabs through shared memory in 16-byte loads (only a
//                block's own columns where a weight's tiles are cut into rectangles); where
//                a weight has fewer tiles than threads the rows are split among thread
//                groups summed in a fixed order (window_core_bwd.cuh's wgrad_kernel gives
//                each output tile a 32- or 64-wide block, mostly zeros at C = 24); A and B
//                fp32 or bf16 token rows;
//   transpose_kernel
//                weight matrices transposed into a workspace, so that a product with W^T
//                streams its weights through the same ring as one with W.
// Every sum runs in a fixed order in one thread or one set of shuffles: a repeat gives the
// same bits.

#pragma once

#include "window_fwd.cuh"

namespace wbwd {

using namespace wfwd;

constexpr int kMaxCols = 144;  // columns one product takes at most (7 x 36 tiles of 8 x 4; 8 x 18 of 8 x 8)
constexpr int kSmemMax = 232448;       // dynamic shared memory a block may use

template <int N> struct TnTag { static constexpr int value = N; };

// The register tile width for a GEMM of nb columns: the narrowest whose kRowGroups x nb / TN
// tiles fit the 256 threads (7 row groups: TN <= 4). The any-window class's 8 row groups take TN
// 2, 4 or 8 (three instantiations a product, as the 7x7 class: its build is the longest).
__host__ __device__ constexpr int tn_for(int nb) {
  if (!kAnyWindow) return nb <= 36 ? 1 : nb <= 72 ? 2 : 4;
  return nb <= 64 ? 2 : nb <= 128 ? 4 : 8;
}

// f(TnTag<TN>{}) with TN = tn_for(nb): one instantiation of the GEMM per tile width.
template <typename F>
__device__ __forceinline__ void with_tn(int nb, F f) {
  const int tn = tn_for(nb);
  if constexpr (kAnyWindow) {
    if (tn == 2) f(TnTag<2>{});
    else if (tn == 4) f(TnTag<4>{});
    else f(TnTag<8>{});
  } else {
    if (tn == 1) f(TnTag<1>{});
    else if (tn == 2) f(TnTag<2>{});
    else f(TnTag<4>{});
  }
}

template <int TN> struct Tile {
  float v[8][TN];
  int tile;  // rg + kRowGroups cg of the thread's tile, -1 for none
};

template <int TN>
__device__ __forceinline__ void zero_tile(Tile<TN>& s) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s.v[i][j] = 0.0f;
}

// acc += 16 channels of A (channel-major, at the tile's row group) times the same channels of
// B ([k][ldb], at the tile's columns).
template <int TN>
__device__ __forceinline__ void chunk_tn(float (&acc)[8][TN], const float* a, const float* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < kKc; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kPitchF);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kPitchF + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[TN];
    if constexpr (TN == 8) {
      const float4 b4 = *reinterpret_cast<const float4*>(b + kk * ldb);
      const float4 c4 = *reinterpret_cast<const float4*>(b + kk * ldb + 4);
      bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
      bv[4] = c4.x, bv[5] = c4.y, bv[6] = c4.z, bv[7] = c4.w;
    } else if constexpr (TN == 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(b + kk * ldb);
      bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
    } else if constexpr (TN == 2) {
      const float2 b2 = *reinterpret_cast<const float2*>(b + kk * ldb);
      bv[0] = b2.x, bv[1] = b2.y;
    } else {
      bv[0] = b[kk * ldb];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A Gemm of one weight matrix w ([K][ldw], columns nb of which ncols are real).
__device__ __forceinline__ Gemm weights(const float* w, int nb, int ldw, int K, int ncols = 0) {
  Gemm g{};
  g.aparts = 1;
  g.w[0] = w;
  g.n = g.nb = nb;
  g.ldw = ldw;
  g.K = K;
  g.ncols = ncols;
  return g;
}

// acc += A @ B over g.K channels with A resident (a0; a1 for the k/v parts under cross,
// window_fwd.cuh's a_part) and the weights streamed through a kDepth-deep ring of 16
// channels. g.nb must be a multiple of 4 (the ring's 16-byte copies) and of TN; A's channels
// from K to K rounded to 16 must be finite (they meet the ring's zero rows). Ends with a
// barrier.
template <int TN, int kDepth = kStages>
__device__ __forceinline__ void gemm_tile(Tile<TN>& acc, const Gemm& g, const float* a0, const float* a1,
                                          float* bbuf) {
  const int tid = threadIdx.x;
  const bool active = tid < kRowGroups * (g.nb / TN);
  const int rg = tid % kRowGroups, cg = tid / kRowGroups;
  const float* a = (a_part(g, cg * TN >= g.n) ? a1 : a0) + a_col(rg);
  const int chunks = (g.K + kKc - 1) / kKc;
  auto issue = [&](int c) {
    if (c < chunks) issue_b(g, bbuf + (c % kDepth) * kKc * g.nb, c * kKc, g.nb);
    cp_async_commit();
  };
  for (int c = 0; c < kDepth - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kDepth - 2>();
    __syncthreads();
    issue(c + kDepth - 1);
    if (active) chunk_tn<TN>(acc.v, a + c * kKc * kPitchF, bbuf + (c % kDepth) * kKc * g.nb + cg * TN, g.nb);
  }
  cp_async_wait<0>();
  __syncthreads();
  acc.tile = active ? tid : -1;
}

// acc += A @ B over g.K channels with A streamed from device memory: row t of A part p at
// g.abase[p] + g.rows[t], fp32 or (a_bf16) bf16 upcast as it is loaded, into a
// two-slot ring in the layout of window_fwd.cuh's gemm_f32 ([part][k][kPitchF], row groups at
// a_col), the weights through a two-slot cp.async ring (bbuf). Each thread loads its share of
// chunk c + 1 into registers before it multiplies chunk c and stores it after, so the loads
// overlap the FMAs. g.nb must be a multiple of 4 and of TN. Ends with a barrier.
template <int TN>
__device__ __forceinline__ void gemm_stream(Tile<TN>& acc, const Gemm& g, float* abuf, float* bbuf, int a_bf16) {
  constexpr int kPer = (2 * kKc * kT + kThreads - 1) / kThreads;  // A elements a thread stages
  const int T = tokens(g.t);
  const int tid = threadIdx.x;
  const bool active = tid < kRowGroups * (g.nb / TN);
  const int rg = tid % kRowGroups, cg = tid / kRowGroups;
  const int ap = a_part(g, cg * TN >= g.n);
  const int chunks = (g.K + kKc - 1) / kKc;
  const int per = g.aparts * kKc * T, slot = g.aparts * kKc * kPitchF;
  float staged[kPer];
  auto fetch = [&](int c) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads, kk = i % kKc, t = (i / kKc) % T, k = c * kKc + kk;
      const void* base = i >= kKc * T ? g.abase[1] : g.abase[0];
      const int at = g.rows[t] + k;
      staged[u] = i >= per || k >= g.K ? 0.0f
                  : a_bf16              ? __bfloat162float(static_cast<const bf16*>(base)[at])
                                        : static_cast<const float*>(base)[at];
    }
  };
  auto place = [&](int c) {
    float* ab = abuf + (c % 2) * slot;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThreads, kk = i % kKc, t = (i / kKc) % T, part = i / (kKc * T);
      if (i < per) ab[(part * kKc + kk) * kPitchF + a_col(t >> 3) + (t & 7)] = staged[u];
    }
  };
  auto issue_w = [&](int c) {
    if (c < chunks) issue_b(g, bbuf + (c % 2) * kKc * g.nb, c * kKc, g.nb);
    cp_async_commit();
  };
  fetch(0);
  place(0);
  issue_w(0);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();
    const bool more = c + 1 < chunks;
    if (more) fetch(c + 1);
    issue_w(c + 1);
    if (active)
      chunk_tn<TN>(acc.v, abuf + (c % 2) * slot + ap * kKc * kPitchF + a_col(rg), bbuf + (c % 2) * kKc * g.nb + cg * TN,
                   g.nb);
    if (more) place(c + 1);  // slot (c + 1) % 2 was last read before this chunk's barrier
  }
  cp_async_wait<0>();
  __syncthreads();
  acc.tile = active ? tid : -1;
}

// f(t, col, sum) for every row t < T and column col < ncols of the thread's tile.
template <int TN, typename F>
__device__ __forceinline__ void each(const Tile<TN>& s, int ncols, F f, int ntok = kT) {
  if (s.tile < 0) return;
  const int T = tokens(ntok);
  const int rg = s.tile % kRowGroups, c0 = s.tile / kRowGroups * TN;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (rg * 8 + i < T && c0 + j < ncols) f(rg * 8 + i, c0 + j, s.v[i][j]);
}

// A resident operand's element (t, k), fp32 channel-major.
__device__ __forceinline__ float& a_at(float* a, int t, int k) { return a[k * kPitchF + a_col(t >> 3) + (t & 7)]; }

// K channels of a resident operand to token rows of device memory: row t to
// dst[tok[t] * width + k], consecutive threads along k.
__device__ __forceinline__ void store_a(float* a, int K, float* dst, int width, const int* tok, int ntok = kT) {
  each_row_col(tokens(ntok), K, [&](int t, int k) { dst[static_cast<size_t>(tok[t]) * width + k] = a_at(a, t, k); });
}

template <int DP>
__device__ __forceinline__ void load_row(const float* p, float (&r)[DP]) {
#pragma unroll
  for (int j = 0; j < DP; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + j);
    r[j] = v.x, r[j + 1] = v.y, r[j + 2] = v.z, r[j + 3] = v.w;
  }
}

template <int DP>
__device__ __forceinline__ float dot_row(const float (&a)[DP], const float* b) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
  for (int j = 0; j < DP; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + j);
    s0 = fmaf(a[j], v.x, s0);
    s1 = fmaf(a[j + 1], v.y, s1);
    s2 = fmaf(a[j + 2], v.z, s2);
    s3 = fmaf(a[j + 3], v.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// keys per lane of a query row in the rows pass (4 x 13 >= 49; the any-window class 4 x 16 = 64)
constexpr int kQuarter = kAnyWindow ? 16 : 13;

// A lane's bias-table gradient sums (tab below), one chain over every head and window its block
// walks: fp32 in the 7x7 class; double in the any-window class, whose 64-row blocks often fit
// one an SM and so walk twice the windows (the 224² batch-20 step's stage-0 table at 8x8: the
// fp32 chain put it 1.56e-4 of its largest from the exact gradient, the composition 1.19e-4).
using TabSum = std::conditional<kAnyWindow, double, float>::type;

// The rows pass. Thread (t, qd) = (tid / 4, tid % 4) holds keys kQuarter qd.. of query row t for
// every head in turn (64 rows: the any-window class's every row). q/k/v/g_o: [heads][T][DP] fp32
// (q scaled, pads 0); bias: the relative-position bias of the window ([T][T]), -inf between wrap
// regions. Writes scale * g_S k for (t, head h, dim j) through gq(t, h * d + j, value), and
// (1 / sum, dot) of every (h, t) to rd; adds g_S to tab, the lane's bias-gradient sums of entries
// (t, kQuarter qd + uu). kDrop: g_P = g_o v^T is masked by the keep words (keep_w, [heads][T][2],
// hash_dropout.cuh) and drop_scale before dot and g_S, whose P stays the undropped one.
template <int DP, bool kDrop = false, typename GqOut>
__device__ void core_bwd_rows(const float* q_s, const float* k_s, const float* v_s, const float* go_s,
                              const float* bias_s, int heads, int d, float scale, float2* rd,
                              TabSum (&tab)[kQuarter], GqOut gq_out, const uint32_t* keep_w = nullptr,
                              float drop_scale = 1.0f, int ntok = kT) {
  const int T = tokens(ntok);
  const int t = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const bool act = t < T;
  const int tq = act ? t : T - 1;
  const int u0 = qd * kQuarter;
  const unsigned mask = 0xfu << (threadIdx.x & 28);  // the four lanes of this row
  auto sum4 = [&](float v) {
    v += __shfl_xor_sync(mask, v, 1);
    return v + __shfl_xor_sync(mask, v, 2);
  };
  for (int h = 0; h < heads; ++h) {
    float qr[DP], gor[DP];
    load_row<DP>(q_s + (h * T + tq) * DP, qr);
    load_row<DP>(go_s + (h * T + tq) * DP, gor);
    const float* kh = k_s + h * T * DP;
    const float* vh = v_s + h * T * DP;
    float e[kQuarter], gp[kQuarter];
    float se = 0.0f, sg = 0.0f;
    const uint32_t* kw = kDrop ? keep_w + (h * T + tq) * swin::kKeepWords : nullptr;
#pragma unroll
    for (int uu = 0; uu < kQuarter; ++uu) {
      const int u = u0 + uu;
      e[uu] = gp[uu] = 0.0f;
      if (u < T) {
        e[uu] = expf(fminf(dot_row<DP>(qr, kh + u * DP) + bias_s[tq * T + u], kSoftmaxClamp));
        gp[uu] = dot_row<DP>(gor, vh + u * DP);
        if constexpr (kDrop) gp[uu] = swin::masked(swin::word_keep(kw, u), gp[uu], drop_scale);
        se += e[uu];
        sg = fmaf(e[uu], gp[uu], sg);
      }
    }
    const float r = 1.0f / (sum4(se) + 1e-30f);
    const float dot = sum4(sg) * r;
    float gq[DP];
#pragma unroll
    for (int j = 0; j < DP; ++j) gq[j] = 0.0f;
#pragma unroll
    for (int uu = 0; uu < kQuarter; ++uu) {
      const int u = u0 + uu;
      if (u < T) {
        const float gs = e[uu] * r * (gp[uu] - dot);
        tab[uu] += gs;
#pragma unroll
        for (int j = 0; j < DP; j += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kh + u * DP + j);
          gq[j] = fmaf(gs, kv.x, gq[j]);
          gq[j + 1] = fmaf(gs, kv.y, gq[j + 1]);
          gq[j + 2] = fmaf(gs, kv.z, gq[j + 2]);
          gq[j + 3] = fmaf(gs, kv.w, gq[j + 3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DP; ++j) gq[j] = sum4(gq[j]);
    if (act && qd == 0) {
#pragma unroll
      for (int j = 0; j < DP; ++j)
        if (j < d) gq_out(t, h * d + j, gq[j] * scale);
      rd[h * T + t] = make_float2(r, dot);
    }
  }
}

// The columns pass: a lane per (head, key u), the T query rows in order. Writes g_k and
// g_v of (u, head h, dim j) through gkv(u, h * d + j, g_k, g_v). kDrop: g_P masked as in the
// rows pass, and g_v = drop(P)^T g_o.
template <int DP, bool kDrop = false, typename GkvOut>
__device__ void core_bwd_cols(const float* q_s, const float* k_s, const float* v_s, const float* go_s,
                              const float* bias_s, int heads, int d, const float2* rd, GkvOut gkv_out,
                              const uint32_t* keep_w = nullptr, float drop_scale = 1.0f, int ntok = kT) {
  const int T = tokens(ntok);
  for (int item = threadIdx.x; item < heads * T; item += kThreads) {
    const int h = item / T, u = item - h * T;
    float kr[DP], vr[DP], gk[DP], gv[DP];
    load_row<DP>(k_s + (h * T + u) * DP, kr);
    load_row<DP>(v_s + (h * T + u) * DP, vr);
#pragma unroll
    for (int j = 0; j < DP; ++j) gk[j] = gv[j] = 0.0f;
    const float* qh = q_s + h * T * DP;
    const float* goh = go_s + h * T * DP;
#pragma unroll 7
    for (int t = 0; t < T; ++t) {
      const float e = expf(fminf(dot_row<DP>(kr, qh + t * DP) + bias_s[t * T + u], kSoftmaxClamp));
      const float2 rdt = rd[h * T + t];
      float p = e * rdt.x;
      float gs;
      if constexpr (kDrop) {
        const bool keep = swin::word_keep(keep_w + (h * T + t) * swin::kKeepWords, u);
        gs = p * (swin::masked(keep, dot_row<DP>(vr, goh + t * DP), drop_scale) - rdt.y);
        p = swin::masked(keep, p, drop_scale);  // g_v's weight: the dropped P
      } else {
        gs = p * (dot_row<DP>(vr, goh + t * DP) - rdt.y);
      }
#pragma unroll
      for (int j = 0; j < DP; j += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qh + t * DP + j);
        const float4 gv4 = *reinterpret_cast<const float4*>(goh + t * DP + j);
        gk[j] = fmaf(gs, qv.x, gk[j]);
        gk[j + 1] = fmaf(gs, qv.y, gk[j + 1]);
        gk[j + 2] = fmaf(gs, qv.z, gk[j + 2]);
        gk[j + 3] = fmaf(gs, qv.w, gk[j + 3]);
        gv[j] = fmaf(p, gv4.x, gv[j]);
        gv[j + 1] = fmaf(p, gv4.y, gv[j + 1]);
        gv[j + 2] = fmaf(p, gv4.z, gv[j + 2]);
        gv[j + 3] = fmaf(p, gv4.w, gv[j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < DP; ++j)
      if (j < d) gkv_out(u, h * d + j, gk[j], gv[j]);
  }
}

// Both passes of the core's backward for the `heads` heads of q/k/v/g_o (a window's heads, or a
// group of them), with the barrier between them.
template <int DP, bool kDrop = false, typename GqOut, typename GkvOut>
__device__ __forceinline__ void core_bwd(const float* q_s, const float* k_s, const float* v_s, const float* go_s,
                                         const float* bias_s, int heads, int d, float scale, float2* rd,
                                         TabSum (&tab)[kQuarter], GqOut gq_out, GkvOut gkv_out,
                                         const uint32_t* keep_w = nullptr, float drop_scale = 1.0f, int ntok = kT) {
  core_bwd_rows<DP, kDrop>(q_s, k_s, v_s, go_s, bias_s, heads, d, scale, rd, tab, gq_out, keep_w, drop_scale, ntok);
  __syncthreads();
  core_bwd_cols<DP, kDrop>(q_s, k_s, v_s, go_s, bias_s, heads, d, rd, gkv_out, keep_w, drop_scale, ntok);
}

// ---- the core's backward at row pitches above kPassesPitchMax (d = 48: stage 4) -------------
// core_bwd's passes keep three rows of DP floats a lane (the rows pass q, g_o and g_q; the
// columns pass k, v, g_k and g_v): at DP = 48 that is 144-192 registers, which spill, and the
// columns pass gives one thread to each of a head's 49 keys. Here a head's P and g_S go to
// shared memory instead (2 x [49][kPP] floats), and every product of the head runs on 224 of
// the 256 threads (7x7 class):
//   the rows pass: lane (t, qd) forms the scores of its 13 keys, then their g_P = g_o v^T (two
//     loops, so that only one operand's 13 column slices are in flight: with both, the block
//     spilled even at 255 registers), each walking the head dimension four columns at a time
//     (each dot product summed in column order), then exp, the row's sums over the four lanes,
//     P = e / sum, g_S = P (g_P - dot), the bias-table gradient and the P (kDrop: the dropped
//     P) and g_S rows;
//   the products: AV = P v, g_q = scale g_S k, g_k = g_S^T q and g_v = P^T g_o, each 49 x 49 by
//     49 x DP, a thread a 7-row x DP/8-column tile (56 tiles a product, each sum over the 49
//     keys or query rows in order).
// The any-window class (T <= 64) runs the same passes on 64 rows and every one of the 256
// threads: the rows pass's lanes take 16 keys each, and a product tile is 8 rows x DP/8 columns
// (64 tiles a product), its rows interleaved (rg, rg + 8, ...) so that the tiles' reads of P and
// g_S, rows pitched kPP = 65 floats, fall in distinct banks; rows and keys from T on are never
// summed or stored.
// kDrop as core_bwd's: g_P masked by the keep words and drop_scale before dot and g_S, AV and
// g_v from the dropped P, g_S from the undropped one. AV (wp's gradient's operand) is formed
// here, so the block runs no attention_core.
constexpr int kPassesPitchMax = 24;  // the largest row pitch core_bwd takes in a block
constexpr int kPP = kAnyWindow ? 65 : 52;  // floats a row of P and g_S: 49 keys padded to 16 bytes; 64 + 1
constexpr int kTileRows = kAnyWindow ? 8 : 7;         // rows of a product tile
constexpr int kProductTiles = kTileRows * 8;          // tiles of a product: 8 row groups x 8 column groups

// P and g_S of one head, kT rows each (the products of the any-window class read its padded rows)
__host__ __device__ constexpr int tiled_core_bytes() { return align16(2 * kT * kPP * 4); }

template <int DP, bool kDrop = false, typename AvOut, typename GqOut, typename GkOut, typename GvOut>
__device__ void core_bwd_tiled(const float* q_s, const float* k_s, const float* v_s, const float* go_s,
                               const float* bias_s, int heads, int d, float scale, float* ps,
                               TabSum (&tab)[kQuarter], AvOut av_out, GqOut gq_out, GkOut gk_out, GvOut gv_out,
                               const uint32_t* keep_w = nullptr, float drop_scale = 1.0f, int ntok = kT) {
  constexpr int kTw = DP / 8;  // columns of a product tile: 8 column groups
  static_assert(DP % 16 == 0 && kTw % 2 == 0, "the tiles load float2 pairs of the head dimension");
  // a tile's rows: rg * 7 + i in the 7x7 class, rg + 8 i in the any-window class
  constexpr int kRowStep = kAnyWindow ? 8 : 1;
  const int T = tokens(ntok);
  const int t = threadIdx.x >> 2, qd = threadIdx.x & 3;
  const bool act = t < T;
  const int tq = act ? t : T - 1;
  const int u0 = qd * kQuarter;
  const unsigned mask = 0xfu << (threadIdx.x & 28);  // the four lanes of this row
  auto sum4 = [&](float v) {
    v += __shfl_xor_sync(mask, v, 1);
    return v + __shfl_xor_sync(mask, v, 2);
  };
  float* p_s = ps;             // [kT][kPP]: P (kDrop: dropped)
  float* g_s = ps + kT * kPP;  // [kT][kPP]: g_S
  const int job = threadIdx.x / kProductTiles, tile = threadIdx.x % kProductTiles;
  const int rg = tile % kTileRows, cg = tile / kTileRows;
  const int r0 = kAnyWindow ? rg : rg * kTileRows;  // the tile's first row
  for (int h = 0; h < heads; ++h) {
    const float* qh = q_s + h * T * DP;
    const float* kh = k_s + h * T * DP;
    const float* vh = v_s + h * T * DP;
    const float* goh = go_s + h * T * DP;
    {  // the rows pass
      float e[kQuarter], gp[kQuarter];
#pragma unroll
      for (int uu = 0; uu < kQuarter; ++uu) e[uu] = gp[uu] = 0.0f;
      const float* qrow = qh + tq * DP;
      const float* grow = goh + tq * DP;
#pragma unroll 1
      for (int j = 0; j < DP; j += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + j);
#pragma unroll
        for (int uu = 0; uu < kQuarter; ++uu) {
          const int u = min(u0 + uu, T - 1);  // the last lane's keys past T - 1 repeat key T - 1, unused
          const float4 k4 = *reinterpret_cast<const float4*>(kh + u * DP + j);
          e[uu] = fmaf(q4.w, k4.w, fmaf(q4.z, k4.z, fmaf(q4.y, k4.y, fmaf(q4.x, k4.x, e[uu]))));
        }
      }
#pragma unroll 1
      for (int j = 0; j < DP; j += 4) {
        const float4 g4 = *reinterpret_cast<const float4*>(grow + j);
#pragma unroll
        for (int uu = 0; uu < kQuarter; ++uu) {
          const int u = min(u0 + uu, T - 1);
          const float4 v4 = *reinterpret_cast<const float4*>(vh + u * DP + j);
          gp[uu] = fmaf(g4.w, v4.w, fmaf(g4.z, v4.z, fmaf(g4.y, v4.y, fmaf(g4.x, v4.x, gp[uu]))));
        }
      }
      const uint32_t* kw = kDrop ? keep_w + (h * T + tq) * swin::kKeepWords : nullptr;
      float se = 0.0f, sg = 0.0f;
#pragma unroll
      for (int uu = 0; uu < kQuarter; ++uu) {
        const int u = u0 + uu;
        if (u < T) {
          e[uu] = expf(fminf(e[uu] + bias_s[tq * T + u], kSoftmaxClamp));
          if constexpr (kDrop) gp[uu] = swin::masked(swin::word_keep(kw, u), gp[uu], drop_scale);
          se += e[uu];
          sg = fmaf(e[uu], gp[uu], sg);
        }
      }
      const float r = 1.0f / (sum4(se) + 1e-30f);
      const float dot = sum4(sg) * r;
#pragma unroll
      for (int uu = 0; uu < kQuarter; ++uu) {
        const int u = u0 + uu;
        if (u < T) {
          const float p = e[uu] * r;
          const float gs = p * (gp[uu] - dot);
          tab[uu] += gs;
          if (act) {
            if constexpr (kDrop) p_s[t * kPP + u] = swin::masked(swin::word_keep(kw, u), p, drop_scale);
            else p_s[t * kPP + u] = p;
            g_s[t * kPP + u] = gs;
          }
        }
      }
    }
    __syncthreads();
    if (job < 4) {  // the products: AV = P v, g_q = g_S k (rows t); g_k = g_S^T q, g_v = P^T g_o (rows u)
      const bool by_t = job < 2;
      const float* a = (job == 0 || job == 3 ? p_s : g_s) + (by_t ? r0 * kPP : r0);
      // strides of a tile row and of the sum's index
      const int si = by_t ? kRowStep * kPP : kRowStep, sk = by_t ? 1 : kPP;
      const float* b = (job == 0 ? vh : job == 1 ? kh : job == 2 ? qh : goh) + cg * kTw;
      float acc[kTileRows][kTw];
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < kTw; ++j) acc[i][j] = 0.0f;
#pragma unroll 7
      for (int k = 0; k < T; ++k) {
        float bv[kTw];
#pragma unroll
        for (int j = 0; j < kTw; j += 2) {
          const float2 b2 = *reinterpret_cast<const float2*>(b + k * DP + j);
          bv[j] = b2.x, bv[j + 1] = b2.y;
        }
#pragma unroll
        for (int i = 0; i < kTileRows; ++i) {
          const float av = a[i * si + k * sk];
#pragma unroll
          for (int j = 0; j < kTw; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < kTw; ++j) {
          const int row = r0 + kRowStep * i, col = cg * kTw + j;
          if (col >= d || (kAnyWindow && row >= T)) continue;
          if (job == 0) av_out(row, h * d + col, acc[i][j]);
          else if (job == 1) gq_out(row, h * d + col, acc[i][j] * scale);
          else if (job == 2) gk_out(row, h * d + col, acc[i][j]);
          else gv_out(row, h * d + col, acc[i][j]);
        }
    }
    __syncthreads();  // the next head's rows pass writes P and g_S
  }
}

// ---- weight gradients: partial[chunk] (Ka + 1, Nb) = [A | 1]^T B over a chunk of rows -----
// One launch for every weight of a call (up to kMaxWgJobs jobs of their own shapes), a block
// per (chunk of rows, job, group of output tiles). A thread holds a 4 x 4 output tile in
// registers; where a job has fewer tiles than threads (C = 24: 7 x 6 tiles), the block's
// threads split each slab's rows into groups that a fixed-order pass sums at the end. Rows
// arrive in slabs of kWgSlab through shared memory in 16-byte loads; the ones column of A (the
// bias gradient) is appended there.
constexpr int kWgSlab = 64;
constexpr int kMaxWgJobs = 12;

struct WgJob {
  const void* a;  // (M, ka) token rows, fp32 or (a_bf16) bf16
  const void* b;  // (M, nb) token rows, fp32 or (b_bf16) bf16
  float* part;    // (chunks, ka + 1, nb)
  int ka, nb, b_bf16, a_bf16;
};

// Four consecutive elements of fp32 or bf16 token rows at element `at`, as fp32.
__device__ __forceinline__ float4 load4(const void* p, size_t at, int is_bf16) {
  if (!is_bf16) return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + at);
  const bf16* b = static_cast<const bf16*>(p) + at;
  return make_float4(__bfloat162float(b[0]), __bfloat162float(b[1]), __bfloat162float(b[2]), __bfloat162float(b[3]));
}

struct WgJobs {
  WgJob job[kMaxWgJobs];
  int count, rows, chunk_rows;
};

__host__ __device__ inline int wg_tiles(int ka, int nb) { return ((ka + 4) / 4) * ((nb + 3) / 4); }
// A job with more than kWgRect tile rows and tile columns (K3's at C >= 96) is cut into
// rectangles of kWgRect x kWgRect tiles, a block each, that load only their columns of A and
// B; a smaller job takes kThreads consecutive tiles a block and loads whole rows.
constexpr int kWgRect = 16;
__host__ __device__ inline bool wg_rect(int ka, int nb) { return (ka + 4) / 4 > kWgRect && (nb + 3) / 4 > kWgRect; }
// Blocks of one chunk of rows of a job.
__host__ __device__ inline int wg_groups_of_tiles(int ka, int nb) {
  if (wg_rect(ka, nb)) return ((ka + 4) / 4 + kWgRect - 1) / kWgRect * (((nb + 3) / 4 + kWgRect - 1) / kWgRect);
  return (wg_tiles(ka, nb) + kThreads - 1) / kThreads;
}
// Shared memory of a job's block: the A slab (its columns of ka + 1, pitched to 4) and the B
// slab, or the row groups' 4 x 4 sums where they take more.
__host__ __device__ inline int wg_smem(int ka, int nb) {
  const int cols = wg_rect(ka, nb) ? 8 * kWgRect : round_up(ka + 1, 4) + round_up(nb, 4);
  return max2(kWgSlab * cols, kThreads * 16) * 4;
}
// Chunks of `rows` token rows that a launch of `jobs` jobs cuts (about eight blocks an SM of
// a 132-SM card), and the rows of each.
constexpr int kWgTargetBlocks = 132 * 8;
__host__ __device__ inline int wg_chunk_rows(int rows, int jobs) {
  const int slabs = (rows + kWgSlab - 1) / kWgSlab, want = kWgTargetBlocks / jobs;
  const int chunks = max2(1, slabs < want ? slabs : want);
  return round_up((rows + chunks - 1) / chunks, kWgSlab);
}

__global__ void __launch_bounds__(kThreads) wgrad_rows_kernel(const WgJobs p) {
  extern __shared__ __align__(16) float wsm[];
  const WgJob jb = p.job[blockIdx.y];
  const int ka = jb.ka, nb = jb.nb, tid = threadIdx.x;
  const int tiles_a = (ka + 4) / 4, tiles_b = (nb + 3) / 4;
  int ta0 = 0, tb0 = 0, na = tiles_a, nbt = tiles_b, first = 0;  // the block's tiles: a rectangle, or a run
  if (wg_rect(ka, nb)) {
    const int across = (tiles_b + kWgRect - 1) / kWgRect;
    ta0 = blockIdx.z / across * kWgRect;
    tb0 = blockIdx.z % across * kWgRect;
    if (ta0 >= tiles_a) return;
    na = min(kWgRect, tiles_a - ta0);
    nbt = min(kWgRect, tiles_b - tb0);
  } else {
    first = blockIdx.z * kThreads;
    if (first >= tiles_a * tiles_b) return;
  }
  const int mine = min(kThreads, na * nbt - first);  // output tiles of this block
  const int groups = kThreads / mine;                // row groups (1 where the tiles fill the block)
  const int group = tid / mine, tile = first + tid % mine;
  const bool active = group < groups;
  const int ta = tile / nbt, tb = tile - ta * nbt;  // within the block's columns
  const int pa = 4 * na, pb = 4 * nbt, ca0 = 4 * ta0, cb0 = 4 * tb0;
  float* as = wsm;
  float* bs = wsm + kWgSlab * pa;
  const int r_begin = blockIdx.x * p.chunk_rows, r_end = min(p.rows, r_begin + p.chunk_rows);
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kWgSlab) {
    __syncthreads();
    for (int e = tid; e < kWgSlab * (pa / 4); e += kThreads) {
      const int r = e / (pa / 4), c = (e - r * (pa / 4)) * 4, row = r0 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < r_end) {
        if (ca0 + c < ka) v = load4(jb.a, static_cast<size_t>(row) * ka + ca0 + c, jb.a_bf16);
        else if (ca0 + c == ka) v.x = 1.0f;  // the ones column: the bias gradient
      }
      *reinterpret_cast<float4*>(as + r * pa + c) = v;
    }
    for (int e = tid; e < kWgSlab * (pb / 4); e += kThreads) {
      const int r = e / (pb / 4), c = (e - r * (pb / 4)) * 4, row = r0 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < r_end && cb0 + c < nb) v = load4(jb.b, static_cast<size_t>(row) * nb + cb0 + c, jb.b_bf16);
      *reinterpret_cast<float4*>(bs + r * pb + c) = v;
    }
    __syncthreads();
    if (active)
      for (int r = group; r < kWgSlab; r += groups) {
        const float4 av = *reinterpret_cast<const float4*>(as + r * pa + 4 * ta);
        const float4 bv = *reinterpret_cast<const float4*>(bs + r * pb + 4 * tb);
        const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
      }
  }
  // the groups' sums, in group order, by group 0
  __syncthreads();
  if (active && groups > 1)
#pragma unroll
    for (int e = 0; e < 16; ++e) wsm[(group * mine + tid % mine) * 16 + e] = acc[e / 4][e % 4];
  __syncthreads();
  if (group != 0) return;
  for (int g = 1; g < groups; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e / 4][e % 4] += wsm[(g * mine + tid) * 16 + e];
  float* part = jb.part + static_cast<size_t>(blockIdx.x) * (ka + 1) * nb;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ca0 + 4 * ta + i, col = cb0 + 4 * tb;
    if (row > ka) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < nb) part[static_cast<size_t>(row) * nb + col + j] = acc[i][j];
  }
}

// ---- the transposed weights ----
constexpr int kMaxTransposes = 12;
struct Transposes {
  const float* src[kMaxTransposes];  // (rows, cols)
  float* dst[kMaxTransposes];        // (cols, rows)
  int rows[kMaxTransposes], cols[kMaxTransposes];
};

__global__ void __launch_bounds__(kThreads) transpose_kernel(const Transposes p) {
  const int j = blockIdx.y, rows = p.rows[j], cols = p.cols[j];
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < rows * cols; e += gridDim.x * kThreads) {
    const int r = e / cols, c = e - r * cols;
    p.dst[j][static_cast<size_t>(c) * rows + r] = p.src[j][e];
  }
}

}  // namespace wbwd
