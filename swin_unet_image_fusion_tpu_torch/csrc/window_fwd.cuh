// Device code of the window-attention forward, with and without dropout, shared by K3's
// redesigned forward (window_attention_fwd.cu) and the fused block's, K4 and K1
// (fused_block_fwd.cu), for Hopper (sm_90a): the
// block geometry (one 7x7 window of T = 49 tokens per block, or in the any-window class below
// one window of up to 64; 256 threads), cp.async and
// mma.sync helpers, the GEMMs of a window's rows (fp32 FMA with 8x4 register tiles, or bf16
// operands on mma.sync.m16n8k16 with fp32 accumulators) with x and the weights streamed
// through a cp.async ring or the A operand resident in shared memory, and the attention core
// (one lane per query row); and the fused block's LayerNorm and operand helpers, which its
// backward (fused_block_bwd.cu, window_bwd.cuh) shares. window_attention_fwd.cu's header
// says what bounds it and why the design is so.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "activation.cuh"
#include "hash_dropout.cuh"

namespace wfwd {

using bf16 = __nv_bfloat16;

// The window class a translation unit is built for. By default the 7x7 class: T = 49 tokens a
// window, a compile-time constant everywhere, which every kernel of the fused block (K1, K4)
// and K3's 7x7 forms run. With SWIN_ANY_WINDOW set (window_attention_fwd_any.cu,
// window_attention_bwd_any.cu: K3 alone) the any-window class: any window of T <= 64 tokens,
// T, wh and ww read at run time from the launch's arguments (tokens(), window_hw()), the blocks
// sized for 64 rows: eight fp32 row groups, and 8 x 8 register tiles so that a product of up to
// 256 columns still takes one tile a thread.
#ifdef SWIN_ANY_WINDOW
constexpr bool kAnyWindow = true;
#else
constexpr bool kAnyWindow = false;
#endif
constexpr int kT = kAnyWindow ? 64 : 49;          // tokens a block holds (7x7: every window's 49)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = kAnyWindow ? 8 : 7;    // fp32 GEMM rows: groups of 8 (7x7: 49 of 56 used)
constexpr int kPitchF = kAnyWindow ? 68 : 60;     // floats per fp32 A row (channel): group rg at a_col(rg)
constexpr int kRowsB = 64;          // bf16 rows: 4 mma row tiles of 16
constexpr int kKc = 16;             // channels per streamed chunk (one mma k-step)
// cp.async ring depths of the attention kernel and of the projection kernel
constexpr int kStages = 3, kProjStages = 6;
constexpr int kStrideB = kKc + 8;   // bf16 halves per A chunk row: 12 words, = 4 mod 8
constexpr int kPStride = 72;        // bf16 halves per row of P and v^T: 36 words
constexpr int kProjCols = 48;       // output columns per block of the projection kernel
constexpr int kMaxNTilesB = 3;      // bf16 GEMM: at most three 8-column tiles per warp
constexpr float kSoftmaxClamp = 80.0f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int align16(int v) { return round_up(v, 16); }
__host__ __device__ constexpr int max2(int a, int b) { return a > b ? a : b; }

// Column of row group rg in an fp32 A row: groups 4-7 shifted by 4 floats, so that the seven
// (any-window class: eight) float4 a quarter-warp reads fall in distinct bank quads.
__host__ __device__ constexpr int a_col(int rg) { return rg * 8 + (rg >= 4 ? 4 : 0); }

constexpr int kTileN = kAnyWindow ? 8 : 4;  // fp32 register tile: 8 rows x kTileN columns
// fp32 GEMM of nb columns: kRowGroups row groups x nb/kTileN column groups, one tile per thread.
__host__ __device__ constexpr int f32_tiles(int nb) { return kRowGroups * (nb / kTileN); }

// The tokens of the call's window: kT in the 7x7 class (a constant the compiler folds), the
// call's t in the any-window class.
__host__ __device__ constexpr int tokens(int t) { return kAnyWindow ? t : kT; }

// The window's (rows, columns): 7 x 7, or the launch's wh x ww in the any-window class.
template <typename Args>
__host__ __device__ __forceinline__ int2 window_hw(const Args& a) {
  if constexpr (kAnyWindow) return make_int2(a.wh, a.ww);
  else return make_int2(7, 7);
}
constexpr int kColTable = 192;      // q/k/v columns of a block at most (3 x 64)

// bytes of the A ring and of the B (weight) ring; bf16 keeps the weights fp32 in the ring,
// rows pitched nb + 4 floats so that a fragment's loads fall in distinct banks
__host__ __device__ inline int ring_a_bytes(bool bf16_io, int parts, int stages) {
  return stages * parts * (bf16_io ? kRowsB * kStrideB * 2 : kKc * kPitchF * 4);
}
__host__ __device__ constexpr int b_pitch(bool bf16_io, int nb) { return bf16_io ? nb + 4 : nb; }
__host__ __device__ inline int b_bytes(bool bf16_io, int nb, int stages) {
  return stages * kKc * b_pitch(bf16_io, nb) * 4;
}

// ---- small device helpers ---------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 4 or 16 bytes; with ok == false the destination is zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// D += A B, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- the GEMMs: Y[T, NB] = A[T, K] @ Wcols[K, NB] ------------------------------------------
// Column c of the NB belongs to part c / n (q, k, v; one part for a projection) and reads
// w[part][k * ldw + c % n]; columns from `ncols` on (where set) load as 0. A is streamed from
// device memory (row t of A's part `apart` at abase[apart] + rows[t], channel k contiguous)
// or resident in shared memory (the *_res forms); B is always streamed.
struct Gemm {
  const void* abase[2];  // A, per A part (the q part reads 0, k/v read 1 under cross)
  const int* rows;       // row offsets (elements) of the T tokens
  int aparts;
  const float* w[3];
  int n, ldw, nb, K;
  int ncols;             // real columns of the nb (0: all)
  int t;                 // the any-window class's T, the rows streamed A loads (tokens())
};

// The A part of a column: the q part reads stream s, the k/v parts stream kv(s).
__device__ __forceinline__ int a_part(const Gemm& g, bool kv) { return kv && g.aparts > 1 ? 1 : 0; }

// Weight chunk k0.. (16 rows) of the GEMM's columns into one ring slot ([k][ldb]).
__device__ __forceinline__ void issue_b(const Gemm& g, float* bb, int k0, int ldb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ncols = g.ncols ? g.ncols : g.nb;
  for (int kk = warp; kk < kKc; kk += kWarps) {
    const int k = k0 + kk;
    for (int col = lane * 4; col < g.nb; col += 128) {
      const int part = (col >= g.n) + (col >= 2 * g.n);
      const bool ok = k < g.K && col < ncols;
      // selects, not g.w[part]: a runtime index would put the struct in local memory
      const float* src = (part == 0 ? g.w[0] : part == 1 ? g.w[1] : g.w[2]) + (col - part * g.n);
      cp_async16(bb + kk * ldb + col, ok ? src + static_cast<size_t>(k) * g.ldw : g.w[0], ok);
    }
  }
}

// fp32: acc += 16 channels of A (channel-major, pitch kPitchF, at the tile's row group) times
// the same channels of B ([k][ldb], at the tile's columns).
__device__ __forceinline__ void f32_chunk(float (&acc)[8][kTileN], const float* a, const float* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < kKc; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kPitchF);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kPitchF + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[kTileN];
#pragma unroll
    for (int j = 0; j < kTileN; j += 4) {
      const float4 b4 = *reinterpret_cast<const float4*>(b + kk * ldb + j);
      bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kTileN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int M, int N>
__device__ __forceinline__ void zero_acc(float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.0f;
}
__device__ __forceinline__ void zero_acc(float (&acc)[kMaxNTilesB][4][4]) {
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) zero_acc(acc[m]);
}

// fp32: tile (rg, cg) = (tile % kRowGroups, tile / kRowGroups) holds rows 8 rg.. and columns
// kTileN cg.. in registers; per channel two float4 of A and kTileN / 4 of w feed 8 kTileN FMAs. A
// kDepth-deep cp.async ring fills chunk c + kDepth - 1 while chunk c is multiplied.
// Returns the tile whose sums this thread holds (-1: none).
template <int kDepth>
__device__ int gemm_f32(const Gemm& g, float* abuf, float* bbuf, float (&acc)[8][kTileN]) {
  const int tid = threadIdx.x;
  const bool active = tid < f32_tiles(g.nb);
  const int rg = tid % kRowGroups, cg = tid / kRowGroups;
  const int ap = a_part(g, cg * kTileN >= g.n);
  const int chunks = (g.K + kKc - 1) / kKc;
  zero_acc(acc);

  auto issue = [&](int c) {  // chunk c into ring slot c % kDepth; always one commit group
    if (c < chunks) {
      const int k0 = c * kKc, slot = c % kDepth;
      float* ab = abuf + slot * g.aparts * kKc * kPitchF;
      const int T = tokens(g.t);
      for (int i = tid; i < g.aparts * kKc * T; i += kThreads) {
        const int kk = i % kKc, t = (i / kKc) % T, part = i / (kKc * T);
        const int k = k0 + kk;
        const bool ok = k < g.K;
        const float* base = static_cast<const float*>(part ? g.abase[1] : g.abase[0]);
        cp_async4(ab + (part * kKc + kk) * kPitchF + a_col(t >> 3) + (t & 7),
                  ok ? base + g.rows[t] + k : base, ok);
      }
      issue_b(g, bbuf + slot * kKc * g.nb, k0, g.nb);
    }
    cp_async_commit();
  };

  for (int c = 0; c < kDepth - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % kDepth;
    cp_async_wait<kDepth - 2>();
    __syncthreads();
    issue(c + kDepth - 1);
    if (active)
      f32_chunk(acc, abuf + (slot * g.aparts + ap) * kKc * kPitchF + a_col(rg),
                bbuf + slot * kKc * g.nb + cg * kTileN, g.nb);
  }
  cp_async_wait<0>();
  __syncthreads();
  return active ? tid : -1;
}

// fp32 with A resident in shared memory, channel-major ([k][kPitchF]) per A part, its
// channels zero up to K rounded to 16; only the weights stream. Adds to acc. Inlined: a
// block calls it several times, and the sums must stay in registers.
template <int kDepth>
__device__ __forceinline__ int gemm_res_f32(const Gemm& g, const float* a0, const float* a1, float* bbuf,
                                            float (&acc)[8][kTileN]) {
  const int tid = threadIdx.x;
  const bool active = tid < f32_tiles(g.nb);
  const int rg = tid % kRowGroups, cg = tid / kRowGroups;
  const float* a = (a_part(g, cg * kTileN >= g.n) ? a1 : a0) + a_col(rg);
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
    if (active) f32_chunk(acc, a + c * kKc * kPitchF, bbuf + (c % kDepth) * kKc * g.nb + cg * kTileN, g.nb);
  }
  cp_async_wait<0>();
  __syncthreads();
  return active ? tid : -1;
}

// bf16: one 16-channel chunk of m16n8k16 steps. Warp w owns the 8-column tiles w, w + 8,
// w + 16 and all four 16-row tiles; the weights arrive fp32 and are rounded to bf16 as the
// fragments are built (the TPU body's cast). a(nt): the A rows ([row][lda] halves) at the
// chunk's channels for column tile nt.
template <typename AOf>
__device__ __forceinline__ void bf16_chunk(const Gemm& g, float (&acc)[kMaxNTilesB][4][4], const float* bs,
                                           int ldb, int lda, AOf a_of) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
  bs += 2 * t4 * ldb + gq;
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) {
    const int nt = warp + m * kWarps;
    if (nt < g.nb / 8) {
      const bf16* a = a_of(nt);
      const float* bn = bs + nt * 8;
      const uint32_t b0 = pack_bf16(bn[0], bn[ldb]), b1 = pack_bf16(bn[8 * ldb], bn[9 * ldb]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(a + (mt * 16 + gq) * lda);
        const uint32_t* hi = reinterpret_cast<const uint32_t*>(a + (mt * 16 + gq + 8) * lda);
        mma_bf16(acc[m][mt], lo[t4], hi[t4], lo[t4 + 4], hi[t4 + 4], b0, b1);
      }
    }
  }
}

// bf16 with A streamed: a ring of the same depth ([row][k], k contiguous) beside the
// weights'.
template <int kDepth>
__device__ void gemm_bf16(const Gemm& g, bf16* abuf, float* bbuf, float (&acc)[kMaxNTilesB][4][4]) {
  const int tid = threadIdx.x;
  const int ldb = b_pitch(true, g.nb);
  const int chunks = (g.K + kKc - 1) / kKc;
  zero_acc(acc);

  auto issue = [&](int c) {  // chunk c into ring slot c % kDepth; always one commit group
    if (c < chunks) {
      const int k0 = c * kKc, slot = c % kDepth;
      bf16* ab = abuf + slot * g.aparts * kRowsB * kStrideB;
      constexpr int kSegs = kKc / 8;  // 16-byte segments of a row's chunk
      for (int i = tid; i < g.aparts * kRowsB * kSegs; i += kThreads) {
        const int seg = i % kSegs, t = (i / kSegs) % kRowsB, part = i / (kSegs * kRowsB);
        const int k = k0 + seg * 8;
        const bool ok = t < tokens(g.t) && k < g.K;
        const bf16* base = static_cast<const bf16*>(part ? g.abase[1] : g.abase[0]);
        cp_async16(ab + (part * kRowsB + t) * kStrideB + seg * 8, ok ? base + g.rows[t] + k : base, ok);
      }
      issue_b(g, bbuf + slot * kKc * ldb, k0, ldb);
    }
    cp_async_commit();
  };

  for (int c = 0; c < kDepth - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % kDepth;
    cp_async_wait<kDepth - 2>();
    __syncthreads();
    issue(c + kDepth - 1);
    const bf16* a = abuf + slot * g.aparts * kRowsB * kStrideB;
    bf16_chunk(g, acc, bbuf + slot * kKc * ldb, ldb, kStrideB,
               [&](int nt) { return a + a_part(g, nt * 8 >= g.n) * kRowsB * kStrideB; });
  }
  cp_async_wait<0>();
  __syncthreads();
}

// bf16 with A resident ([64][lda] halves per A part, channels zero up to K rounded to 16);
// only the weights stream. Adds to acc.
template <int kDepth>
__device__ __forceinline__ void gemm_res_bf16(const Gemm& g, const bf16* a0, const bf16* a1, int lda, float* bbuf,
                              float (&acc)[kMaxNTilesB][4][4]) {
  const int ldb = b_pitch(true, g.nb);
  const int chunks = (g.K + kKc - 1) / kKc;
  auto issue = [&](int c) {
    if (c < chunks) issue_b(g, bbuf + (c % kDepth) * kKc * ldb, c * kKc, ldb);
    cp_async_commit();
  };
  for (int c = 0; c < kDepth - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kDepth - 2>();
    __syncthreads();
    issue(c + kDepth - 1);
    bf16_chunk(g, acc, bbuf + (c % kDepth) * kKc * ldb, ldb, lda,
               [&](int nt) { return (a_part(g, nt * 8 >= g.n) ? a1 : a0) + c * kKc; });
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The output projection of the fused route: A (AV) and B (wp) resident in shared memory for
// all of K (chunks of 16). fp32: A channel-major ([k][60]), B [k][nb].
__device__ int f32_resident(float (&acc)[8][kTileN], const float* a, const float* b, int nb, int chunks) {
  const int tid = threadIdx.x;
  const bool active = tid < f32_tiles(nb);
  const int rg = tid % kRowGroups, cg = tid / kRowGroups;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j) acc[i][j] = 0.0f;
  if (active)
    for (int c = 0; c < chunks; ++c)
      f32_chunk(acc, a + c * kKc * kPitchF + a_col(rg), b + c * kKc * nb + cg * kTileN, nb);
  return active ? tid : -1;
}

// bf16: A [64][lda] halves, B fp32 [k][nb + 4] rounded to bf16 as the fragments are built;
// warps as gemm_bf16.
__device__ void bf16_resident(float (&acc)[kMaxNTilesB][4][4], const bf16* a, int lda, const float* b,
                              int nb, int chunks) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
  const int ldb = b_pitch(true, nb);
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m)
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][mt][e] = 0.0f;
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) {
    const int nt = warp + m * kWarps;
    if (nt >= nb / 8) continue;
    for (int c = 0; c < chunks; ++c) {
      const float* bn = b + (c * kKc + 2 * t4) * ldb + nt * 8 + gq;
      const uint32_t b0 = pack_bf16(bn[0], bn[ldb]), b1 = pack_bf16(bn[8 * ldb], bn[9 * ldb]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const uint32_t* lo = reinterpret_cast<const uint32_t*>(a + (mt * 16 + gq) * lda) + c * 8;
        const uint32_t* hi = reinterpret_cast<const uint32_t*>(a + (mt * 16 + gq + 8) * lda) + c * 8;
        mma_bf16(acc[m][mt], lo[t4], hi[t4], lo[t4 + 4], hi[t4 + 4], b0, b1);
      }
    }
  }
}

// out[rows[t] + col] = acc + bp[col] for the T rows and nb columns of a projection: fp32
// stores kTileN / 4 float4 per row of a tile, bf16 rounds each sum once and stores two columns.
__device__ void store_proj_f32(const float (&acc)[8][kTileN], int tile, const int* rows, const float* bp,
                               float* out, int ntok = kT) {
  if (tile < 0) return;
  const int T = tokens(ntok);
  const int rg = tile % kRowGroups, col = tile / kRowGroups * kTileN;
  float b[kTileN];
#pragma unroll
  for (int j = 0; j < kTileN; ++j) b[j] = bp[col + j];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = rg * 8 + i;
    if (t < T) {
      float4* o = reinterpret_cast<float4*>(out + rows[t] + col);
#pragma unroll
      for (int j = 0; j < kTileN; j += 4)
        o[j / 4] = make_float4(acc[i][j] + b[j], acc[i][j + 1] + b[j + 1], acc[i][j + 2] + b[j + 2],
                               acc[i][j + 3] + b[j + 3]);
    }
  }
}

__device__ void store_proj_bf16(const float (&acc)[kMaxNTilesB][4][4], int nb, const int* rows,
                                const float* bp, bf16* out, int ntok = kT) {
  const int T = tokens(ntok);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) {
    const int nt = warp + m * kWarps;
    if (nt >= nb / 8) continue;
    const int col = nt * 8 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = mt * 16 + gq + half * 8;
        if (t < T)
          *reinterpret_cast<uint32_t*>(out + rows[t] + col) =
              pack_bf16(acc[m][mt][2 * half] + bp[col], acc[m][mt][2 * half + 1] + bp[col + 1]);
      }
  }
}

template <bool kBf16>
using Act = typename std::conditional<kBf16, bf16, float>::type;

// Row offsets (x rows: token * C) and wrap regions of window `win`'s T tokens; the padded
// rows get offset 0 and region -1. The image layout (a.windows == 0) finds a token's pixel
// through the roll; the windows layout (ops/window_pack.py::pack_windows, already rolled and
// partitioned in the block's geometry) holds token t of window win at row win * T + t. The
// region comes from the rolled-map coordinates in both.
template <typename Args>
__device__ void window_rows(const Args& a, int win, int* rows, int* region) {
  const int2 wd = window_hw(a);
  const int T = wd.x * wd.y;
  const int nw = a.W / wd.y;
  const int wr = win / nw, wc = win % nw;
  for (int t = threadIdx.x; t < kRowsB; t += kThreads) {
    if (t < T) {
      const int rr = wr * wd.x + t / wd.y, rc = wc * wd.y + t % wd.y;  // row and column in the rolled map
      rows[t] = (a.windows ? win * T + t : ((rr - a.top + a.H) % a.H) * a.W + (rc - a.left + a.W) % a.W) * a.C;
      region[t] = ((rr < a.top) << 1) | (rc < a.left);
    } else {
      rows[t] = 0;
      region[t] = -1;
    }
  }
}

// q/k/v column -> offset of its (head, dim) at token 0: q/k/v fp32 [head][token][DP] (T tokens
// a head), v in bf16 v^T [head][dp8][72].
template <int DP, bool kBf16>
__device__ void fill_col_table(int* col_ofs, int n, int d, int ntok = kT) {
  const int T = tokens(ntok);
  const int dp8 = round_up(d, 8);
  for (int col = threadIdx.x; col < 3 * n; col += kThreads) {
    const int part = (col >= n) + (col >= 2 * n), jc = col - part * n;
    const int h = jc / d, j = jc - h * d;
    col_ofs[col] = kBf16 && part == 2 ? (h * dp8 + j) * kPStride : h * T * DP + j;
  }
}

// q (scaled), k, v of token t from a q/k/v GEMM's sum for column col (+ its bias); v is
// rounded to bf16 in the bf16 form: the operand of AV.
template <int DP, bool kBf16>
__device__ __forceinline__ void store_qkv(int t, int col, float acc, int n, const int* col_ofs,
                                          const float* bqkv, float scale, float* q_s, float* k_s,
                                          unsigned char* v_s) {
  const int part = (col >= n) + (col >= 2 * n);
  const float v = acc + bqkv[col];
  const int at = col_ofs[col];
  if (part == 0) q_s[at + t * DP] = v * scale;
  else if (part == 1) k_s[at + t * DP] = v;
  else if (kBf16) reinterpret_cast<bf16*>(v_s)[at + t] = __float2bfloat16_rn(v);
  else reinterpret_cast<float*>(v_s)[at + t * DP] = v;
}

template <int DP, bool kBf16>
__device__ void store_qkv_gemm(const float (&acc)[8][kTileN], int tile, int n, const int* col_ofs,
                               const float* bqkv, float scale, float* q_s, float* k_s, unsigned char* v_s,
                               int ntok = kT) {
  if (tile < 0) return;
  const int T = tokens(ntok);
  const int rg = tile % kRowGroups, cg = tile / kRowGroups;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTileN; ++j)
      if (rg * 8 + i < T)
        store_qkv<DP, kBf16>(rg * 8 + i, cg * kTileN + j, acc[i][j], n, col_ofs, bqkv, scale, q_s, k_s, v_s);
}

template <int DP, bool kBf16>
__device__ void store_qkv_mma(const float (&acc)[kMaxNTilesB][4][4], int nb, int n, const int* col_ofs,
                              const float* bqkv, float scale, float* q_s, float* k_s, unsigned char* v_s,
                              int ntok = kT) {
  const int T = tokens(ntok);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < kMaxNTilesB; ++m) {
    const int nt = warp + m * kWarps;
    if (nt >= nb / 8) continue;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = mt * 16 + gq + (e >> 1) * 8;
        if (t < T)
          store_qkv<DP, kBf16>(t, nt * 8 + 2 * t4 + (e & 1), acc[m][mt][e], n, col_ofs, bqkv, scale,
                               q_s, k_s, v_s);
      }
  }
}

// The core: one warp per (head, 32 query rows), a query row per lane: scores against the T
// keys (four partial sums, so that the chains stay short at large d), + the bias table
// (which carries the region mask), exp of the clamped score, its sum,
// and AV: fp32 FMAs folding 1/(sum + 1e-30) in after the sum; bf16 p = rnd(e * r) into
// the warp's P rows and AV on the tensor cores. store(t, col, value): AV of token t, column
// col of the block's heads (h * d + j). kDrop (swin::AttnDrop): AV of the dropped weights, a key
// kept or not by bit u of the row's keep words (kDropWords: keep_w, [hg][T][2], hash_dropout.cuh)
// or by its hash (kDropHashed: hash, fp32 only): in fp32 the kept terms' sum times drop_scale after
// 1/(sum + 1e-30); in bf16 p = e / (sum + 1e-30) of a kept key times drop_scale, 0 else, before
// its rounding (the TPU body masks p before the cast for AV). q/k/v, the bias table and the keep
// words hold T rows a head (T = kT in the 7x7 class; at most 64, the warp's two row halves).
template <int DP, bool kBf16, int kDrop = swin::kNoDrop, typename Store>
__device__ void attention_core(const float* q_s, const float* k_s, const unsigned char* v_s, bf16* p_s,
                               const float* bias_s, int hg, int d, Store store, const uint32_t* keep_w = nullptr,
                               float drop_scale = 1.0f, const swin::AttnHash& hash = swin::AttnHash{},
                               int ntok = kT) {
  static_assert(!(kBf16 && kDrop == swin::kDropHashed), "the bf16 core reads keep words");
  const int T = tokens(ntok);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dp8 = round_up(d, 8);
  for (int item = warp; item < 2 * hg; item += kWarps) {
    const int h = item >> 1;
    const int t = (item & 1) * 32 + lane;
    const bool act = t < T;
    const int tq = act ? t : T - 1;
    float qr[DP];
#pragma unroll
    for (int j = 0; j < DP; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(q_s + (h * T + tq) * DP + j);
      qr[j] = v.x, qr[j + 1] = v.y, qr[j + 2] = v.z, qr[j + 3] = v.w;
    }
    const float* kh = k_s + h * T * DP;
    const float* brow = bias_s + tq * T;
    auto score = [&](int u) {
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
#pragma unroll
      for (int j = 0; j < DP; j += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kh + u * DP + j);
        s0 = fmaf(qr[j], kv.x, s0);
        s1 = fmaf(qr[j + 1], kv.y, s1);
        s2 = fmaf(qr[j + 2], kv.z, s2);
        s3 = fmaf(qr[j + 3], kv.w, s3);
      }
      return expf(fminf((s0 + s1) + (s2 + s3) + brow[u], kSoftmaxClamp));
    };
    if constexpr (kBf16) {
      bf16* pw = p_s + warp * 32 * kPStride;
      uint32_t* prow = reinterpret_cast<uint32_t*>(pw + lane * kPStride);
      uint32_t w0 = 0u, w1 = 0u;  // kDrop: the row's keep words
      if constexpr (kDrop) {
        w0 = keep_w[(h * T + tq) * swin::kKeepWords];
        w1 = keep_w[(h * T + tq) * swin::kKeepWords + 1];
      }
      auto weight = [&](int u, float p) {  // p = e * r, dropped or kept
        if constexpr (kDrop) return ((u < 32 ? w0 : w1) >> (u & 31)) & 1u ? p * drop_scale : 0.0f;
        else return p;
      };
      if constexpr (DP >= 24) {  // the scores twice rather than kT more registers at large d
        float sum = 0.0f;
#pragma unroll 7
        for (int u = 0; u < T; ++u) sum += score(u);
        const float r = 1.0f / (sum + 1e-30f);
#pragma unroll 2
        for (int u = 0; u < 64; u += 2) {
          const float lo = act && u < T ? weight(u, score(u) * r) : 0.0f;
          const float hi = act && u + 1 < T ? weight(u + 1, score(u + 1) * r) : 0.0f;
          prow[u / 2] = pack_bf16(lo, hi);
        }
      } else {
        float e[kT];
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < kT; ++u) {
          e[u] = 0.0f;
          if (u < T) {  // every key in the 7x7 class
            e[u] = score(u);
            sum += e[u];
          }
        }
        const float r = 1.0f / (sum + 1e-30f);
#pragma unroll
        for (int u = 0; u < 64; u += 2) {
          const float lo = act && u < T ? weight(u, e[u] * r) : 0.0f;
          const float hi = act && u + 1 < T ? weight(u + 1, e[u + 1] * r) : 0.0f;
          prow[u / 2] = pack_bf16(lo, hi);
        }
      }
      __syncwarp();
      // AV = P (32 x 64) @ v (64 x dp8) on the tensor cores
      constexpr int kNV = (DP + 7) / 8;
      const int gq = lane >> 2, t4 = lane & 3;
      const bf16* vh = reinterpret_cast<const bf16*>(v_s) + h * dp8 * kPStride;
      float o[2][kNV][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint32_t* lo = reinterpret_cast<const uint32_t*>(pw + (mt * 16 + gq) * kPStride) + ks * 8;
          const uint32_t* hi = reinterpret_cast<const uint32_t*>(pw + (mt * 16 + gq + 8) * kPStride) + ks * 8;
#pragma unroll
          for (int nt = 0; nt < kNV; ++nt) {
            if (nt * 8 >= d) continue;
            const uint32_t* bw = reinterpret_cast<const uint32_t*>(vh + (nt * 8 + gq) * kPStride) + ks * 8;
            mma_bf16(o[mt][nt], lo[t4], hi[t4], lo[t4 + 4], hi[t4 + 4], bw[t4], bw[t4 + 4]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNV; ++nt)
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2) {
            const int row = (item & 1) * 32 + mt * 16 + gq + (e2 >> 1) * 8;
            const int j = nt * 8 + 2 * t4 + (e2 & 1);
            if (row < T && j < d) store(row, h * d + j, o[mt][nt][e2]);
          }
      __syncwarp();
    } else {
      const float* vh = reinterpret_cast<const float*>(v_s) + h * T * DP;
      float acc[DP];
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[j] = 0.0f;
      float sum = 0.0f;
      uint32_t w0 = 0u, w1 = 0u, phq = 0u;  // the row's keep words, or its query's unit hash
      int sq = 0;                            // and slot
      if constexpr (kDrop == swin::kDropWords) {
        w0 = keep_w[(h * T + tq) * swin::kKeepWords];
        w1 = keep_w[(h * T + tq) * swin::kKeepWords + 1];
      } else if constexpr (kDrop == swin::kDropHashed) {
        phq = hash.ph[tq];
        sq = hash.slot[tq];
      }
#pragma unroll 7
      for (int u = 0; u < T; ++u) {
        const float e = score(u);
        sum += e;
        float ev = e;
        if constexpr (kDrop == swin::kDropWords) ev = ((u < 32 ? w0 : w1) >> (u & 31)) & 1u ? e : 0.0f;
        else if constexpr (kDrop == swin::kDropHashed) ev = swin::hashed_keep(hash, phq, sq, h, u) ? e : 0.0f;
#pragma unroll
        for (int j = 0; j < DP; j += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(vh + u * DP + j);
          acc[j] = fmaf(ev, vv.x, acc[j]);
          acc[j + 1] = fmaf(ev, vv.y, acc[j + 1]);
          acc[j + 2] = fmaf(ev, vv.z, acc[j + 2]);
          acc[j + 3] = fmaf(ev, vv.w, acc[j + 3]);
        }
      }
      const float r = 1.0f / (sum + 1e-30f);
      if (act) {
#pragma unroll
        for (int j = 0; j < DP; ++j) {
          if (j >= d) break;
          if constexpr (kDrop) store(t, h * d + j, acc[j] * r * drop_scale);
          else store(t, h * d + j, acc[j] * r);
        }
      }
    }
  }
}

// ---- helpers of the fused block's kernels (fused_block_fwd.cu, fused_block_bwd.cu) ------
constexpr float kLnEps = 1e-5f;

// A resident GEMM operand of K channels (zero up to K rounded to 16): fp32 channel-major
// [k][kPitchF] (a_col row groups), bf16 [64 rows][a_lda(K)] halves.
__host__ __device__ constexpr int a_lda(int K) { return round_up(K, kKc) + 8; }
__host__ __device__ inline int a_bytes(bool bf16, int K) {
  return bf16 ? kRowsB * a_lda(K) * 2 : round_up(K, kKc) * kPitchF * 4;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// For i in [0, n) over the block's threads, four at a time: every read of load(i) before any
// store(i, v). An element's store could alias the next one's loads, so one at a time each
// load would wait for the store before it.
template <typename Load, typename Store>
__device__ __forceinline__ void batched(int n, Load load, Store store) {
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = i0 + u * kThreads < n ? load(i0 + u * kThreads) : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * kThreads < n) store(i0 + u * kThreads, v[u]);
  }
}

// f(t, k) for every row t < rows and column k < width over the block's threads, consecutive
// threads along k; the indices advance by the block's stride, not by a division an element.
template <typename F>
__device__ __forceinline__ void each_row_col(int rows, int width, F f) {
  const int dt = kThreads / width, dk = kThreads - dt * width;
  int t = threadIdx.x / width, k = threadIdx.x - t * width;
  while (t < rows) {
    f(t, k);
    t += dt;
    k += dk;
    if (k >= width) k -= width, ++t;
  }
}

// store(t, k, load(t, k)) over the same (t, k), four elements a thread at a time: every load
// of a step before any of its stores, so that the loads' latencies overlap.
template <typename Load, typename Store>
__device__ __forceinline__ void copy_row_col(int rows, int width, Load load, Store store) {
  const int dt = kThreads / width, dk = kThreads - dt * width;
  int t = threadIdx.x / width, k = threadIdx.x - t * width;
  while (t < rows) {
    int ts[4], ks[4];
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ts[u] = t, ks[u] = k;
      v[u] = t < rows ? load(t, k) : 0.0f;
      t += dt;
      k += dk;
      if (k >= width) k -= width, ++t;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (ts[u] < rows) store(ts[u], ks[u], v[u]);
  }
}

// An operand's element (t, col) of a resident A of K channels.
template <bool kBf16>
__device__ __forceinline__ void a_put(void* a, int K, int t, int col, float v) {
  if constexpr (kBf16) reinterpret_cast<bf16*>(a)[t * a_lda(K) + col] = __float2bfloat16_rn(v);
  else reinterpret_cast<float*>(a)[col * kPitchF + a_col(t >> 3) + (t & 7)] = v;
}

// Mean and 1/sqrt(biased variance + eps) of n rows of C values (row r at row(r)) into
// st[r], as the reference computes them: the mean, then the mean square about it, in fp32.
// Eight lanes a row, the loads of a row in flight together.
template <typename RowOf>
__device__ void row_stats(int n, int C, RowOf row_of, float2* st) {
  const int lane8 = threadIdx.x & 7;
  const unsigned mask = 0xffu << (threadIdx.x & 24);  // the eight lanes of this row
  auto sum8 = [&](float v) {
    for (int off = 4; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
    return v;
  };
  for (int r = threadIdx.x / 8; r < n; r += kThreads / 8) {
    const auto* row = row_of(r);
    float s1 = 0.0f;
#pragma unroll 4
    for (int k = lane8; k < C; k += 8) s1 += to_f(row[k]);
    const float mean = sum8(s1) / C;
    float s2 = 0.0f;
#pragma unroll 4
    for (int k = lane8; k < C; k += 8) {
      const float dev = to_f(row[k]) - mean;
      s2 = fmaf(dev, dev, s2);
    }
    const float rstd = 1.0f / sqrtf(sum8(s2) / C + kLnEps);
    if (lane8 == 0) st[r] = make_float2(mean, rstd);
  }
}

__device__ __forceinline__ float layer_norm(float v, float2 st, float g, float b) {
  return (v - st.x) * st.y * g + b;
}

// LN of 49 fp32 rows (row t at src + t * ld) into a resident operand, channels from C to C
// rounded to 16 zero (rounded to bf16 in the bf16 form, as the TPU body casts LN1(x) and
// LN2(y)); st: 49 float2 of shared memory. Ends with a barrier.
template <bool kBf16>
__device__ void ln_to_a(const float* src, int ld, int C, const float* g, const float* b, void* a, float2* st) {
  row_stats(kT, C, [&](int t) { return src + static_cast<size_t>(t) * ld; }, st);
  __syncthreads();
  copy_row_col(
      kT, round_up(C, kKc),
      [&](int t, int k) { return k < C ? layer_norm(src[static_cast<size_t>(t) * ld + k], st[t], g[k], b[k]) : 0.0f; },
      [&](int t, int k, float v) { a_put<kBf16>(a, C, t, k, v); });
  __syncthreads();
}

// q (scaled), k or v of token t, column col of the block's heads, into the core's layout
// (window_fwd.cuh's store_qkv without the bias, which apply() added).
template <int DP, bool kBf16>
__device__ __forceinline__ void put_qkv(int t, int col, float v, int n, const int* col_ofs, float* q_s,
                                        float* k_s, unsigned char* v_s) {
  const int part = (col >= n) + (col >= 2 * n), at = col_ofs[col];
  if (part == 0) q_s[at + t * DP] = v;
  else if (part == 1) k_s[at + t * DP] = v;
  else if (kBf16) reinterpret_cast<bf16*>(v_s)[at + t] = __float2bfloat16_rn(v);
  else reinterpret_cast<float*>(v_s)[at + t * DP] = v;
}

__device__ void zero_smem(unsigned char* smem, int from, int to) {
  for (int i = from / 16 + threadIdx.x; i < to / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
}

// ---- K3's attention block (also the attention of K4's and K1's split route, on LN1(x)) ------
// Byte offsets of one block's dynamic shared memory. The `gemm` space holds the x and weight
// rings of the q/k/v GEMM, then (bf16) the core's P and (fused) the output projection's
// weights, which arrive by cp.async while the core runs.
struct Layout {
  int a, b, p, wp, q, k, v, av, zero_end, bias, rows, total;
};

// The attention kernel: hg heads of n = hg * d columns per q/k/v part; dp: the q/k row pitch
// (d rounded up to an instantiated pitch); fused: every head, AV kept for the projection; t: the
// any-window class's T (q/k/v rows a head and the bias table's sides; tokens()).
__host__ __device__ inline Layout attention_layout(bool bf16_io, bool fused, bool cross, int C, int inner,
                                                   int hg, int d, int dp, int t = kT) {
  const int T = tokens(t);
  Layout L{};
  const int parts = cross ? 2 : 1;
  const int ki = round_up(inner, kKc);
  const int p_bytes = bf16_io ? kWarps * 32 * kPStride * 2 : 0;
  const int wp_bytes = fused ? ki * b_pitch(bf16_io, C) * 4 : 0;
  const int ring = ring_a_bytes(bf16_io, parts, kStages) + b_bytes(bf16_io, 3 * hg * d, kStages);
  L.a = L.p = 0;
  L.b = ring_a_bytes(bf16_io, parts, kStages);
  L.wp = p_bytes;
  int off = align16(max2(ring, p_bytes + wp_bytes));
  L.q = off;  // from here to zero_end the kernel zero-fills at its start
  off += align16(hg * T * dp * 4);
  L.k = off;
  off += align16(hg * T * dp * 4);
  L.v = off;
  off += align16(bf16_io ? hg * round_up(d, 8) * kPStride * 2 : hg * T * dp * 4);
  L.av = off;  // fused: AV, fp32 [k][kPitchF] or bf16 [64][ki + 8]
  if (fused) off += align16(bf16_io ? kRowsB * (ki + 8) * 2 : ki * kPitchF * 4);
  L.zero_end = L.bias = off;
  off += align16(T * T * 4);
  L.rows = off;
  off += align16((2 * kRowsB + 3 * kColTable) * 4);  // rows, regions, columns, q/k/v and out biases
  L.total = off;
  return L;
}

struct Args {
  const void* x;
  const float *wq, *bq, *wk, *bk, *wv, *bv, *wp, *bp, *bias;
  void* out;
  void* av;  // split: AV scratch (S*B, windows, T, inner) in x's type
  int S, B, H, W, C, inner, heads, d, hg, top, left, cross;
  float scale;
  int windows;  // the token layout: 0 image (K3's and K4's), 1 windows (K1's)
  // kDrop: the attention site, and where the keep words of every (image, window, head) go,
  // (S*B, windows, heads, T, 2), for the dropout backward's recompute (nullptr: not stored,
  // the forward's dropout form)
  swin::DropSite drop;
  uint32_t* keep;
  int wh, ww, t;  // the any-window class's window and its tokens (window_hw(), tokens())
};

// Bytes a kDrop attention block adds after attention_layout's: the tokens' unit hashes and
// slots, and (words: the kDropWords core's) the keep words of its hg heads (T rows each).
__host__ __device__ inline int drop_attention_bytes(int hg, bool words = true, int t = kT) {
  return align16(2 * kRowsB * 4) + (words ? align16(hg * tokens(t) * swin::kKeepWords * 4) : 0);
}

// One block per (window, stream * batch, group of hg heads): q/k/v of the group's heads from
// x and the weights streamed through rings, the bias with the region mask folded in,
// scores, softmax and AV. Split: AV to the window-major scratch for the projection kernel.
// kFused (every head in the block): wp arrives by cp.async while the core runs, and the
// block projects AV from shared memory and stores the output: the whole forward in one
// launch.
// kDrop (swin::AttnDrop, both routes): the block hashes its tokens into shared memory after the
// layout's end and runs the core on the dropped weights, before AV (and, fused, before the
// projection); kDropWords (the bf16 forward's dropout form, and the dropout backward's
// recompute, which sets a.keep on the split block) hashes the keep words of its heads there too
// and writes them to a.keep where it is set, for the backward's blocks; kDropHashed (the fp32
// forward's) hashes each weight's bit in the core.
template <int DP, bool kBf16, bool kFused, int kDrop = swin::kNoDrop>
__global__ void __launch_bounds__(kThreads, kBf16 && DP >= 24 ? 1 : 2) k3_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  using IO = Act<kBf16>;  // x and out
  const int T = tokens(a.t);
  const int2 wd = window_hw(a);
  const Layout L = attention_layout(kBf16, kFused, a.cross != 0, a.C, a.inner, a.hg, a.d, DP, T);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int win = blockIdx.x, nb = blockIdx.y, grp = blockIdx.z;
  const int s = nb / a.B, b = nb % a.B;
  const int kvs = a.cross ? a.S - 1 - s : s;
  const int nwin = (a.H / wd.x) * (a.W / wd.y);
  const size_t map = static_cast<size_t>(a.H) * a.W * a.C;
  const int n = a.hg * a.d, c0 = grp * n;
  const int ki = round_up(a.inner, kKc);

  int* rows = reinterpret_cast<int*>(smem + L.rows);
  int* region = rows + kRowsB;
  int* col_ofs = region + kRowsB;
  float* bqkv_s = reinterpret_cast<float*>(col_ofs + kColTable);  // q/k/v biases of the group
  float* bp_s = bqkv_s + kColTable;                                 // output biases (fused)
  float* bias_s = reinterpret_cast<float*>(smem + L.bias);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  window_rows(a, win, rows, region);
  fill_col_table<DP, kBf16>(col_ofs, n, a.d, T);
  // the relative-position bias and the biases, one cp.async group that the q/k/v GEMM
  // waits for with its own
  for (int i = tid; i < T * T; i += kThreads) cp_async4(bias_s + i, a.bias + s * T * T + i, true);
  for (int col = tid; col < 3 * n; col += kThreads) {
    const int part = (col >= n) + (col >= 2 * n);
    const float* bsrc = part == 0 ? a.bq : part == 1 ? a.bk : a.bv;
    cp_async4(bqkv_s + col, bsrc + s * a.inner + c0 + col - part * n, true);
  }
  if (kFused)
    for (int col = tid; col < a.C; col += kThreads) cp_async4(bp_s + col, a.bp + s * a.C + col, true);
  cp_async_commit();
  for (int i = L.q / 16 + tid; i < L.zero_end / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  uint32_t* keep_s = reinterpret_cast<uint32_t*>(smem + L.total + align16(2 * kRowsB * 4));
  uint32_t* ph = reinterpret_cast<uint32_t*>(smem + L.total);
  int* slot = reinterpret_cast<int*>(ph + kRowsB);
  if constexpr (kDrop) {  // the tokens' unit hashes (the rows are in place); kDropWords the group's keep words
    for (int t = tid; t < T; t += kThreads) ph[t] = swin::token_hash(a.drop, nb, rows[t] / a.C, &slot[t]);
    __syncthreads();
    if constexpr (kDrop == swin::kDropWords)
      swin::attention_keep_words(a.drop, ph, slot, grp * a.hg, a.hg, a.heads, keep_s, T);
  }

  const IO* x = static_cast<const IO*>(a.x);
  Gemm g{};
  g.abase[0] = x + static_cast<size_t>(s * a.B + b) * map;
  g.abase[1] = x + static_cast<size_t>(kvs * a.B + b) * map;
  g.aparts = a.cross ? 2 : 1;
  g.rows = rows;
  const size_t wofs = static_cast<size_t>(s) * a.C * a.inner + c0;
  g.w[0] = a.wq + wofs;
  g.w[1] = a.wk + wofs;
  g.w[2] = a.wv + wofs;
  g.n = n;
  g.ldw = a.inner;
  g.nb = 3 * n;
  g.K = a.C;
  g.t = T;
  if constexpr (kBf16) {
    float acc[kMaxNTilesB][4][4];
    gemm_bf16<kStages>(g, reinterpret_cast<bf16*>(smem + L.a), reinterpret_cast<float*>(smem + L.b), acc);
    store_qkv_mma<DP, kBf16>(acc, g.nb, n, col_ofs, bqkv_s, a.scale, q_s, k_s, smem + L.v, T);
  } else {
    float acc[8][kTileN];
    const int tile = gemm_f32<kStages>(g, reinterpret_cast<float*>(smem + L.a),
                                       reinterpret_cast<float*>(smem + L.b), acc);
    store_qkv_gemm<DP, kBf16>(acc, tile, n, col_ofs, bqkv_s, a.scale, q_s, k_s, smem + L.v, T);
  }
  // the region mask folded into the bias: -inf between regions, whose exp is exactly 0 as
  // exp(-1e10) is (the scores are finite)
  for (int i = tid; i < T * T; i += kThreads)
    if (region[i / T] != region[i % T]) bias_s[i] = -__int_as_float(0x7f800000);
  const float* wp = a.wp + static_cast<size_t>(s) * a.inner * a.C;
  float* wp_s = reinterpret_cast<float*>(smem + L.wp);  // fused: [ki][C (+ 4 in bf16)]
  if (kFused) {  // the rings are free: wp streams in under the core
    const int ldp = b_pitch(kBf16, a.C);
    for (int k = warp; k < ki; k += kWarps)
      for (int col = 4 * lane; col < a.C; col += 128)
        cp_async16(wp_s + k * ldp + col, k < a.inner ? wp + static_cast<size_t>(k) * a.C + col : wp,
                   k < a.inner);
    cp_async_commit();
  }
  __syncthreads();

  const swin::AttnHash hash{a.drop, ph, slot, grp * a.hg, a.heads};  // kDropHashed's keys
  if constexpr (kFused) {
    IO* out = static_cast<IO*>(a.out) + static_cast<size_t>(s * a.B + b) * map;
    if constexpr (kBf16) {
      bf16* av = reinterpret_cast<bf16*>(smem + L.av);
      attention_core<DP, kBf16, kDrop>(
          q_s, k_s, smem + L.v, reinterpret_cast<bf16*>(smem + L.p), bias_s, a.hg, a.d,
          [&](int t, int col, float v) { av[t * (ki + 8) + col] = __float2bfloat16_rn(v); }, keep_s, a.drop.scale,
          hash, T);
      cp_async_wait<0>();
      __syncthreads();
      float acc[kMaxNTilesB][4][4];
      bf16_resident(acc, av, ki + 8, wp_s, a.C, ki / kKc);
      store_proj_bf16(acc, a.C, rows, bp_s, out, T);
    } else {
      float* av = reinterpret_cast<float*>(smem + L.av);
      attention_core<DP, kBf16, kDrop>(
          q_s, k_s, smem + L.v, nullptr, bias_s, a.hg, a.d,
          [&](int t, int col, float v) { av[col * kPitchF + a_col(t >> 3) + (t & 7)] = v; }, keep_s, a.drop.scale,
          hash, T);
      cp_async_wait<0>();
      __syncthreads();
      float acc[8][kTileN];
      const int tile = f32_resident(acc, av, wp_s, a.C, ki / kKc);
      store_proj_f32(acc, tile, rows, bp_s, out, T);
    }
  } else if constexpr (kDrop) {
    if (kDrop == swin::kDropWords && a.keep != nullptr) {
      const int words = a.hg * T * swin::kKeepWords;
      uint32_t* keep =
          a.keep + ((static_cast<size_t>(nb) * nwin + win) * a.heads + grp * a.hg) * T * swin::kKeepWords;
      for (int i = tid; i < words; i += kThreads) keep[i] = keep_s[i];
    }
    IO* av = static_cast<IO*>(a.av) + (static_cast<size_t>(nb) * nwin + win) * T * a.inner + c0;
    attention_core<DP, kBf16, kDrop>(
        q_s, k_s, smem + L.v, reinterpret_cast<bf16*>(smem + L.p), bias_s, a.hg, a.d,
        [&](int t, int col, float v) { av[static_cast<size_t>(t) * a.inner + col] = from_float<IO>(v); },
        keep_s, a.drop.scale, hash, T);
  } else {
    IO* av = static_cast<IO*>(a.av) + (static_cast<size_t>(nb) * nwin + win) * T * a.inner + c0;
    attention_core<DP, kBf16>(q_s, k_s, smem + L.v, reinterpret_cast<bf16*>(smem + L.p), bias_s, a.hg, a.d,
                              [&](int t, int col, float v) {
                                av[static_cast<size_t>(t) * a.inner + col] = from_float<IO>(v);
                              },
                              nullptr, 1.0f, swin::AttnHash{}, T);
  }
}

}  // namespace wfwd
