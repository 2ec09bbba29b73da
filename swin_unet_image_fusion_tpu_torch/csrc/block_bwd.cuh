// The host-side pieces and device helpers that both routes of K1's and K4's backward without
// dropout share: fused_block_bwd.cu (the fused route, stages 0-1 of the default model) and
// fused_block_bwd_split.cu (the split route, stages 2-3). The argument slots, the transposed
// weights' launch, and the tail of both routes: every weight's gradient from the stored
// operands in one wgrad_rows_kernel launch and one fixed-order reduction of every partial.

#pragma once

#include "window_bwd.cuh"
#include "window_core_bwd.cuh"

namespace bbwd {

using namespace wbwd;

constexpr int kBlocksPerSm = 2;  // the block kernels' register bound (128 a thread)
constexpr int kRing = 2;         // weight-ring slots (two or three chunks a product)

// Element i of an activation in device memory, fp32 or bf16, as fp32.
__device__ __forceinline__ float act(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const wfwd::bf16*>(p)[i]) : static_cast<const float*>(p)[i];
}

// Argument slots, in the forward's order (ops/fused_block.py), then g.
enum In { kX, kLn1g, kLn1b, kWq, kBq, kWk, kBk, kWv, kBv, kWp, kBp, kBias, kLn2g, kLn2b, kW1, kB1, kW2, kB2, kG };

// The weight-gradient jobs of stream s, in order: wq, wk, wv (A = LN1 of the rows each read),
// wp (A = AV), w1 (A = LN2(y)), w2 (A = the hidden; B = g): (ka, nb) of each.
constexpr int kWgPerStream = 6;
inline void wg_shape(int job, int C, int inner, int hidden, int* ka, int* nb) {
  const int shapes[kWgPerStream][2] = {{C, inner}, {C, inner}, {C, inner}, {inner, C}, {C, hidden}, {hidden, C}};
  *ka = shapes[job][0];
  *nb = shapes[job][1];
}

// The transposed weights of either route, (wq|wk|wv)^T, wp^T, w1^T and w2^T of every stream
// (one launch), so that every input-gradient product streams its weights through a ring.
inline void launch_transposes(const float* const* in, float* wqkvT, float* wpT, float* w1T, float* w2T, int S,
                              int C, int inner, int hidden, cudaStream_t st) {
  Transposes tr = {};
  int jobs = 0, most = 0;
  auto add = [&](const float* src, float* dst, int rows, int cols) {
    tr.src[jobs] = src, tr.dst[jobs] = dst, tr.rows[jobs] = rows, tr.cols[jobs] = cols;
    most = max2(most, rows * cols);
    ++jobs;
  };
  for (int s = 0; s < S; ++s) {
    const size_t ci = static_cast<size_t>(s) * C * inner, ch = static_cast<size_t>(s) * C * hidden;
    float* qkv = wqkvT + 3 * ci;
    add(in[kWq] + ci, qkv, C, inner);
    add(in[kWk] + ci, qkv + static_cast<size_t>(inner) * C, C, inner);
    add(in[kWv] + ci, qkv + 2 * static_cast<size_t>(inner) * C, C, inner);
    add(in[kWp] + ci, wpT + ci, inner, C);
    add(in[kW1] + ch, w1T + ch, C, hidden);
    add(in[kW2] + ch, w2T + ch, hidden, C);
  }
  transpose_kernel<<<dim3(std::min((most + kThreads - 1) / kThreads, 64), jobs), kThreads, 0, st>>>(tr);
}

// What the last launches of either route read: the stored operands and gradients of every
// token, and the partial sums with their chunk counts.
// The dropout form passes g_proj = drop(g_y) as gy (wp's gradient), the dropped hidden as h and
// g_m = drop(g) as gm (w2's gradient; nullptr: g itself).
struct Tail {
  const float *gy, *lnx, *o, *lny, *h, *gpre, *gq, *gk, *gv;
  const float *tab_part, *ln2_part, *ln1_part;
  float* wg_part;
  int chunk_rows, chunks, tab_chunks, ln2_chunks, ln1_chunks;
  const float* gm;
};

// The last launches of either route: every weight's gradient [A | 1]^T B from the stored
// operands in one wgrad_rows_kernel launch (wq, wk, wv: A = LN1 of the rows each read; wp: A =
// AV; w1: A = LN2(y); w2: A = the hidden, B = g); one reduction of every partial.
template <typename TX>
int launch_tail(const float* const* in, float* const* out, const Tail& t, int S, int M, int C, int inner,
                int hidden, bool cross, cudaStream_t st) {
  constexpr bool kBf16 = std::is_same<TX, bf16>::value;
  // weight gradients from the stored operands, one launch; then every partial sum
  WgJobs wg = {};
  wg.rows = M;
  wg.chunk_rows = t.chunk_rows;
  swin::ReduceJobs red = {};
  bool ok = true;
  const int grads[kWgPerStream][2] = {{kWq, kBq}, {kWk, kBk}, {kWv, kBv}, {kWp, kBp}, {kW1, kB1}, {kW2, kB2}};
  float* part = t.wg_part;
  int tile_groups = 1, wg_bytes = 0;
  for (int s = 0; s < S; ++s) {
    const size_t tok = static_cast<size_t>(s) * M, s_kv = cross ? static_cast<size_t>(S - 1 - s) * M : tok;
    const float* a_of[kWgPerStream] = {t.lnx + tok * C, t.lnx + s_kv * C, t.lnx + s_kv * C,
                                       t.o + tok * inner, t.lny + tok * C, t.h + tok * hidden};
    const void* g_b = t.gm ? static_cast<const void*>(t.gm + tok * C)
                           : static_cast<const TX*>(static_cast<const void*>(in[kG])) + tok * C;
    const void* b_of[kWgPerStream] = {t.gq + tok * inner, t.gk + tok * inner, t.gv + tok * inner,
                                      t.gy + tok * C, t.gpre + tok * hidden, g_b};
    for (int job = 0; job < kWgPerStream; ++job) {
      int ka, nb;
      wg_shape(job, C, inner, hidden, &ka, &nb);
      wg.job[wg.count++] = {a_of[job], b_of[job], part, ka, nb, job == kWgPerStream - 1 && kBf16 && !t.gm};
      tile_groups = max2(tile_groups, wg_groups_of_tiles(ka, nb));
      wg_bytes = max2(wg_bytes, wg_smem(ka, nb));
      ok &= red.add(part, t.chunks, (ka + 1) * nb, ka * nb, out[grads[job][0]] + static_cast<size_t>(s) * ka * nb,
                    out[grads[job][1]] + static_cast<size_t>(s) * nb);
      part += static_cast<size_t>(t.chunks) * (ka + 1) * nb;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(wgrad_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wg_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_rows_kernel<<<dim3(t.chunks, wg.count, tile_groups), kThreads, wg_bytes, st>>>(wg);

  for (int s = 0; s < S; ++s) {
    ok &= red.add(t.tab_part + static_cast<size_t>(s) * t.tab_chunks * kT * kT, t.tab_chunks, kT * kT, kT * kT,
                  out[kBias] + static_cast<size_t>(s) * kT * kT, nullptr);
    ok &= red.add(t.ln2_part + static_cast<size_t>(s) * t.ln2_chunks * 2 * C, t.ln2_chunks, 2 * C, C,
                  out[kLn2g] + static_cast<size_t>(s) * C, out[kLn2b] + static_cast<size_t>(s) * C);
    ok &= red.add(t.ln1_part + static_cast<size_t>(s) * t.ln1_chunks * 2 * C, t.ln1_chunks, 2 * C, C,
                  out[kLn1g] + static_cast<size_t>(s) * C, out[kLn1b] + static_cast<size_t>(s) * C);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  swin::launch_reduce(red, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bbwd
