// Counter-based dropout masks in the kernels, for Hopper (sm_90a): the device half of
// swin_unet_image_fusion_tpu_torch/ops/hash_dropout.py, which is the port's copy of the
// JAX package's ops/hash_dropout.py (finalize l.49, pair_hash l.65, keep_from_hash l.75).
//
// A keep decision is a pure function of (seed, site, global unit, intra-unit offset):
//   base  = fmix32(seed + site * 0x9E3779B9)    per (seed, site), computed on the host
//   ph    = fmix32(unit ^ base)                   per unit (a window, or a window pair)
//   keep  = (fmix32(ph + intra) & (2^23 - 1)) < threshold
// on wrapping 32-bit integers with logical shifts: the JAX kernels' int32 arithmetic,
// bit for bit. A kept element is multiplied by scale = float32(1 / (1 - rate)), a dropped
// one is 0. The hash is integer ALU work, ~11 operations per element.
//
// Every token of one image has a row (unit, slot) in `table`, in the order of the
// kernel's layout (ops/dropout_layout.py builds it for each TPU kernel's geometry); the
// global unit of a token of image b of stream s is (s * B + b) * units + unit.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace swin {

constexpr int kKeepBits = 23;
constexpr int kPackLanes = 128;  // the packed kernel's lanes: two windows of 64 slots
constexpr int kPackTok = 64;
enum Site { kSiteAttn, kSiteProj, kSiteHidden, kSiteOut, kNumSites };
enum AttnMode { kAttnSlots, kAttnWin64, kAttnHeadBatched };

// The host's arguments (ops/dropout_layout.py::DropArgs; ctypes lays it out the same).
struct DropArgs {
  const int* table;  // (tokens per image, 2): unit within the image, slot
  int units;         // units per image
  int pairs;         // 1: window pairs of the packed kernel (token offsets c * 128 + lane)
  int attn_mode;     // AttnMode
  int t_pad;         // K3/K4's padded window length
  int on[kNumSites];
  uint32_t base[kNumSites];
  uint32_t threshold[kNumSites];
  float scale[kNumSites];
};

// One site of one launch, passed to a kernel by value.
struct DropSite {
  const int2* table;
  int hw;  // tokens per image
  int units;
  int B;
  int pairs;
  int attn_mode;
  int t_pad;
  uint32_t base;
  uint32_t threshold;
  float scale;
};

inline bool drop_on(const DropArgs* a, int site) { return a != nullptr && a->on[site] != 0; }

inline DropSite drop_site(const DropArgs* a, int site, int hw, int B) {
  DropSite d;
  d.table = reinterpret_cast<const int2*>(a->table);
  d.hw = hw;
  d.units = a->units;
  d.B = B;
  d.pairs = a->pairs;
  d.attn_mode = a->attn_mode;
  d.t_pad = a->t_pad;
  d.base = a->base[site];
  d.threshold = a->threshold[site];
  d.scale = a->scale[site];
  return d;
}

__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ bool hash_keep(uint32_t ph, uint32_t intra, uint32_t threshold) {
  return (fmix32(ph + intra) & ((1u << kKeepBits) - 1u)) < threshold;
}

// The unit hash and the slot of token `tok` of image n = s * B + b.
__device__ __forceinline__ uint32_t token_hash(const DropSite& d, int n, int tok, int* slot) {
  const int2 e = d.table[tok];
  *slot = e.y;
  return fmix32((static_cast<uint32_t>(n) * static_cast<uint32_t>(d.units) +
                 static_cast<uint32_t>(e.x)) ^ d.base);
}

// The intra-unit offset of column c of a token site `cols` wide, at the token's slot.
__device__ __forceinline__ uint32_t token_intra(const DropSite& d, int slot, int c, int cols) {
  return d.pairs ? static_cast<uint32_t>(c * kPackLanes + slot)
                 : static_cast<uint32_t>(slot * cols + c);
}

// The intra-unit offset of the attention weight of query slot sq and key slot sk, head h.
__device__ __forceinline__ uint32_t attn_intra(const DropSite& d, int h, int sq, int sk,
                                               int heads) {
  if (d.attn_mode == kAttnWin64)
    return static_cast<uint32_t>((h * kPackTok + (sk & (kPackTok - 1))) * kPackLanes + sq);
  if (d.attn_mode == kAttnHeadBatched)
    return static_cast<uint32_t>((sq * heads + h) * kPackLanes + sk);
  return static_cast<uint32_t>((h * d.t_pad + sq) * d.t_pad + sk);
}

// ---- the masks of the redesigned backward (fused_block_bwd.cu, fused_block_bwd_split.cu) ----
// A dropout call's four sites for kernels that mask every site alike: a site of rate 0 is the
// identity (threshold 2^23 keeps every element, and it is multiplied by exactly 1).
struct BlockDrop {
  DropSite site[kNumSites];
};

inline BlockDrop block_drop(const DropArgs* a, int hw, int B) {
  BlockDrop b{};
  for (int i = 0; i < kNumSites; ++i) {
    b.site[i] = drop_site(a, i, hw, B);
    if (!drop_on(a, i)) {
      b.site[i].base = 0u;
      b.site[i].threshold = 1u << kKeepBits;
      b.site[i].scale = 1.0f;
    }
  }
  return b;
}

// x kept (times scale) or dropped (0).
__device__ __forceinline__ float masked(bool keep, float x, float scale) { return keep ? x * scale : 0.0f; }

// The keep bit of column c of a token site `cols` wide, at the token's unit hash and slot.
__device__ __forceinline__ bool token_keep(const DropSite& d, uint32_t ph, int slot, int c, int cols) {
  return hash_keep(ph, token_intra(d, slot, c, cols), d.threshold);
}

constexpr int kKeepT = 49;      // tokens of the 7x7 windows that K1 and K4 take
constexpr int kKeepWords = 2;   // keep words of one (head, query row): keys 0-31, then 32-63
constexpr int kKeepIlp = 4;     // words a warp hashes at once

// The attention keep bits of one window of T <= 64 tokens (K1's and K4's 49; K3's any): bit
// u % 32 of words[(h * T + t) * 2 + u / 32] keeps the weight of query t and key u of head h0 + h,
// for hg heads; ph: the tokens' unit hashes at the attention site (the query's unit keys the
// pair), slot: their slots. A warp per word and a lane per key (__ballot_sync), over the
// block's warps, kKeepIlp words at a time: the hash is a chain of dependent integer operations,
// and independent chains hide each other's latency. Every thread of the block calls it.
__device__ __forceinline__ void attention_keep_words(const DropSite& d, const uint32_t* ph, const int* slot,
                                                     int h0, int hg, int heads, uint32_t* words,
                                                     int T = kKeepT) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const int n = hg * T * kKeepWords;
  for (int w0 = warp * kKeepIlp; w0 < n; w0 += warps * kKeepIlp) {
    bool keep[kKeepIlp];
#pragma unroll
    for (int i = 0; i < kKeepIlp; ++i) {
      const int w = w0 + i, ht = w / kKeepWords, u = (w % kKeepWords) * 32 + lane;
      const int h = ht / T, t = ht - h * T;
      // hashed unconditionally (slot has 64 entries), so that the chains carry no branch
      const bool k = hash_keep(ph[t], attn_intra(d, h0 + h, slot[t], slot[u], heads), d.threshold);
      keep[i] = k && w < n && u < T;
    }
#pragma unroll
    for (int i = 0; i < kKeepIlp; ++i) {
      const unsigned bits = __ballot_sync(0xffffffffu, keep[i]);
      if (lane == 0 && w0 + i < n) words[w0 + i] = bits;
    }
  }
}

// Key u's bit of a (head, query row)'s keep words.
__device__ __forceinline__ bool word_keep(const uint32_t* w, int u) { return (w[u >> 5] >> (u & 31)) & 1u; }

// Where an attention core finds a weight's keep bit (its kDrop): nowhere (no dropout), in keep
// words hashed once a window and head (attention_keep_words; the backward's blocks read them
// again), or hashed where the core uses it, from the query token's unit hash and the tokens'
// slots. The fp32 forward core takes the last: it hides the hash among a key's FMAs (K1's and
// K4's fp32 dropout forward 33.2 / 33.8 ms per 224² batch-20 step with keep words, 31.4 / 31.8
// hashed, split_ab.py --dropout on an H100); the bf16 core, whose P rows take few instructions a
// key, the words (K4 bf16's 28.9 ms with words, 29.7 hashed).
enum AttnDrop { kNoDrop = 0, kDropWords = 1, kDropHashed = 2 };

// The per-element keys of kDropHashed: the site, the tokens' unit hashes at it and their slots
// (64 each, the window's tokens), the first head of the block's group and the heads of a window.
struct AttnHash {
  DropSite site;
  const uint32_t* ph;
  const int* slot;
  int h0, heads;
};

// The keep bit of the weight of query slot sq (unit hash phq) and key u, head h of the group.
__device__ __forceinline__ bool hashed_keep(const AttnHash& k, uint32_t phq, int sq, int h, int u) {
  return hash_keep(phq, attn_intra(k.site, k.h0 + h, sq, k.slot[u], k.heads), k.site.threshold);
}

}  // namespace swin
