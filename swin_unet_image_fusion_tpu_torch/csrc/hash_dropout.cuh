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

}  // namespace swin
