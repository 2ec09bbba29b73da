// The fused block's MLP activation (K1 and K4), a runtime code that every route's arguments
// carry (ops/fused_block.py::ACTIVATIONS and activation_code), so that no route instantiates a
// kernel per activation (a warp-uniform branch in an epilogue):
//   kActElu   ELU, expm1 below 0 (the default model's);
//   kActRelu  max(z, 0);
//   kActGelu  GELU in the tanh form, z 0.5 (1 + tanh(sqrt(2/pi) (z + 0.044715 z^3))), as
//             jax.nn.gelu computes it in the TPU kernels' forward bodies (pallas_block.py:174-182,
//             pallas_pack.py:668-676); tanhf and erff, never their approximate instructions: the
//             fp32 forms hold 1e-4 against the plain version;
//   kActPre   the backward's recompute of a GELU call only: the hidden kept as z = fc1 + b1.
// The backward follows the TPU kernels' _act_and_grad (pallas_block.py:194-208,
// pallas_pack.py:725-737). ELU' and ReLU' are functions of the hidden h (1 where h > 0, else
// h + 1 or 0), so the recompute stores h and the MLP backward reads the derivative from it;
// GELU' is not, so the recompute stores z, and the MLP backward takes g_pre = g_h (Phi(z) +
// z phi(z)) and overwrites z with the erf hidden z Phi(z), which w2's gradient reads: the
// reference's backward recomputes the hidden in the erf form, its forward in the tanh form.

#pragma once

#include <cuda_runtime.h>

namespace swin {

enum Activation : int { kActElu = 0, kActRelu = 1, kActGelu = 2, kActPre = 3 };

__host__ __device__ inline bool activation_ok(int act) { return act >= kActElu && act <= kActGelu; }

// The code the backward's recompute stores the hidden with: h for ELU and ReLU, z for GELU.
__host__ __device__ inline int recompute_code(int act) { return act == kActGelu ? kActPre : act; }

__device__ __forceinline__ float activate(int act, float z) {
  if (act == kActElu) return z > 0.0f ? z : expm1f(z);
  if (act == kActRelu) return fmaxf(z, 0.0f);
  if (act == kActGelu) return z * (0.5f * (1.0f + tanhf(0.7978845608f * (z + 0.044715f * (z * z * z)))));
  return z;
}

// f(fn) with fn the activation `act` as a functor of z, the branch on `act` taken once a call
// and not once an element: under ELU fn is ELU's own code, so the default model's epilogue
// compiles to what it was before the code was runtime (call it around a whole epilogue loop).
template <typename F>
__device__ __forceinline__ void with_activation(int act, F&& f) {
  if (act == kActElu)
    f([](float z) { return z > 0.0f ? z : expm1f(z); });
  else
    f([act](float z) { return activate(act, z); });
}

// act'(z) from what the recompute stored, `hv` (h, or z under GELU); under GELU `hv` becomes
// the erf hidden z Phi(z).
__device__ __forceinline__ float act_grad(int act, float& hv) {
  if (act == kActElu) return hv > 0.0f ? 1.0f : hv + 1.0f;
  if (act == kActRelu) return hv > 0.0f ? 1.0f : 0.0f;
  const float z = hv;
  const float cdf = 0.5f * (1.0f + erff(z * 0.70710678118654752f));
  const float pdf = expf(-0.5f * z * z) * 0.3989422804014327f;
  hv = z * cdf;
  return cdf + z * pdf;
}

}  // namespace swin
