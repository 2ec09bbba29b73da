"""The port's kernel routes in bfloat16 through the whole tiny model, against the JAX
model's matching Pallas route in interpret mode, also in bfloat16.

On the CPU each kernel wrapper runs its plain version, so this holds the bf16 rounding
points of K3 (``cuda`` against ``pallas_interpret``), K4 (``cuda_block`` against
``pallas_block_interpret``) and K1 with K2 (``cuda_pack`` against
``pallas_pack_interpret``) inside the model. The JAX packed route runs its packed stages'
merge and unmerge on strips (``PackedPatchMergeLayer`` sums four per-block products in
bf16), where the port follows ``PatchMergeLayer``: the port matches the jnp route's merge
rounding there. Rounding flips amplify through the stages, so the criteria are the
image-level ones of ``testing.py`` (``BF16_VS_BF16``: mean |diff| <= 1e-2 and PSNR >= 30
dB against the bf16 route; ``BF16_VS_FP32``: SSIM > 0.98 and PSNR > 30 dB against the
fp32 jnp forward), never a largest difference. One interpret forward takes about half a minute here, so each route runs at
56x56 only. Run as a script, the file prints the spread that sets the criteria: each
port route and each JAX route against the JAX jnp forward in bf16 and in fp32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu_torch import ModelConfig, SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_from_jax
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import assert_bf16_fidelity, image_fidelity

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
HW = (56, 56)


ROUTES = [("cuda", "pallas_interpret"), ("cuda_block", "pallas_block_interpret"),
          ("cuda_pack", "pallas_pack_interpret")]


def _case():
    flat = random_variables(ModelConfig(**TINY), seed=3)
    rng = np.random.default_rng(4)
    return flat, rng.random((2, *HW, 1), dtype=np.float32), rng.random((2, *HW, 1), dtype=np.float32)


def _jax(case, impl, dtype):
    flat, ir, vis = case
    model = JaxUNet(jcfg.ModelConfig(**TINY, attention_impl=impl, compute_dtype=dtype))
    return np.asarray(jax.jit(model.apply)(unflatten_dict(flat, sep="/"), jnp.asarray(ir),
                                           jnp.asarray(vis)))


def _port(case, impl):
    flat, ir, vis = case
    model = SwinFusionUNet(ModelConfig(**TINY, attention_impl=impl, compute_dtype="bfloat16"))
    model.load_state_dict(variables_from_jax(flat))
    with torch.no_grad():
        return model.eval()(torch.from_numpy(ir), torch.from_numpy(vis))


@pytest.fixture(scope="module")
def case():
    case = _case()
    return case, _jax(case, "jnp", "float32")


@pytest.mark.parametrize("impl,jax_impl", ROUTES)
def test_tiny_bf16_kernel_route_matches_jax_interpret(case, impl, jax_impl):
    case, ref32 = case
    counts = [(m.LAUNCHES, m.BF16_LAUNCHES) for m in (twa, tfb, twp)]
    out = _port(case, impl)
    assert counts == [(m.LAUNCHES, m.BF16_LAUNCHES) for m in (twa, tfb, twp)], \
        "CPU tensors run the plain versions, which never count"
    assert out.dtype == torch.float32 and out.shape == (2, *HW, 1)
    ref16 = _jax(case, jax_impl, "bfloat16")
    assert_bf16_fidelity(out, ref16, "bfloat16", f"{impl} vs {jax_impl} bf16")
    assert_bf16_fidelity(out, ref32, "float32", f"{impl} bf16 vs jnp fp32")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    case = _case()
    refs = {dtype: _jax(case, "jnp", dtype) for dtype in ("bfloat16", "float32")}
    outputs = {f"port {impl}": _port(case, impl) for impl in ("torch", *(r[0] for r in ROUTES))}
    outputs.update({f"JAX {jax_impl}": _jax(case, jax_impl, "bfloat16") for _, jax_impl in ROUTES})
    for name, out in outputs.items():
        for dtype, ref in refs.items():
            f = image_fidelity(out, ref)
            print(f"{name} bf16 vs JAX jnp {dtype}: mean_abs {f.mean_abs:.3e}, PSNR {f.psnr:.2f} dB, "
                  f"SSIM {f.ssim:.5f}, {f.interior:.1%} of the reference inside (0, 1)")
