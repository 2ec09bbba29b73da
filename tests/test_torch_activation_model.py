"""The port's tiny model under the relu and gelu MLPs against the JAX package's model, and the
port's GELU against ``jax.nn.gelu``.

``jax.nn.gelu`` is the tanh form; the port's ``activation_fn("gelu")`` computes the same form,
which reaches every MLP, merge, anti-merge and the head. The composition (``cuda``) is held,
forward and every parameter gradient, against the JAX jnp model (autodiff of the tanh form);
the kernel routes (``cuda_pack``, ``cuda_block``) against the JAX model on
``pallas_pack_interpret`` and ``pallas_block_interpret``, whose block kernels take the erf form
in their backward (``tests/test_torch_activation_block.py`` says how that is told apart). The
forward at atol 2e-4, rtol 1e-3 and the gradients at atol 5e-4, rtol 1e-3, the tolerances of
the JAX package's tiny and full-model parity (``tests/test_model_parity.py:59, 68``); the bf16
composition under gelu against the JAX bf16 jnp model by ``testing.assert_bf16_fidelity``, as
``tests/test_torch_bf16_model.py`` holds the bf16 routes. Weights and inputs are made with
numpy from a seed. About 5 minutes in one process, most of it the JAX interpret models.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu_torch import ModelConfig, SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_from_jax, variables_to_jax
from swin_unet_image_fusion_tpu_torch.models.layers import activation_fn
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import assert_bf16_fidelity
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
HW = (28, 28)
FWD_ATOL, FWD_RTOL = 2e-4, 1e-3
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
ROUTES = [("cuda", "jnp"), ("cuda_pack", "pallas_pack_interpret"), ("cuda_block", "pallas_block_interpret")]


@functools.lru_cache(maxsize=None)
def _case(activation):
    flat = random_variables(ModelConfig(**TINY, mlp_activation=activation), seed=40)
    rng = np.random.default_rng(41)
    ir, vis = (rng.random((2, *HW, 1), dtype=np.float32) for _ in range(2))
    cot = rng.standard_normal((2, *HW, 1)).astype(np.float32)
    return flat, ir, vis, cot


def _jax_model(activation, impl, dtype="float32"):
    return JaxUNet(jcfg.ModelConfig(**TINY, mlp_activation=activation, attention_impl=impl, compute_dtype=dtype))


def _port_model(activation, impl, flat, dtype="float32"):
    model = SwinFusionUNet(ModelConfig(**TINY, mlp_activation=activation, attention_impl=impl, compute_dtype=dtype))
    model.load_state_dict(variables_from_jax(flat))
    return model.eval()


def _value_and_vjp(jax_model):
    def run(variables, ir, vis, cot):
        out, vjp = jax.vjp(lambda v: jax_model.apply(v, ir, vis), variables)
        return out, vjp(cot)[0]
    return run


def _counts():
    return [(m.LAUNCHES, m.BWD_LAUNCHES) for m in (twa, tfb, twp)]


def test_gelu_is_jax_nn_gelus_tanh_form():
    """The port's GELU within 1e-6 of ``jax.nn.gelu`` over [-6, 6] in fp32, and away from the
    erf form there (which would miss by up to 4.7e-4)."""
    x = np.linspace(-6.0, 6.0, 120_001, dtype=np.float32)
    got = activation_fn("gelu")(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert np.abs(got - ref).max() <= 1e-6
    erf = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    assert np.abs(got - erf).max() > 4e-4


@pytest.mark.parametrize("impl,jax_impl", ROUTES)
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_tiny_model_matches_jax(activation, impl, jax_impl):
    """The tiny model's forward and every parameter gradient (of the output against a fixed
    cotangent, BatchNorm on its running statistics) under ``impl`` against the JAX model under
    ``jax_impl``."""
    flat, ir, vis, cot = _case(activation)
    jax_model = _jax_model(activation, jax_impl)
    variables = unflatten_dict(flat, sep="/")
    ref, d_vars = jax.jit(_value_and_vjp(jax_model))(variables, jnp.asarray(ir), jnp.asarray(vis),
                                                      jnp.asarray(cot))
    ref_grads = {k: np.asarray(v) for k, v in flatten_dict(d_vars, sep="/").items() if k.startswith("params/")}

    model = _port_model(activation, impl, flat)
    counts = _counts()
    out = model(torch.from_numpy(ir), torch.from_numpy(vis))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=FWD_RTOL)
    out.backward(torch.from_numpy(cot))
    assert _counts() == counts, "CPU tensors run the plain versions, which never count"
    got = variables_to_jax({n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(ref_grads)
    for name, value in ref_grads.items():
        np.testing.assert_allclose(got[name], value, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_bf16_gelu_composition_matches_jax_bf16():
    """The bf16 composition under gelu (``F.gelu``'s tanh form, computed in fp32 and rounded
    once, where ``jax.nn.gelu`` rounds each operation in bf16) against the JAX bf16 jnp model
    and the fp32 one, by the bf16 routes' image criteria."""
    flat = random_variables(ModelConfig(**TINY, mlp_activation="gelu"), seed=3)
    rng = np.random.default_rng(4)
    ir, vis = (rng.random((2, 56, 56, 1), dtype=np.float32) for _ in range(2))
    model = _port_model("gelu", "cuda", flat, "bfloat16")
    with torch.no_grad():
        out = model(torch.from_numpy(ir), torch.from_numpy(vis))
    variables = unflatten_dict(flat, sep="/")
    for dtype in ("bfloat16", "float32"):
        ref = jax.jit(_jax_model("gelu", "jnp", dtype).apply)(variables, jnp.asarray(ir), jnp.asarray(vis))
        assert_bf16_fidelity(out, np.asarray(ref), dtype, f"cuda bf16 gelu vs jnp {dtype}")
