"""K4's and K1's dropout backward at the split route's geometry against the JAX package's
custom VJPs.

The dropout form of the split route (``csrc/fused_block_bwd_split.cu``) takes K1 bwd and K4 bwd
with dropout at stages 2-3 of the default model (at stage 2: C = 96, 8 heads of d = 12, MLP
hidden 384); on the CPU the port's ``BasicBlock.fused`` with a seed runs the plain dropout
backward that the kernels reproduce (``tests/test_torch_kernel_gpu.py`` holds them against it
on the card, ``tests/test_torch_block_bwd_drop.py`` holds the routes' decomposition against
it). Here that backward is held against ``jax.vjp`` of the interpret-mode
``pallas_fused_block`` (the image, K4) and ``pallas_packed_block_strips`` (window-packed tokens,
K1) with every site at rate 0.1 and the kernel's seed pinned, at that geometry, a 14x14 map and
one image per stream, without shift and cross and with both: the input gradient and every
weight gradient by flax name, at rtol/atol 2e-4 as ``test_torch_block_bwd_parity.py`` holds the
same geometry without dropout. ``tests/test_torch_dropout.py`` covers C = 24. Inputs and weights
are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from test_torch_dropout import _set_block_rates, pinned_seed
from test_torch_fused_block import _block_case
from test_torch_grad import ATOL, RTOL, WINDOW, _assert_param_grads, _cotangent, _jax_grads

RATE = 0.1
SEED = 5_242_883  # < 2^24
CASES = {f"c96-shift{int(s)}-cross{int(s)}": (96, 8, 12, 384, 14, 14, s, s) for s in (False, True)}


def _one_image(case, seed):
    x, kw, variables, port = _block_case(case, seed=seed)
    _set_block_rates(port, (RATE, RATE, RATE))
    return np.ascontiguousarray(x[:, :1]), kw, variables, port


def _jax_block(kw, impl, **extra):
    block = JaxBlock(**kw, attention_drop_ratio=RATE, proj_drop_ratio=RATE, mlp_drop_ratio=RATE, impl=impl,
                     **extra)
    return lambda v, x: block.apply(v, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})


def _launches():
    return tfb.BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES


def test_the_geometry_takes_the_split_routes_dropout_form():
    for cross in (False, True):
        assert tfb.block_bwd_plan(96, 8, 12, 384, WINDOW, cross, True).route == "split"


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_k4_dropout_grads_match_jax_pallas_block_at_the_split_geometry(case):
    """K4's dropout backward: ``BasicBlock.fused`` on the image against ``pallas_block``."""
    x, kw, variables, port = _one_image(case, seed=51)
    g = _cotangent(x.shape, 52)
    with pinned_seed(jpb, "pallas_fused_block", SEED) as calls:
        ref_x, ref_params = _jax_grads(jax.jit(_jax_block(kw, "pallas_block_interpret")), variables, x, g)
    assert calls == [SEED]
    launches = _launches()
    xt = torch.from_numpy(x).requires_grad_()
    port.fused(xt, "image", seed=SEED).backward(torch.from_numpy(g))
    assert _launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_k1_dropout_grads_match_jax_pallas_pack_at_the_split_geometry(case):
    """K1's dropout backward: pack -> ``fused`` on window-packed tokens -> unpack against
    ``pallas_pack`` on C-major input."""
    x, kw, variables, port = _one_image(case, seed=53)
    shift, hw = kw["shift"], x.shape[2:4]
    g = _cotangent(x.shape, 54)
    packed = _jax_block(kw, "pallas_pack_interpret", packed=True)
    cmajor = jax.jit(lambda v, a: jnp.moveaxis(packed(v, jnp.moveaxis(a, -1, 2)), 2, -1))
    with pinned_seed(jpp, "pallas_packed_block_strips", SEED) as calls:
        ref_x, ref_params = _jax_grads(cmajor, variables, x, g)
    assert calls == [SEED]
    launches = _launches()
    xt = torch.from_numpy(x).requires_grad_()
    xw = twp.pack_windows(xt, WINDOW, shift)
    twp.unpack_windows(port.fused(xw, "windows", hw, seed=SEED), hw, WINDOW, shift).backward(torch.from_numpy(g))
    assert _launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)
