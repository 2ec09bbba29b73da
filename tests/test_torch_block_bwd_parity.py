"""K4's and K1's backward at the split route's geometry against the JAX package's custom VJPs.

The split route of ``csrc/fused_block_bwd.cu`` takes K1 bwd and K4 bwd at stages 2-3 of the
default model (at stage 2: C = 96, 8 heads of d = 12, MLP hidden 384); on the CPU the port's
``BasicBlock.fused`` runs the plain backward that the kernels reproduce
(``tests/test_torch_kernel_gpu.py`` holds them against it on the card,
``tests/test_torch_block_bwd_split.py`` holds the route's decomposition against it). Here that
backward is held against ``jax.vjp`` of the interpret-mode ``pallas_fused_block`` (the image,
K4) and ``pallas_packed_block_strips`` (window-packed tokens, K1) at that geometry, a 14x14
map and one image per stream, every shift x cross case: the input gradient and every weight
gradient by flax name, at rtol/atol 2e-4 as ``test_torch_grad.py`` holds its C = 24 cases.
Inputs and weights are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from test_torch_fused_block import _block_case
from test_torch_grad import ATOL, RTOL, WINDOW, _assert_param_grads, _bwd_launches, _cotangent, _jax_grads

CASES = {f"c96-shift{int(s)}-cross{int(c)}": (96, 8, 12, 384, 14, 14, s, c) for s in (False, True)
         for c in (False, True)}


def _one_image(case, seed):
    x, kw, variables, port = _block_case(case, seed=seed)
    return np.ascontiguousarray(x[:, :1]), kw, variables, port


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_k4_grads_match_jax_pallas_block_at_the_split_geometry(case):
    """K4's backward: ``BasicBlock.fused`` on the image against ``pallas_block``."""
    x, kw, variables, port = _one_image(case, seed=41)
    g = _cotangent(x.shape, 42)
    ref_x, ref_params = _jax_grads(jax.jit(JaxBlock(**kw, impl="pallas_block_interpret").apply),
                                   variables, x, g)
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    port.fused(xt, "image").backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_k1_grads_match_jax_pallas_pack_at_the_split_geometry(case):
    """K1's backward: pack -> ``fused`` on window-packed tokens -> unpack against
    ``pallas_pack`` on C-major input."""
    x, kw, variables, port = _one_image(case, seed=43)
    shift = kw["shift"]
    hw = x.shape[2:4]
    g = _cotangent(x.shape, 44)
    packed = jax.jit(JaxBlock(**kw, impl="pallas_pack_interpret", packed=True).apply)
    ref_x, ref_params = _jax_grads(packed, variables, np.moveaxis(x, -1, 2), np.moveaxis(g, -1, 2))
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    xw = twp.pack_windows(xt, WINDOW, shift)
    twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, shift).backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(ref_x, 2, -1), atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)
