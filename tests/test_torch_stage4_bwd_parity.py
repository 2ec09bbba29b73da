"""K4's, K1's and K3's backward at the default model's stage 4 (C = 384, 8 heads of d = 48)
against the JAX package's custom VJPs.

At stage 4 K1 bwd and K4 bwd run the split route of ``csrc/fused_block_bwd_split.cu`` at a q/k
row pitch of 48, and K3 bwd its split route with the tiled core of ``csrc/window_bwd.cuh``
(``core_bwd_tiled``); on the CPU the port's ``BasicBlock.fused`` and ``DualWindowAttention``
under ``cuda`` run the plain backward that those kernels reproduce
(``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py`` hold them against it on the card,
``tests/test_torch_stage4_core.py`` holds the core's order against it). Here that backward is
held against ``jax.vjp`` of the interpret-mode ``pallas_fused_block`` (the image, K4),
``pallas_packed_block_strips`` (window-packed tokens, K1) and ``pallas_window_attention`` (K3)
at that geometry, the encoder's and the decoder's MLP width (1536 and 768), a 14x14 map and one
image per stream, every shift x cross case: the input gradient and every weight gradient by
flax name, at rtol/atol 2e-4 as ``test_torch_block_bwd_parity.py`` holds its C = 96 cases.
Inputs and weights are made with numpy from a seed."""

import numpy as np
import pytest
import torch

import jax

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from test_torch_attention import JaxAttention
from test_torch_attention import _case as attention_case
from test_torch_block_bwd_parity import _one_image
from test_torch_grad import (ATOL, ATTENTION_CASES, RTOL, WINDOW, _assert_param_grads, _bwd_launches, _cotangent,
                             _jax_grads)

CASES = {f"c384-h{hidden}-shift{int(s)}-cross{int(c)}": (384, 8, 48, hidden, 14, 14, s, c)
         for hidden in (1536, 768) for s in (False, True) for c in (False, True)}
GEOMETRY = (384, 8, 48, 14, 14)  # C, heads, d, H, W


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_k4_grads_match_jax_pallas_block_at_stage_4(case):
    """K4's backward: ``BasicBlock.fused`` on the image against ``pallas_block``."""
    x, kw, variables, port = _one_image(case, seed=51)
    g = _cotangent(x.shape, 52)
    ref_x, ref_params = _jax_grads(jax.jit(JaxBlock(**kw, impl="pallas_block_interpret").apply),
                                   variables, x, g)
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    port.fused(xt, "image").backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_k1_grads_match_jax_pallas_pack_at_stage_4(case):
    """K1's backward: pack -> ``fused`` on window-packed tokens -> unpack against
    ``pallas_pack`` on C-major input."""
    x, kw, variables, port = _one_image(case, seed=53)
    shift = kw["shift"]
    hw = x.shape[2:4]
    g = _cotangent(x.shape, 54)
    packed = jax.jit(JaxBlock(**kw, impl="pallas_pack_interpret", packed=True).apply)
    ref_x, ref_params = _jax_grads(packed, variables, np.moveaxis(x, -1, 2), np.moveaxis(g, -1, 2))
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    xw = twp.pack_windows(xt, WINDOW, shift)
    twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, shift).backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(ref_x, 2, -1), atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("shift,cross", ATTENTION_CASES.values(),
                         ids=[k.replace("c24", "c384") for k in ATTENTION_CASES])
def test_k3_grads_match_jax_pallas_attention_at_stage_4(shift, cross):
    """K3's backward: ``DualWindowAttention`` under ``cuda`` against ``pallas_window_attention``
    at C = 384, d = 48."""
    x, kw, variables, port = attention_case(GEOMETRY, shift, cross, seed=55)
    x = np.ascontiguousarray(x[:, :1])  # one image per stream
    g = _cotangent(x.shape, 56)
    ref_x, ref_params = _jax_grads(JaxAttention(**kw, impl="pallas_interpret").apply, variables, x, g)
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    port(xt, "cuda").backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)
