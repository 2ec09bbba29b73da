"""K3's backward at a head-group geometry against the JAX package's custom VJP.

The split route of ``csrc/window_attention_bwd.cu`` takes a window's heads in groups (at the
default model's stage 2, four heads of d = 12 a block); on the CPU the port's
``DualWindowAttention`` under ``cuda`` runs the plain backward that the kernels reproduce
(``tests/test_torch_kernel_gpu.py`` holds them against it on the card). Here that backward is
held against ``jax.vjp`` of the interpret-mode ``pallas_window_attention`` at C = 96, 8 heads
of d = 12, a 14x14 map and one image per stream, every shift x cross case: the input gradient
and every weight gradient by flax name, at rtol/atol 2e-4 as ``test_torch_grad.py`` holds its
C = 24 case. Inputs and weights are made with numpy from a seed."""

import numpy as np
import pytest
import torch

from test_torch_attention import JaxAttention
from test_torch_attention import _case as attention_case
from test_torch_grad import ATOL, ATTENTION_CASES, RTOL, _assert_param_grads, _bwd_launches, _cotangent, _jax_grads

GEOMETRY = (96, 8, 12, 14, 14)  # C, heads, d, H, W


@pytest.mark.parametrize("shift,cross", ATTENTION_CASES.values(), ids=[k.replace("c24", "c96") for k in ATTENTION_CASES])
def test_attention_grads_match_jax_pallas_attention_at_a_head_group_geometry(shift, cross):
    x, kw, variables, port = attention_case(GEOMETRY, shift, cross, seed=31)
    x = np.ascontiguousarray(x[:, :1])  # one image per stream
    g = _cotangent(x.shape, 32)
    ref_x, ref_params = _jax_grads(JaxAttention(**kw, impl="pallas_interpret").apply, variables, x, g)
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    port(xt, "cuda").backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)
