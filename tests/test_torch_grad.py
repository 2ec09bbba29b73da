"""Gradients of the port's kernel modules against the JAX package's custom VJPs.

On the CPU each kernel wrapper runs its plain version under autograd, so these tests
hold the backward that the CUDA kernels must reproduce (the card tests in
``test_torch_kernel_gpu.py`` hold the kernels against it) against ``jax.vjp`` of the
TPU kernels in interpret mode: the fused block on the image (K4 bwd,
``pallas_block_interpret``) and on window-packed tokens (K1 bwd,
``pallas_pack_interpret``), window attention (K3 bwd, ``pallas_interpret``), and the
re-partition (K2 bwd, ``repartition_packed_pallas``, bit-exact). The input and every
weight gradient are compared by flax name through ``variables_to_jax``, at rtol/atol
2e-4, the JAX package's own kernel-gradient tolerance (``test_pallas_pack.py``). Weights
and inputs are made with numpy from a seed. The gradient comparison of the card checks
(``testing.assert_grads_close``) is tested here too: the gradients it calls exactly 0 are
0 up to rounding, and it fails a zeroed gradient. About 115 s in one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_to_jax
from swin_unet_image_fusion_tpu_torch.models.layers import BatchNorm
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close, exact_zero
from test_torch_attention import _case as attention_case
from test_torch_attention import JaxAttention
from test_torch_fused_block import CASES, _block_case
from test_torch_window_pack import _decode_strips

ATOL = RTOL = 2e-4
WINDOW = (7, 7)
ATTENTION_CASES = {f"c24-shift{int(s)}-cross{int(c)}": (s, c) for s in (False, True) for c in (False, True)}


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_grads(apply, variables, x, g):
    """(d x, flat d params) of ``apply(variables, x)`` for the output cotangent g."""
    _, vjp = jax.vjp(apply, variables, jnp.asarray(x))
    d_vars, d_x = vjp(jnp.asarray(g))
    return np.asarray(d_x), {k: np.asarray(v) for k, v in flatten_dict(d_vars, sep="/").items()}


def _bwd_launches():
    return tfb.BWD_LAUNCHES, twa.BWD_LAUNCHES, twp.BWD_LAUNCHES


def _assert_param_grads(module, ref):
    got = variables_to_jax({n: p.grad for n, p in module.named_parameters()})
    assert set(got) == set(ref)
    for name, value in ref.items():
        np.testing.assert_allclose(got[name], value, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_cuda_block_grads_match_jax_pallas_block(case):
    """K4's backward: ``BasicBlock.fused`` on the image against ``pallas_block``."""
    x, kw, variables, port = _block_case(case, seed=11)
    g = _cotangent(x.shape, 12)
    ref_x, ref_params = _jax_grads(jax.jit(JaxBlock(**kw, impl="pallas_block_interpret").apply),
                                   variables, x, g)
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    port.fused(xt, "image").backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_cuda_pack_grads_match_jax_pallas_pack(case):
    """K1's backward: pack -> ``fused`` on window-packed tokens -> unpack against
    ``pallas_pack`` on C-major input."""
    x, kw, variables, port = _block_case(case, seed=13)
    shift = kw["shift"]
    hw = x.shape[2:4]
    g = _cotangent(x.shape, 14)
    packed = jax.jit(JaxBlock(**kw, impl="pallas_pack_interpret", packed=True).apply)
    ref_x, ref_params = _jax_grads(packed, variables, np.moveaxis(x, -1, 2), np.moveaxis(g, -1, 2))
    xt = torch.from_numpy(x).requires_grad_()
    xw = twp.pack_windows(xt, WINDOW, shift)
    twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, shift).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.moveaxis(ref_x, 2, -1), atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("shift,cross", ATTENTION_CASES.values(), ids=ATTENTION_CASES.keys())
def test_attention_grads_match_jax_pallas_attention(shift, cross):
    """K3's backward: ``DualWindowAttention`` under ``cuda`` against ``pallas_window_attention``."""
    x, kw, variables, port = attention_case((24, 8, 3, 14, 21), shift, cross, seed=15)
    g = _cotangent(x.shape, 16)
    ref_x, ref_params = _jax_grads(JaxAttention(**kw, impl="pallas_interpret").apply, variables, x, g)
    launches = _bwd_launches()
    xt = torch.from_numpy(x).requires_grad_()
    port(xt, "cuda").backward(torch.from_numpy(g))
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("to_shift", [True, False])
def test_repartition_grad_equals_jax_pallas_kernel(to_shift):
    """K2's backward: the inverse permutation, bit-exact against the transposed taps of
    ``repartition_packed_pallas`` at a wrap-mode geometry."""
    hw = (14, 28)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 2, *hw, 8)).astype(np.float32)
    g = rng.standard_normal((2, 2, *hw, 8)).astype(np.float32)
    xp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(jnp.asarray(x), -1, 2), WINDOW, shift=not to_shift)
    gp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(jnp.asarray(g), -1, 2), WINDOW, shift=to_shift)
    _, vjp = jax.vjp(lambda a: jpp.repartition_packed_pallas(a, WINDOW, hw, not to_shift, to_shift,
                                                              interpret=True), xp)
    (ref,) = vjp(gp)
    src = twp.pack_windows(torch.from_numpy(x), WINDOW, not to_shift).requires_grad_()
    out = twp.repartition_windows(src, hw, WINDOW, not to_shift, to_shift)
    out.backward(twp.pack_windows(torch.from_numpy(g), WINDOW, to_shift))
    np.testing.assert_array_equal(src.grad.numpy(), _decode_strips(ref))
    plain = twp.repartition_windows_bwd_plain(twp.pack_windows(torch.from_numpy(g), WINDOW, to_shift),
                                              hw, WINDOW, not to_shift, to_shift)
    assert torch.equal(plain, src.grad)


def test_gradients_called_exactly_zero_are_rounding_noise():
    """The key bias (a constant added to every key leaves the softmax unchanged while no
    score reaches its clamp) and the bias of a conv followed by training-mode BatchNorm (it
    subtracts the batch mean) get gradients at the level of fp32 rounding; the others do
    not."""
    c = 24
    shapes = ((2, 2, 14, 14, c), (2, c, c), (2, c), (2, c, c), (2, c), (2, c, c), (2, c),
              (2, c, c), (2, c), (2, 49, 49))
    scales = (1.0, c**-0.5, 0.1, c**-0.5, 0.1, c**-0.5, 0.1, c**-0.5, 0.1, 1.0)  # scores below the clamp
    args = [torch.from_numpy(_cotangent(shape, 18 + i) * f) for i, (shape, f) in enumerate(zip(shapes, scales))]
    kw = dict(window=WINDOW, num_heads=8, dims_per_head=3, shift=True, cross=True)
    grads = twa.window_attention_bwd_plain(torch.from_numpy(_cotangent(shapes[0], 17)), *args, **kw)
    names = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
    largest = max(float(t.abs().max()) for t in grads)
    for name, grad in zip(names, grads):
        assert (float(grad.abs().max()) < 1e-6 * largest) == exact_zero(name), name

    bn = BatchNorm(2)
    x = torch.from_numpy(_cotangent((3, 2, 5, 4), 20))
    conv_bias = torch.tensor([0.3, -0.2], requires_grad=True)
    bn(x + conv_bias[:, None, None], train=True).mul(torch.from_numpy(_cotangent(x.shape, 21))).sum().backward()
    largest = float(bn.bias.grad.abs().max())
    assert exact_zero("params/final_head/conv1/bias") and not exact_zero("params/final_head/conv2/bias")
    assert float(conv_bias.grad.abs().max()) < 1e-6 * largest


def test_grad_check_fails_a_zeroed_or_wrong_gradient():
    """Each gradient is held to its own largest magnitude (floored at 1e-8 of the call's):
    a small gradient set to 0 or off by 1% fails even beside a large one; an exactly-zero
    gradient passes at the call's scale."""
    big, small, tiny = torch.full((4,), 10.0), torch.linspace(1e-6, 2e-6, 4), torch.full((3,), 1e-10)
    names = ("w1", "b1", "bk")
    check = assert_grads_close([big, small, -tiny], [big, small, tiny], names, "ok")
    assert check.zeros == ("bk",) and check.smallest == pytest.approx(2e-7) and check.floored == 0
    for wrong in (torch.zeros_like(small), small * 1.01):
        with pytest.raises(AssertionError, match="b1"):
            assert_grads_close([big, wrong, tiny], [big, small, tiny], names, "wrong")
