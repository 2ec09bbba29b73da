"""The port's fused Swin block (K1 and K4's plain version) under the relu and gelu MLPs against
the JAX package's block kernels in interpret mode, forward and backward.

On the CPU the fused block's wrapper runs its plain version, which the CUDA kernels reproduce
(``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py`` hold them against it on the card).
The JAX kernels have two gelu forms: their forward bodies compute ``jax.nn.gelu`` (the tanh
form), their backward bodies' ``_act_and_grad`` (``pallas_block.py:194-208``,
``pallas_pack.py:725-737``) recompute the hidden and its derivative in the erf form, so w2's
gradient reads the erf hidden and g_pre is g_h (Phi(z) + z phi(z)). The kernel routes follow
them; the composition (``cuda``, ``BasicBlock``'s ``DualMLP``) follows autodiff of the tanh
form, as the JAX jnp block does. relu's derivative is (z > 0) in both; it jumps at z = 0, so
two fp32 orders of summation disagree on a unit whose z is within rounding of 0, and the
gradient through the attention then differs in its whole wrap region. The relu gradient cases
check that every pre-activation of their inputs is at least ``RELU_MARGIN`` from 0 (the
port's and JAX's z differ by about 1e-6).

Forward on both layouts at ``BLOCK_ATOL``/``BLOCK_RTOL`` (``test_torch_fused_block.py``'s);
the input gradient and every weight gradient against ``jax.vjp`` of the interpret kernels at
rtol/atol 2e-4 (``test_torch_grad.py``'s), at stage 0's geometry (C = 24, 8 heads of 3), the
split route's (C = 96, 8 heads of 12) and with dropout at every site. Inputs and weights are
made with numpy from a seed. About 2.5 minutes in one process.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables_like, variables_from_jax
from swin_unet_image_fusion_tpu_torch.models.layers import BasicBlock
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from test_torch_block_bwd_plan import _block_args, fake_library  # noqa: F401 (a fixture)
from test_torch_dropout import _jax_vjp, _set_block_rates, pinned_seed
from test_torch_fused_block import BLOCK_ATOL, BLOCK_RTOL
from test_torch_grad import ATOL, RTOL, WINDOW, _assert_param_grads, _cotangent, _jax_grads
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ACTIVATIONS = ("relu", "gelu")
# (C, heads, d, MLP hidden, H, W, shift, cross): stage 0's geometry (the one-launch forward
# and the fused backward on the card) and stage 2's (the split routes)
CASES = {"c24-shift1-cross1": (24, 8, 3, 96, 14, 21, True, True),
         "c96-shift1-cross0": (96, 8, 12, 384, 14, 14, True, False)}
RELU_MARGIN = 1e-5
RATE = 0.1
SEED = 3_141_593  # < 2^24


@functools.lru_cache(maxsize=None)
def _weights(case, seed):
    c, heads, d, hidden, h, w, shift, cross = case
    kw = dict(streams=2, dims=c, num_heads=heads, dims_per_head=d, window_size=WINDOW,
              shift=shift, cross=cross, mlp_hidden_dims=hidden)
    abstract = jax.eval_shape(JaxBlock(**kw).init, jax.random.PRNGKey(0), jnp.zeros((2, 1, h, w, c)))
    return kw, random_variables_like({k: v.shape for k, v in flatten_dict(abstract, sep="/").items()}, seed)


def _case(case, activation, seed, images=2):
    """x, the JAX block's keywords, its variables and the port's block, under ``activation``."""
    c, heads, d, hidden, h, w, shift, cross = case
    x = np.random.default_rng(seed).standard_normal((2, images, h, w, c)).astype(np.float32)
    kw, flat = _weights(case, seed + 1)
    port = BasicBlock(2, c, heads, d, WINDOW, shift, cross, hidden, activation)
    port.load_state_dict(variables_from_jax(flat))
    return x, dict(kw, activation=activation), unflatten_dict(flat, sep="/"), port


def _packed(kw, **extra):
    """The JAX packed block (K1) on channel-last input."""
    block = JaxBlock(**kw, impl="pallas_pack_interpret", packed=True, **extra)

    def apply(v, a, **call):
        return jnp.moveaxis(block.apply(v, jnp.moveaxis(a, -1, 2), **call), 2, -1)
    return apply


def _port_windows(port, xt, kw, **call):
    hw = xt.shape[2:4]
    xw = twp.pack_windows(xt, WINDOW, kw["shift"])
    return twp.unpack_windows(port.fused(xw, "windows", hw, **call), hw, WINDOW, kw["shift"])


def _relu_margin(monkeypatch, port, x, **call):
    """The smallest |z| of the block's MLP pre-activations on ``x`` (the plain version's)."""
    seen = []
    mlp_out = tfb._mlp_out

    def spy(z, *args):
        seen.append(z.detach().abs().min().item())
        return mlp_out(z, *args)
    monkeypatch.setattr(tfb, "_mlp_out", spy)
    with torch.no_grad():
        port.fused(torch.from_numpy(x), "image", **call)
    monkeypatch.undo()
    return min(seen)


def _launches():
    return (tfb.LAUNCHES, tfb.BWD_LAUNCHES, tfb.DROP_LAUNCHES, tfb.DROP_BWD_LAUNCHES)


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_forward_matches_jax_interpret_kernel(case, activation, layout):
    """The block's forward under ``activation``: the image layout against ``pallas_block``
    (K4), the windows layout against ``pallas_pack`` (K1)."""
    x, kw, variables, port = _case(case, activation, seed=20)
    if layout == "image":
        ref = jax.jit(JaxBlock(**kw, impl="pallas_block_interpret").apply)(variables, jnp.asarray(x))
    else:
        ref = jax.jit(_packed(kw))(variables, jnp.asarray(x))
    launches = _launches()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        out = port.fused(xt, "image") if layout == "image" else _port_windows(port, xt, kw)
    assert _launches() == launches, "the plain version must not count as a kernel launch"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_grads_match_jax_interpret_kernel(case, activation, layout, monkeypatch):
    """K4's (image) and K1's (windows) backward under ``activation``: the input gradient and
    every weight gradient against ``jax.vjp`` of the interpret kernel, through the fp32 call
    that autograd records (the plain version's own backward)."""
    x, kw, variables, port = _case(case, activation, seed=30)
    if activation == "relu":
        assert _relu_margin(monkeypatch, port, x) > RELU_MARGIN
    g = _cotangent(x.shape, 31)
    apply = JaxBlock(**kw, impl="pallas_block_interpret").apply if layout == "image" else _packed(kw)
    ref_x, ref_params = _jax_grads(jax.jit(apply), variables, x, g)
    launches = _launches()
    xt = torch.from_numpy(x).requires_grad_()
    out = port.fused(xt, "image") if layout == "image" else _port_windows(port, xt, kw)
    out.backward(torch.from_numpy(g))
    assert _launches() == launches, "the plain backward must not count as a kernel launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_dropout_grads_match_jax_interpret_kernel(activation, layout, monkeypatch):
    """The dropout form under ``activation`` at the split geometry, every site at rate 0.1
    with the kernel's seed pinned: forward, input gradient and every weight gradient. The
    hidden's mask is applied after the activation in both gelu forms."""
    x, kw, variables, port = _case(CASES["c96-shift1-cross0"], activation, seed=24, images=1)
    _set_block_rates(port, (RATE, RATE, RATE))
    if activation == "relu":
        assert _relu_margin(monkeypatch, port, x, seed=SEED) > RELU_MARGIN
    g = _cotangent(x.shape, 25)
    rates = dict(attention_drop_ratio=RATE, proj_drop_ratio=RATE, mlp_drop_ratio=RATE)
    call = dict(deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})
    if layout == "image":
        block = JaxBlock(**kw, impl="pallas_block_interpret", **rates)
        apply, entry = (lambda v, a: block.apply(v, a, **call)), (jpb, "pallas_fused_block")
    else:
        packed = _packed(kw, **rates)
        apply, entry = (lambda v, a: packed(v, a, **call)), (jpp, "pallas_packed_block_strips")
    with pinned_seed(*entry, SEED) as calls:
        ref_out, ref_x, ref_params = _jax_vjp(jax.jit(apply), variables, x, g)
    assert calls == [SEED]
    xt = torch.from_numpy(x).requires_grad_()
    if layout == "image":
        out = port.fused(xt, "image", seed=SEED)
    else:
        out = _port_windows(port, xt, kw, seed=SEED)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)


def test_the_geometries_take_both_kernel_routes():
    """Stage 0's geometry takes the one-launch forward and the fused backward, stage 2's the
    split routes: the cases above hold the plain version of every route the card runs."""
    for case, fwd, bwd in ((CASES["c24-shift1-cross1"], "fused", "fused"),
                           (CASES["c96-shift1-cross0"], "split", "split")):
        c, heads, d, hidden, _, _, _, cross = case
        assert tfb.block_fwd_plan(c, heads, d, hidden, WINDOW, cross, False).route == fwd
        assert tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross).route == bwd


def test_gelu_kernel_and_composition_forms_are_told_apart():
    """A swapped gelu form fails these comparisons: the JAX kernel's gradients (erf backward)
    and the JAX jnp block's (autodiff of the tanh form) differ beyond rtol/atol 2e-4 at the
    split geometry, and the port's kernel route matches the first while its composition
    (``cuda``) matches the second. Had the port's plain kernel backward taken autodiff of the
    tanh form, or its composition the erf form, one of the two would fail."""
    x, kw, variables, port = _case(CASES["c96-shift1-cross0"], "gelu", seed=26, images=1)
    g = _cotangent(x.shape, 27)
    kernel_x, kernel_params = _jax_grads(jax.jit(JaxBlock(**kw, impl="pallas_block_interpret").apply),
                                         variables, x, g)
    jnp_x, jnp_params = _jax_grads(jax.jit(JaxBlock(**kw, impl="jnp").apply), variables, x, g)
    apart = [name for name in kernel_params
             if not np.allclose(kernel_params[name], jnp_params[name], atol=ATOL, rtol=RTOL)]
    assert "params/mlp/fc2/kernel" in apart and len(apart) >= 10, apart
    assert not np.allclose(kernel_x, jnp_x, atol=ATOL, rtol=RTOL)
    for impl, (ref_x, ref_params) in (("cuda_block", (kernel_x, kernel_params)), ("cuda", (jnp_x, jnp_params))):
        port.zero_grad()
        xt = torch.from_numpy(x).requires_grad_()
        port(xt, impl).backward(torch.from_numpy(g))
        np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL, err_msg=impl)
        _assert_param_grads(port, ref_params)


def test_wrapper_rejects_an_unknown_activation():
    x, _, _, port = _case(CASES["c24-shift1-cross1"], "gelu", seed=28)
    port.activation = "silu"
    with pytest.raises(ValueError, match="unknown activation 'silu'"):
        port.fused(torch.from_numpy(x), "image")
    assert [tfb.activation_code(a) for a in tfb.ACTIVATIONS] == [0, 1, 2]


@pytest.mark.parametrize("activation", ["elu", *ACTIVATIONS])
@pytest.mark.parametrize("route,c,d,hidden", [("fused", 24, 3, 96), ("split", 96, 12, 384), ("five", 128, 16, 512)])
def test_every_route_gets_the_activation_code(fake_library, activation, route, c, d, hidden):
    """On a card every forward and backward launcher of each route takes the call's activation
    code as its last integer before the stream (0 ELU, 1 ReLU, 2 GELU), a call under relu or
    gelu counts once in its activation's counter beside its dtype's, and none runs the plain
    version (the fake library returns without computing)."""
    code = tfb.activation_code(activation)
    assert tfb.block_bwd_plan(c, 8, d, hidden, WINDOW, True).route == route
    x, weights = _block_args(c, 8, d, hidden)
    kw = dict(window=WINDOW, num_heads=8, dims_per_head=d, shift=True, cross=True, layout="image", hw=(14, 14),
              activation=activation)
    fwd, bwd = dict(tfb.ACTIVATION_LAUNCHES), dict(tfb.ACTIVATION_BWD_LAUNCHES)
    if route != "five":  # the five route's shape (d = 16) has no forward beside the five launches
        tfb._launch_fwd(x, weights, kw)
    tfb._launch_five(x, weights, kw)
    tfb._launch_bwd(torch.zeros_like(x), x, weights, kw)
    launcher = {"fused": "swin_block_bwd", "split": "swin_block_bwd_split", "five": "swin_fused_block_bwd"}[route]
    names = ([] if route == "five" else ["swin_k4_fwd"]) + ["swin_fused_block_fwd", launcher]
    for name in names:
        (args,) = fake_library.calls[name]
        assert args[-2] == code and args[-3] == pytest.approx(d**-0.5), name
    if activation != "elu":
        assert tfb.ACTIVATION_LAUNCHES[activation] == fwd[activation] + (route != "five")
        assert tfb.ACTIVATION_BWD_LAUNCHES[activation] == bwd[activation] + 1
