"""The bf16 backward forms of the port's kernels against the JAX package's custom VJPs.

At ``compute_dtype="bfloat16"`` the JAX kernels' backward bodies upcast their bf16 inputs
and run the recompute and the backward in fp32 with fp32 weights; the weight gradients
are fp32 and the input gradient is written in x's dtype (``pallas_attention.py:388-390,
495-498``, ``pallas_block.py:278-293, 439-449``, ``pallas_pack.py:792-794``). On the CPU
each wrapper runs that as its plain bf16 backward (not autograd of the bf16 forward's
rounding points), and the card tests hold the CUDA forms against it. Here the plain forms
of K4 (``pallas_block_interpret``), K1 (``pallas_pack_interpret``) and K3
(``pallas_interpret``) meet ``jax.vjp`` of the interpret kernels at the same bf16 input
and bf16 cotangent, without and with hash dropout at rate 0.5 (the JAX block seeds pinned
as in ``test_torch_dropout.py``):

- every weight gradient is fp32 and agrees at rtol 2e-4 and atol 2e-4, the fp32
  kernel-gradient tolerance of ``test_torch_grad.py`` (both sides are fp32 backwards at
  the same inputs), a gradient that is exactly 0 by construction at the call's largest;
- the input gradient is bf16 and agrees within one bf16 rounding of its scale (atol 2^-8
  x its largest magnitude), and at most 1% of its elements differ at all (the share is
  printed). Under cross JAX writes the q side and the k/v side of it as two bf16 outputs
  and adds them in bf16; the port rounds the two apart too;
- with dropout the forward is held as well (the bf16 forms keep the elements the fp32
  forms keep: a mask that differs at one element of a rate-0.5 site moves the output far
  outside the tolerance);
- K2's backward on bf16 tokens is bit-exact.

About 80 s in one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_to_jax
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close, exact_zero
from test_torch_attention import JaxAttention
from test_torch_attention import _case as attention_case
from test_torch_dropout import RATE, SEED, _set_block_rates, pinned_seed
from test_torch_fused_block import CASES, _block_case
from test_torch_grad import _cotangent
from test_torch_window_pack import _decode_strips

BF16 = torch.bfloat16
ATOL = RTOL = 2e-4  # fp32 weight gradients
INPUT_ATOL = 2.0**-8  # x the input gradient's largest magnitude: one bf16 rounding
MAX_MISMATCH_SHARE = 0.01  # of the input gradient's elements that may differ at all
FORWARD_RTOL, FORWARD_ATOL = 2.0**-7, 2.0**-6  # test_torch_bf16.py's kernel tolerance
WINDOW = (7, 7)
RATES = (RATE, RATE, RATE)
# stage 0 of the full model (C=24, 8 heads, d=3): self normal, cross shifted, and cross
# shifted with dropout
BLOCK_CASES = {f"{k}{'-drop' if drop else ''}": (CASES[k], drop)
               for k, drop in (("c24_stage0-shift0-cross0", False), ("c24_stage0-shift1-cross1", False),
                               ("c24_stage0-shift1-cross1", True))}
ATTENTION_CASES = {f"shift{int(s)}-cross{int(c)}{'-drop' if drop else ''}": (s, c, drop)
                   for s, c, drop in ((False, False, False), (True, True, False), (True, True, True))}


def _bf16(a: np.ndarray):
    """The same bf16 values for JAX and the port (both round to nearest even)."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(BF16)


def _jax_vjp(apply, variables, x, g):
    """(out, d x, flat d params) of ``apply(variables, x)`` for the cotangent g."""
    from flax.traverse_util import flatten_dict
    out, vjp = jax.vjp(apply, variables, x)
    d_vars, d_x = vjp(g)
    return out, d_x, {k: np.asarray(v) for k, v in flatten_dict(d_vars, sep="/").items()}


def _assert_input_grad(got: torch.Tensor, ref, what: str) -> None:
    assert got.dtype == BF16, f"{what}: the input gradient is {got.dtype}, not bfloat16"
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    share = float(np.mean(got != ref))
    print(f"{what}: {share:.3%} of the input gradient's elements differ from JAX's")
    np.testing.assert_allclose(got, ref, rtol=0, atol=INPUT_ATOL * np.abs(ref).max(), err_msg=what)
    assert share <= MAX_MISMATCH_SHARE, f"{what}: {share:.2%} of the input gradient differs"


def _assert_weight_grads(module, ref, what: str) -> None:
    got = variables_to_jax({n: p.grad for n, p in module.named_parameters()})
    assert set(got) == set(ref)
    call = max(np.abs(v).max() for v in ref.values())
    for name, value in ref.items():
        assert got[name].dtype == np.float32, f"{what} {name}: {got[name].dtype}"
        zero = exact_zero(name) or name == "params/k/bias"  # the attention module's own
        np.testing.assert_allclose(got[name], value, rtol=RTOL, atol=ATOL * call if zero else ATOL,
                                   err_msg=f"{what} {name}")


def _assert_forward(out: torch.Tensor, ref, what: str) -> None:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.dtype == BF16
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=FORWARD_RTOL,
                               atol=FORWARD_ATOL * np.abs(ref).max(), err_msg=what)


def _jax_block(kw, impl, drop, **extra):
    rates = dict(attention_drop_ratio=RATE, proj_drop_ratio=RATE, mlp_drop_ratio=RATE) if drop else {}
    block = JaxBlock(**kw, **rates, dtype=jnp.bfloat16, impl=impl, **extra)
    if not drop:
        return block.apply
    return lambda v, x: block.apply(v, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})


def _bwd_launches():
    return (tfb.BF16_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES,
            twa.BF16_DROP_BWD_LAUNCHES, twp.BF16_BWD_LAUNCHES)


@pytest.mark.parametrize("case,drop", BLOCK_CASES.values(), ids=BLOCK_CASES.keys())
def test_k4_plain_bf16_backward_matches_pallas_block(case, drop):
    """K4 bwd in bf16: ``BasicBlock.fused`` on the image against ``pallas_fused_block``."""
    x, kw, variables, port = _block_case(case, seed=51)
    (xj, xt), (gj, gt) = _bf16(x), _bf16(_cotangent(x.shape, 52))
    apply = jax.jit(_jax_block(kw, "pallas_block_interpret", drop))
    with pinned_seed(jpb, "pallas_fused_block", SEED) as calls:
        ref_out, ref_x, ref_params = _jax_vjp(apply, variables, xj, gj)
    assert calls == ([SEED] if drop else [])
    if drop:
        _set_block_rates(port, RATES)
    launches = _bwd_launches()
    xt.requires_grad_()
    out = port.fused(xt, "image", seed=SEED if drop else None)
    out.backward(gt)
    assert _bwd_launches() == launches, "the plain backward must not count as a kernel launch"
    _assert_forward(out, ref_out, "K4 bf16 forward")
    _assert_input_grad(xt.grad, ref_x, "K4 bf16 bwd")
    _assert_weight_grads(port, ref_params, "K4 bf16 bwd")


@pytest.mark.parametrize("case,drop", BLOCK_CASES.values(), ids=BLOCK_CASES.keys())
def test_k1_plain_bf16_backward_matches_pallas_pack(case, drop):
    """K1 bwd in bf16: pack -> ``fused`` on window-packed tokens -> unpack against
    ``pallas_packed_block_strips`` on C-major input."""
    x, kw, variables, port = _block_case(case, seed=53)
    shift, hw = kw["shift"], x.shape[2:4]
    (xj, xt), (gj, gt) = _bf16(x), _bf16(_cotangent(x.shape, 54))
    packed = _jax_block(kw, "pallas_pack_interpret", drop, packed=True)
    cmajor = jax.jit(lambda v, a: jnp.moveaxis(packed(v, jnp.moveaxis(a, -1, 2)), 2, -1))
    with pinned_seed(jpp, "pallas_packed_block_strips", SEED) as calls:
        ref_out, ref_x, ref_params = _jax_vjp(cmajor, variables, xj, gj)
    assert calls == ([SEED] if drop else [])
    if drop:
        _set_block_rates(port, RATES)
    xt.requires_grad_()
    xw = twp.pack_windows(xt, WINDOW, shift)
    out = twp.unpack_windows(port.fused(xw, "windows", hw, seed=SEED if drop else None), hw,
                             WINDOW, shift)
    out.backward(gt)
    _assert_forward(out, ref_out, "K1 bf16 forward")
    _assert_input_grad(xt.grad, ref_x, "K1 bf16 bwd")
    _assert_weight_grads(port, ref_params, "K1 bf16 bwd")


@pytest.mark.parametrize("shift,cross,drop", ATTENTION_CASES.values(), ids=ATTENTION_CASES.keys())
def test_k3_plain_bf16_backward_matches_pallas_attention(shift, cross, drop):
    """K3 bwd in bf16: ``DualWindowAttention`` under ``cuda`` against
    ``pallas_window_attention``; with dropout on its attention weights only (the
    projection's dropout is the caller's)."""
    x, kw, variables, port = attention_case((24, 8, 3, 14, 21), shift, cross, seed=55)
    (xj, xt), (gj, gt) = _bf16(x), _bf16(_cotangent(x.shape, 56))
    rates = dict(attention_drop_ratio=RATE) if drop else {}
    module = JaxAttention(**kw, **rates, dtype=jnp.bfloat16, impl="pallas_interpret")
    apply = jax.jit(lambda v, a: module.apply(v, a, deterministic=not drop,
                                              rngs={"dropout": jax.random.PRNGKey(0)}))
    with pinned_seed(jpa, "pallas_window_attention", SEED) as calls:
        ref_out, ref_x, ref_params = _jax_vjp(apply, variables, xj, gj)
    assert calls == ([SEED] if drop else [])
    port.attention_drop_ratio = RATE if drop else 0.0
    key = dl.keying("k4", x.shape[2:4], WINDOW, shift, 8, 3, "cpu")
    xt.requires_grad_()
    out = port(xt, "cuda", (SEED, key) if drop else None)
    out.backward(gt)
    _assert_forward(out, ref_out, "K3 bf16 forward")
    _assert_input_grad(xt.grad, ref_x, "K3 bf16 bwd")
    _assert_weight_grads(port, ref_params, "K3 bf16 bwd")


@pytest.mark.parametrize("to_shift", [True, False])
def test_k2_bf16_backward_is_bit_exact(to_shift):
    """K2's backward on bf16 tokens: the inverse permutation, bit-exact against the
    transposed taps of ``repartition_packed_pallas``."""
    hw = (14, 28)
    rng = np.random.default_rng(57)
    xj, _ = _bf16(rng.standard_normal((2, 2, *hw, 8)).astype(np.float32))
    gj, gt = _bf16(rng.standard_normal((2, 2, *hw, 8)).astype(np.float32))
    xp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(xj, -1, 2), WINDOW, shift=not to_shift)
    gp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(gj, -1, 2), WINDOW, shift=to_shift)
    _, vjp = jax.vjp(lambda a: jpp.repartition_packed_pallas(a, WINDOW, hw, not to_shift, to_shift,
                                                              interpret=True), xp)
    (ref,) = vjp(gp)
    assert ref.dtype == jnp.bfloat16
    src = twp.pack_windows(torch.zeros(2, 2, *hw, 8, dtype=BF16), WINDOW, not to_shift).requires_grad_()
    twp.repartition_windows(src, hw, WINDOW, not to_shift, to_shift).backward(
        twp.pack_windows(gt, WINDOW, to_shift))
    assert src.grad.dtype == BF16
    np.testing.assert_array_equal(src.grad.float().numpy(), _decode_strips(ref.astype(jnp.float32)))


@pytest.mark.parametrize("bias_seed", [0, 2, 8])
def test_bf16_backward_forms_return_bf16_input_and_fp32_weight_gradients(bias_seed):
    """The plain bf16 backward forms themselves: g_x in bf16, every weight gradient fp32,
    and under cross g_x is the bf16 sum of the separately rounded q and k/v sides.

    The reference is the fp32 backward through the same ``kv=`` split
    (``window_attention.split_input_grad``): the q side and the k/v side of g_x, each
    rounded to bf16 and added in bf16, and the weight gradients, all equal bit for bit. The
    fp32 backward without the split (``kv=None``) sums the two sides' contributions to a
    weight gradient in another order: it is held at each tensor's own scale. The bias table
    comes from a local generator; draws 2 and 8 are ones where the two orders differ in the
    last bits of the LN1 gradients."""
    x, _, _, port = _block_case(CASES["c8-shift1-cross1"], seed=58)
    xt = torch.from_numpy(x).to(BF16)
    g = torch.from_numpy(_cotangent(x.shape, 59)).to(BF16)
    attn = port.attn
    table = torch.randn(2, 49, 49, generator=torch.Generator().manual_seed(bias_seed))
    weights = [t.detach() for t in (port.norm1.scale, port.norm1.bias)]
    weights += [t.detach() for layer in (attn.q, attn.k, attn.v, attn.proj) for t in layer.weights()]
    weights += [table, port.norm2.scale.detach(), port.norm2.bias.detach()]
    weights += [t.detach() for t in (*port.mlp.fc1.weights(), *port.mlp.fc2.weights())]
    kw = dict(window=WINDOW, num_heads=2, dims_per_head=4, shift=True, cross=True, layout="image")
    grads = tfb.fused_block_bwd_plain(g, xt, *weights, **kw)
    assert grads[0].dtype == BF16 and all(t.dtype == torch.float32 for t in grads[1:])
    leaves = [t.detach().clone().requires_grad_() for t in weights]
    xq, xkv = (xt.float().requires_grad_() for _ in range(2))
    split = torch.autograd.grad(tfb.fused_block_plain(xq, *leaves, kv=xkv, **kw), [xq, xkv, *leaves],
                                g.float())
    assert torch.equal(grads[0], (split[0].to(BF16).float() + split[1].to(BF16).float()).to(BF16))
    for name, got, want in zip(tfb.WEIGHT_NAMES, grads[1:], split[2:]):
        assert torch.equal(got, want), name
    fp32 = tfb.fused_block_bwd_plain(g.float(), xt.float(), *weights, **kw)
    assert_grads_close(grads[1:], fp32[1:], tfb.WEIGHT_NAMES, "bf16 block bwd against kv=None")
    assert not torch.equal(grads[0], fp32[0].to(BF16)), "cross rounds its two sides apart"
    torch.testing.assert_close(grads[0].float(), fp32[0], rtol=0, atol=2.0**-7 * fp32[0].abs().max().item())
    attention = twa.window_attention_bwd_plain(g, xt, *weights[2:11], window=WINDOW, num_heads=2,
                                               dims_per_head=4, shift=True, cross=False)
    assert attention[0].dtype == BF16 and all(t.dtype == torch.float32 for t in attention[1:])


def test_bf16_composition_masks_keep_the_fp32_elements():
    """The composition's masks on bf16 tensors (their plain versions; the card tests hold
    the kernels to them bit for bit): the elements the fp32 masks keep, each multiplied by
    the fp32 scale and rounded once, forward and on the gradient."""
    key = dl.keying("k4", (14, 14), WINDOW, True, 2, 4, "cpu")
    rate = 0.1  # scale 1/0.9: the product is not exact in bf16
    x = torch.from_numpy(_cotangent((2, 2, 14, 14, 8), 60)).to(BF16).requires_grad_()
    out = dm.token_dropout(x, SEED, hd.SITE_MLP_HIDDEN, rate, key)
    want = dm.token_dropout(x.detach().float(), SEED, hd.SITE_MLP_HIDDEN, rate, key)
    assert out.dtype == BF16 and torch.equal(out, want.to(BF16))
    (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
    assert torch.equal(g, (want != 0).float().mul(hd.keep_scale(rate)).to(BF16))
    weights = torch.rand(2, 2 * 4, 2, 49, 49, generator=torch.Generator().manual_seed(61)).to(BF16)
    got = dm.attention_dropout(weights, SEED, rate, key)
    assert torch.equal(got, dm.attention_dropout(weights.float(), SEED, rate, key).to(BF16))
