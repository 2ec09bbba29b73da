"""The port's bfloat16 forward against the JAX package's (``compute_dtype="bfloat16"``).

- Each composition layer against its JAX module in bf16: rtol 2^-7 and atol 2^-7 x the
  reference's largest magnitude (one bf16 ulp is 2^-8 relative; a sum in another order
  may flip a rounding).
- Each bf16 plain kernel against the JAX kernel in interpret mode in bf16: K3
  (``pallas_window_attention``), K4 (``pallas_block_interpret``), K1
  (``pallas_pack_interpret``), self and cross, normal and shifted, at rtol 2^-7 (two bf16
  ulps) and atol 2^-6 x the reference's largest magnitude, the tolerance ``chip_smoke.py``
  holds the CUDA kernels to; K2 bit-equal to ``repartition_packed_pallas``.
- Both also hold at most 2% of the elements to differ at all. The tolerance alone cannot
  tell one set of rounding points from another: K4's rounding against JAX's K1 output,
  or the composition against K3, stay within it but differ in 66-75% of the elements,
  where the right rounding points differ in at most 0.73% (K4; K3 0.035%, K1 0.05%, the
  composition layers none).
- Forward hooks on every submodule of the bf16 model hold each output's dtype to the
  JAX module's, which catches PyTorch's silent promotion of bf16 + fp32 to fp32.
- The whole tiny model, ``torch`` against JAX ``jnp``, by the image-level criteria of
  ``testing.py`` (never a largest difference); the interpret routes are in
  ``test_torch_bf16_model.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu.models import layers as jl
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch import ModelConfig, SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.models import layers as tl
from swin_unet_image_fusion_tpu_torch.models.from_jax import (
    random_variables,
    random_variables_like,
    variables_from_jax,
)
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import assert_bf16_fidelity
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BF16 = torch.bfloat16
LAYER_RTOL, LAYER_ATOL = 2.0**-7, 2.0**-7  # atol times the reference's largest magnitude
KERNEL_RTOL, KERNEL_ATOL = 2.0**-7, 2.0**-6
MAX_MISMATCH_SHARE = 0.02  # of the elements that may differ from the reference at all
WINDOW = (7, 7)
TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
# (C, heads, d, MLP hidden, H, W): stage 0 of the full model
STAGE0 = (24, 8, 3, 96, 14, 28)
VARIANTS = [(shift, cross) for shift in (False, True) for cross in (False, True)]
VARIANT_IDS = [f"shift{int(s)}-cross{int(c)}" for s, c in VARIANTS]


def _bf16_pair(x: np.ndarray):
    """The same bf16 values for JAX and the port (both round to nearest even)."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(BF16)


def _assert_close(out: torch.Tensor, ref, rtol, atol_scale, what=""):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert out.dtype == BF16, f"{what}: the port's output is {out.dtype}, not bfloat16"
    got = out.float().numpy()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_scale * np.abs(ref).max(),
                               err_msg=what)
    share = float(np.mean(got != ref))
    assert share <= MAX_MISMATCH_SHARE, f"{what}: {share:.2%} of the elements differ"


def _variables(jax_module, seed, *args, **kwargs):
    """Seeded numpy variables for ``jax_module`` in flat flax naming, and nested."""
    abstract = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *args, **kwargs)
    flat = random_variables_like({k: v.shape for k, v in flatten_dict(abstract, sep="/").items()},
                                 seed)
    return flat, unflatten_dict(flat, sep="/")


def _port(module, flat):
    module.load_state_dict(variables_from_jax(flat))
    return module.eval()


# ---- composition layers ----------------------------------------------------------------

def _layer_cases():
    s, c = 2, 16
    return {
        "dense": (lambda dt: jl.StackedDense(s, 24, True, dt), lambda: tl.StackedDense(s, c, 24),
                  (s, 2, 7, 14, c)),
        "layer_norm": (lambda dt: jl.StackedLayerNorm(s), lambda: tl.StackedLayerNorm(s, c),
                       (s, 2, 7, 14, c)),
        "merge": (lambda dt: jl.PatchMergeLayer(s, 24, (2, 2), "elu", dt),
                  lambda: tl.PatchMergeLayer(s, c, 24, (2, 2)), (s, 2, 14, 14, c)),
        "unmerge": (lambda dt: jl.PatchUnmergeLayer(s, 8, (2, 2), "elu", dt),
                    lambda: tl.PatchUnmergeLayer(s, c, 8, (2, 2)), (s, 2, 7, 7, c)),
        "mlp": (lambda dt: jl.DualMLP(s, c, 64, "elu", dtype=dt), lambda: tl.DualMLP(s, c, 64),
                (s, 2, 7, 14, c)),
        "attention": (lambda dt: jl.DualWindowAttention(s, c, 2, 8, WINDOW, True, True, dtype=dt),
                      lambda: tl.DualWindowAttention(s, c, 2, 8, WINDOW, True, True),
                      (s, 2, 14, 21, c)),
        "head": (lambda dt: jl.FinalHead(3, "elu", dt), lambda: tl.FinalHead(3, "elu"),
                 (2, 20, 18, 2)),
    }


@pytest.mark.parametrize("name", list(_layer_cases()))
def test_composition_layer_matches_jax_in_bf16(name):
    make_jax, make_port, shape = _layer_cases()[name]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    xj, xt = _bf16_pair(x)
    flat, variables = _variables(make_jax(jnp.bfloat16), 2, xj)
    ref = make_jax(jnp.bfloat16).apply(variables, xj)
    assert ref.dtype == jnp.bfloat16
    with torch.no_grad():
        out = _port(make_port(), flat)(xt)
    _assert_close(out, ref, LAYER_RTOL, LAYER_ATOL, name)


# ---- the plain versions of the bf16 kernels --------------------------------------------

def _block(shift, cross, seed):
    c, heads, d, hidden, h, w = STAGE0
    x = np.random.default_rng(seed).standard_normal((2, 2, h, w, c)).astype(np.float32)
    kw = dict(streams=2, dims=c, num_heads=heads, dims_per_head=d, window_size=WINDOW,
              shift=shift, cross=cross, mlp_hidden_dims=hidden)
    flat, variables = _variables(jl.BasicBlock(**kw), seed + 1, jnp.asarray(x))
    port = _port(tl.BasicBlock(2, c, heads, d, WINDOW, shift, cross, hidden), flat)
    return x, kw, variables, port


@pytest.mark.parametrize("shift,cross", VARIANTS, ids=VARIANT_IDS)
def test_k3_plain_bf16_matches_pallas_interpret(shift, cross):
    c, heads, d, _, h, w = STAGE0
    x = np.random.default_rng(3).standard_normal((2, 2, h, w, c)).astype(np.float32)
    kw = dict(streams=2, dims=c, num_heads=heads, dims_per_head=d, window_size=WINDOW,
              shift=shift, cross=cross)
    xj, xt = _bf16_pair(x)
    flat, variables = _variables(jl.DualWindowAttention(**kw), 4, jnp.asarray(x))
    ref = jl.DualWindowAttention(**kw, dtype=jnp.bfloat16, impl="pallas_interpret").apply(variables, xj)
    port = _port(tl.DualWindowAttention(2, c, heads, d, WINDOW, shift, cross), flat)
    before = (twa.LAUNCHES, twa.BF16_LAUNCHES)
    with torch.no_grad():
        out = port(xt, "cuda")  # the plain version: the tensor is on the CPU
    assert (twa.LAUNCHES, twa.BF16_LAUNCHES) == before, "the plain version never counts"
    _assert_close(out, ref, KERNEL_RTOL, KERNEL_ATOL, "K3 bf16")


@pytest.mark.parametrize("shift,cross", VARIANTS, ids=VARIANT_IDS)
def test_k4_plain_bf16_matches_pallas_block_interpret(shift, cross):
    x, kw, variables, port = _block(shift, cross, seed=5)
    xj, xt = _bf16_pair(x)
    ref = jax.jit(jl.BasicBlock(**kw, dtype=jnp.bfloat16, impl="pallas_block_interpret").apply)(
        variables, xj)
    with torch.no_grad():
        out = port(xt, "cuda_block")
    _assert_close(out, ref, KERNEL_RTOL, KERNEL_ATOL, "K4 bf16")


@pytest.mark.parametrize("shift,cross", VARIANTS, ids=VARIANT_IDS)
def test_k1_plain_bf16_matches_pallas_pack_interpret(shift, cross):
    x, kw, variables, port = _block(shift, cross, seed=7)
    xj, xt = _bf16_pair(x)
    hw = x.shape[2:4]
    ref = jax.jit(jl.BasicBlock(**kw, dtype=jnp.bfloat16, impl="pallas_pack_interpret",
                                packed=True).apply)(variables, jnp.moveaxis(xj, -1, 2))
    with torch.no_grad():
        xw = twp.pack_windows(xt, WINDOW, shift)
        out = twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, shift)
    _assert_close(out, jnp.moveaxis(ref, 2, -1), KERNEL_RTOL, KERNEL_ATOL, "K1 bf16")


def test_k4_and_k1_keep_their_own_rounding_in_bf16():
    """K4 rounds its products' operands to bf16 and K1 computes in fp32 inside: the two
    layouts agree bit for bit in fp32 and differ in bf16, where K1 stays nearer fp32."""
    x, _, _, port = _block(True, True, seed=9)
    hw = x.shape[2:4]
    with torch.no_grad():
        exact = port.fused(torch.from_numpy(x).to(BF16).float(), "image")
        image = port.fused(torch.from_numpy(x).to(BF16), "image")
        xw = twp.pack_windows(torch.from_numpy(x).to(BF16), WINDOW, True)
        windows = twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, True)
    assert image.dtype == windows.dtype == BF16
    assert not torch.equal(image, windows)
    assert torch.equal(windows, exact.to(BF16)), "K1 in bf16 is the fp32 block with bf16 I/O"


@pytest.mark.parametrize("to_shift", [True, False])
def test_k2_bf16_is_bit_equal_to_jax_pallas_kernel(to_shift):
    hw = (14, 28)
    x = np.random.default_rng(11).standard_normal((2, 2, *hw, 8)).astype(np.float32)
    xj, xt = _bf16_pair(x)
    xp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(xj, -1, 2), WINDOW, shift=not to_shift)
    ref = jpp.repartition_packed_pallas(xp, WINDOW, hw, not to_shift, to_shift, interpret=True)
    assert ref.dtype == jnp.bfloat16
    src = twp.pack_windows(xt, WINDOW, not to_shift)
    out = twp.repartition_windows(src, hw, WINDOW, not to_shift, to_shift)
    assert out.dtype == BF16
    s, b, nh, npw, c, _ = ref.shape
    strips = np.asarray(ref.astype(jnp.float32)).reshape(s, b, nh, npw, c, 2, jpp.TOK)[..., :49]
    decoded = strips.transpose(0, 1, 2, 3, 5, 6, 4).reshape(s, b, nh * npw * 2, 49, c)
    np.testing.assert_array_equal(out.float().numpy(), decoded)


# ---- the whole model ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_flat():
    return random_variables(ModelConfig(**TINY), seed=0)


def _inputs(hw, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((2, *hw, 1), dtype=np.float32), rng.random((2, *hw, 1), dtype=np.float32))


def _run_port(flat, ir, vis, **cfg):
    model = _port(SwinFusionUNet(ModelConfig(**TINY, **cfg)), flat)
    with torch.no_grad():
        return model(torch.from_numpy(ir), torch.from_numpy(vis))


def _run_jax(flat, ir, vis, **cfg):
    model = JaxUNet(jcfg.ModelConfig(**TINY, **cfg))
    return np.asarray(jax.jit(model.apply)(unflatten_dict(flat, sep="/"), jnp.asarray(ir),
                                           jnp.asarray(vis)))


# (module class, the dtype of its output in the JAX bf16 model)
OUTPUT_DTYPES = {
    "StackedDense": BF16, "StackedLayerNorm": BF16, "DualWindowAttention": BF16,
    "DualMLP": BF16, "BasicBlock": BF16, "SelfAndCrossBlockPair": BF16,
    "PatchMergeLayer": BF16, "PatchUnmergeLayer": BF16, "BatchNorm": torch.float32,
    "FinalHead": BF16, "SwinFusionUNet": torch.float32,
}


@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda_pack", "cuda_block"])
def test_every_module_output_has_the_jax_dtype(tiny_flat, impl):
    model = _port(SwinFusionUNet(ModelConfig(**TINY, attention_impl=impl,
                                             compute_dtype="bfloat16")), tiny_flat)
    seen = {}

    def hook(module, _, out):
        name = type(module).__name__
        assert name in OUTPUT_DTYPES, f"no expected dtype for {name}"
        seen.setdefault(name, set()).add(out.dtype)

    for m in model.modules():
        m.register_forward_hook(hook)
    ir, vis = _inputs((56, 56))
    with torch.no_grad():
        model(torch.from_numpy(ir), torch.from_numpy(vis))
    assert seen == {name: {OUTPUT_DTYPES[name]} for name in seen}
    assert "SwinFusionUNet" in seen and "PatchMergeLayer" in seen and "FinalHead" in seen
    if impl == "torch":
        assert set(seen) == set(OUTPUT_DTYPES)


@pytest.mark.parametrize("hw", [(56, 56), (57, 43)])
def test_tiny_bf16_forward_matches_jax_jnp(tiny_flat, hw):
    ir, vis = _inputs(hw)
    out = _run_port(tiny_flat, ir, vis, attention_impl="torch", compute_dtype="bfloat16")
    assert out.dtype == torch.float32 and out.shape == (2, *hw, 1)
    ref16 = _run_jax(tiny_flat, ir, vis, attention_impl="jnp", compute_dtype="bfloat16")
    ref32 = _run_jax(tiny_flat, ir, vis, attention_impl="jnp")
    assert_bf16_fidelity(out, ref16, "bfloat16", f"torch vs jnp bf16 at {hw}")
    assert_bf16_fidelity(out, ref32, "float32", f"torch bf16 vs jnp fp32 at {hw}")


def test_bf16_training_raises(tiny_flat):
    """bf16 training is ported: the training forward runs (BatchNorm on the batch's
    statistics in fp32, the output fp32) and its backward reaches every parameter with an
    fp32 gradient. Nothing raises any more: with rematerialisation the bf16 forward and
    every gradient equal those without it, bit for bit."""
    model = _port(SwinFusionUNet(ModelConfig(**TINY, compute_dtype="bfloat16")), tiny_flat).train()
    ir, vis = _inputs((14, 14))
    before = model.final_head.bn.mean.clone()
    out = model(torch.from_numpy(ir), torch.from_numpy(vis), train=True)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert not torch.equal(model.final_head.bn.mean, before), "batch statistics update"
    out.sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32 for p in model.parameters())
    remat = _port(SwinFusionUNet(ModelConfig(**TINY, compute_dtype="bfloat16", remat=True)), tiny_flat)
    remat_out = remat(torch.from_numpy(ir), torch.from_numpy(vis), train=True)
    assert torch.equal(remat_out, out)
    remat_out.sum().backward()
    grads = dict(model.named_parameters())
    for name, p in remat.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        SwinFusionUNet(ModelConfig(**TINY, compute_dtype="float16"))


def test_forward_accumulates_bf16_products_in_fp32(tiny_flat):
    """The forward turns cuBLAS's reduced-precision reduction of bf16 GEMMs off while it
    runs (the JAX composition accumulates in fp32), whatever the caller set, and restores
    the caller's setting after."""
    matmul = torch.backends.cuda.matmul
    model = _port(SwinFusionUNet(ModelConfig(**TINY, compute_dtype="bfloat16")), tiny_flat)
    seen = []
    model.final_head.register_forward_hook(
        lambda *_: seen.append(matmul.allow_bf16_reduced_precision_reduction))
    ir, vis = _inputs((14, 14))
    before = matmul.allow_bf16_reduced_precision_reduction
    try:
        for setting in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = setting
            with torch.no_grad():
                model(torch.from_numpy(ir), torch.from_numpy(vis))
            assert matmul.allow_bf16_reduced_precision_reduction == setting
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before
    assert seen == [False, False]


def test_image_criteria_fail_an_offset_map_and_a_saturated_one():
    """The model-level criteria pass a map within a bf16 rounding of its reference and
    fail one that is off by 0.02 everywhere (PSNR 34 dB, mean 2e-2) or whose reference is
    saturated by the clamp."""
    ref = np.random.default_rng(12).random((1, 64, 64, 1)).astype(np.float32)
    near = torch.from_numpy(ref).to(BF16).float().numpy()
    assert_bf16_fidelity(near, ref, "bfloat16")
    assert_bf16_fidelity(near, ref, "float32")
    with pytest.raises(AssertionError, match="misses"):
        assert_bf16_fidelity(ref + 0.02, ref, "bfloat16")
    with pytest.raises(AssertionError, match="inside"):
        assert_bf16_fidelity(ref, np.round(ref), "bfloat16")
