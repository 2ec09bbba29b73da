"""The port's fused Swin block (K1 and K4's plain version) against the JAX package's
block kernels in interpret mode and its jnp composition, and the two configurations
that run it (``cuda_pack``, ``cuda_block``) through the tiny model.

On the CPU the fused block's wrapper runs its plain version, so these tests hold its
semantics (LN1 with the other stream's weights under cross, the clamped fast softmax,
wrap-rolled shifted windows, window-packed tokens) against the TPU kernels'. Weights
are made with numpy from a seed and carried into the port with ``variables_from_jax``.
Block level: atol 2e-5, rtol 1e-4, the JAX package's own kernel-vs-jnp tolerance.
Model level: atol 5e-5, rtol 1e-4, as the JAX package's whole-model kernel-vs-jnp test.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu.models.layers import pack_beneficial as jax_pack_beneficial
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.ops.shape_plan import make_plan as jax_make_plan
from swin_unet_image_fusion_tpu_torch import ModelConfig, SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.models.from_jax import (
    random_variables,
    random_variables_like,
    variables_from_jax,
)
from swin_unet_image_fusion_tpu_torch.models.layers import BasicBlock
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

BLOCK_ATOL, BLOCK_RTOL = 2e-5, 1e-4
MODEL_ATOL, MODEL_RTOL = 5e-5, 1e-4
WINDOW = (7, 7)
# (C, heads, d, MLP hidden, H, W, shift, cross): the JAX kernel tests' width and stage 0
# of the full model over shift x cross, and one case with the full model's outermost
# decoder MLP of hidden 4
CASES = {
    f"{name}-shift{int(shift)}-cross{int(cross)}": (*geometry, shift, cross)
    for name, geometry in (("c8", (8, 2, 4, 32, 14, 28)), ("c24_stage0", (24, 8, 3, 96, 14, 28)))
    for shift in (False, True) for cross in (False, True)
}
CASES["c24_hidden4-shift1-cross1"] = (24, 8, 3, 4, 14, 21, True, True)
TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)


def _block_case(case, seed=0):
    c, heads, d, hidden, h, w, shift, cross = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2, h, w, c)).astype(np.float32)
    kw = dict(streams=2, dims=c, num_heads=heads, dims_per_head=d, window_size=WINDOW,
              shift=shift, cross=cross, mlp_hidden_dims=hidden)
    abstract = jax.eval_shape(JaxBlock(**kw).init, jax.random.PRNGKey(0), jnp.asarray(x))
    flat = random_variables_like({k: v.shape for k, v in flatten_dict(abstract, sep="/").items()},
                                 seed + 1)
    port = BasicBlock(2, c, heads, d, WINDOW, shift, cross, hidden)
    port.load_state_dict(variables_from_jax(flat))
    return x, kw, unflatten_dict(flat, sep="/"), port


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_cuda_block_route_matches_jax_pallas_block(case):
    """``BasicBlock`` under ``cuda_block`` (the image layout) against JAX ``pallas_block``
    in interpret mode and the jnp composition."""
    x, kw, variables, port = _block_case(case)
    xj = jnp.asarray(x)
    ref = np.asarray(JaxBlock(**kw, impl="jnp").apply(variables, xj))
    kernel = np.asarray(jax.jit(JaxBlock(**kw, impl="pallas_block_interpret").apply)(variables, xj))
    launches = tfb.LAUNCHES
    with torch.no_grad():
        out = port(torch.from_numpy(x), "cuda_block").numpy()
    assert tfb.LAUNCHES == launches, "the plain version must not count as a kernel launch"
    np.testing.assert_allclose(out, kernel, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)
    np.testing.assert_allclose(out, ref, atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_cuda_pack_route_matches_jax_pallas_pack(case):
    """pack -> ``fused`` on window-packed tokens -> unpack (the ``cuda_pack`` block)
    against JAX ``pallas_pack`` in interpret mode on C-major input."""
    x, kw, variables, port = _block_case(case, seed=5)
    shift = kw["shift"]
    hw = x.shape[2:4]
    cmajor = jnp.moveaxis(jnp.asarray(x), -1, 2)
    kernel = jax.jit(JaxBlock(**kw, impl="pallas_pack_interpret", packed=True).apply)(variables, cmajor)
    with torch.no_grad():
        xw = twp.pack_windows(torch.from_numpy(x), WINDOW, shift)
        out = twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, shift).numpy()
    np.testing.assert_allclose(out, np.asarray(jnp.moveaxis(kernel, 2, -1)),
                               atol=BLOCK_ATOL, rtol=BLOCK_RTOL)


def test_both_layouts_compute_the_same_block():
    x, _, _, port = _block_case(CASES["c24_stage0-shift1-cross1"], seed=7)
    hw = x.shape[2:4]
    with torch.no_grad():
        image = port.fused(torch.from_numpy(x), "image")
        xw = twp.pack_windows(torch.from_numpy(x), WINDOW, True)
        windows = twp.unpack_windows(port.fused(xw, "windows", hw), hw, WINDOW, True)
    torch.testing.assert_close(image, windows, atol=0.0, rtol=0.0)


def test_wrapper_rejects_other_activations_and_layouts():
    x, _, _, port = _block_case(CASES["c8-shift0-cross0"])
    port.activation = "silu"
    with pytest.raises(ValueError, match="unknown activation"):
        port.fused(torch.from_numpy(x), "image")
    port.activation = "elu"
    with pytest.raises(ValueError, match="layout"):
        port.fused(torch.from_numpy(x), "nchw")
    with pytest.raises(ValueError, match="needs the map size"):
        port.fused(torch.zeros(2, 2, 8, 49, 8), "windows")


@functools.lru_cache(maxsize=None)
def _tiny_case(hw):
    """Tiny-model weights, inputs and the JAX jnp output at ``hw`` (shared by both impls)."""
    flat = random_variables(ModelConfig(**TINY), seed=6)
    rng = np.random.default_rng(8)
    ir = rng.random((2, *hw, 1), dtype=np.float32)
    vis = rng.random((2, *hw, 1), dtype=np.float32)
    jax_model = JaxUNet(jcfg.ModelConfig(**TINY, attention_impl="jnp"))
    ref = jax.jit(jax_model.apply)(unflatten_dict(flat, sep="/"), jnp.asarray(ir), jnp.asarray(vis))
    return flat, ir, vis, np.asarray(ref)


@pytest.mark.parametrize("impl", ["cuda_pack", "cuda_block"])
@pytest.mark.parametrize("hw", [(56, 56), (57, 43), (100, 90)])
def test_tiny_model_matches_jax_jnp(impl, hw):
    flat, ir, vis, ref = _tiny_case(hw)
    model = SwinFusionUNet(ModelConfig(**TINY, attention_impl=impl))
    model.load_state_dict(variables_from_jax(flat))
    with torch.no_grad():
        out = model(torch.from_numpy(ir), torch.from_numpy(vis)).numpy()
    np.testing.assert_allclose(out, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL)


def _jax_routes(cfg: jcfg.ModelConfig, hw, impl):
    """Each stage's kernel route as the JAX model takes it on a chip
    (``models/unet.py:76-111`` and ``models/layers.py:780-796``)."""
    plan = jax_make_plan(*hw, cfg.num_stages, cfg.merging_size, cfg.window_size)
    routes = []
    for k, p in enumerate(plan):
        packed = impl == "pallas_pack" and jax_pack_beneficial(cfg.out_dims_list[k], p.att_hw[1])
        gated = (cfg.attention_jnp_max_tokens is not None and not packed
                 and p.att_hw[0] * p.att_hw[1] <= cfg.attention_jnp_max_tokens)
        routes.append("jnp" if gated else "pallas_pack" if packed
                      else "pallas" if impl == "pallas_pack" else impl)
    return tuple(routes)


PORT_ROUTE = {"jnp": "torch", "pallas": "cuda", "pallas_pack": "cuda_pack",
              "pallas_block": "cuda_block"}


@pytest.mark.parametrize("cfg_kw", [{}, TINY], ids=["full", "tiny"])
@pytest.mark.parametrize("hw", [(512, 512), (100, 90), (224, 224), (56, 56), (57, 43), (6, 10)])
def test_stage_routes_follow_the_jax_routing(cfg_kw, hw):
    for jax_impl, impl in (("pallas_pack", "cuda_pack"), ("pallas_block", "cuda_block")):
        with torch.device("meta"):
            model = SwinFusionUNet(ModelConfig(**cfg_kw, attention_impl=impl))
        expected = tuple(PORT_ROUTE[r] for r in _jax_routes(jcfg.ModelConfig(**cfg_kw), hw, jax_impl))
        assert model.stage_impls(*hw, "cuda") == expected, (jax_impl, hw)


@pytest.mark.parametrize("hw,counts", [
    ((512, 512), dict(cuda_pack=(32, 24, 8), cuda_block=40)),
    ((100, 90), dict(cuda_pack=(24, 18, 8), cuda_block=24)),
])
def test_full_model_kernel_launches_per_request(hw, counts):
    """K1, K2 and K3 launches under ``cuda_pack`` and K4's under ``cuda_block``: each
    routed stage runs 4 blocks in the encoder and 4 in the decoder, and a packed stage
    re-partitions 3 times in each."""
    with torch.device("meta"):
        pack = SwinFusionUNet(ModelConfig(attention_impl="cuda_pack")).stage_impls(*hw, "cuda")
        block = SwinFusionUNet(ModelConfig(attention_impl="cuda_block")).stage_impls(*hw, "cuda")
    k1, k2, k3 = counts["cuda_pack"]
    assert (8 * pack.count("cuda_pack"), 6 * pack.count("cuda_pack"), 8 * pack.count("cuda")) == (k1, k2, k3)
    assert 8 * block.count("cuda_block") == counts["cuda_block"]


def test_fused_impls_resolve_as_named_and_auto_stays_on_k3():
    for impl in ("cuda_pack", "cuda_block"):
        for device in ("cpu", "cuda"):
            assert ModelConfig(attention_impl=impl).resolved_attention_impl(device) == impl
    assert ModelConfig().resolved_attention_impl("cuda") == "cuda"
    assert ModelConfig().resolved_attention_impl("cpu") == "torch"
