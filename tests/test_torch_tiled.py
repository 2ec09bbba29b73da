"""The port's tiled fusion (``parallel/tiled.py``) against the JAX package's.

- ``plan_tiles`` and ``_ramp_weights`` equal to JAX's (the cases of
  ``tests/test_tiled_fusion.py`` and the 2K/4K plans).
- ``TiledFuser`` on the tiny model, weights from flax's ``model.init`` carried across by
  ``variables_from_jax``, at 126x126 with tile 56 and overlap 28 (16 tiles): fp32 I/O
  against JAX's ``TiledFuser`` under ``jnp`` at atol 2e-4 / rtol 1e-3 (the JAX package's
  tiny-model parity tolerance), the port under ``"auto"`` (the torch composition on the
  CPU) and ``"cuda"`` (the kernel wrappers' plain versions); uint8 I/O within one level
  of JAX's, differing only where JAX's float value x 255 lies within 255 x that tolerance
  of a half-integer; chunks of 6 tiles (a short last chunk) against one batch at atol 1e-6.
- Tile 98, overlap 70: tiled against the full forward of the port away from the border,
  as ``tests/test_tiled_fusion.py`` holds JAX's.

About 45 s in one process, most of it JAX's compile of `model.init` and its fusers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swin_unet_image_fusion_tpu.config import ModelConfig as JaxModelConfig
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.parallel import tiled as jtiled
from swin_unet_image_fusion_tpu_torch import ModelConfig, SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.models.from_jax import flatten_variables, variables_from_jax
from swin_unet_image_fusion_tpu_torch.parallel import tiled
from swin_unet_image_fusion_tpu_torch.parallel.tiled import TiledFuser

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
ATOL, RTOL = 2e-4, 1e-3
HW = 126
PLAN_CASES = [(2048, 512, 64), (1000, 512, 64), (300, 512, 64), (126, 56, 28), (126, 98, 70),
              (2160, 512, 64), (3840, 512, 64)]


@pytest.fixture(scope="module")
def jax_model_and_variables():
    model = JaxUNet(JaxModelConfig(**TINY, attention_impl="jnp"))
    zeros = jnp.zeros((1, 56, 56, 1))
    return model, jax.jit(model.init)(jax.random.PRNGKey(0), zeros, zeros)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    return rng.random((HW, HW, 1), dtype=np.float32), rng.random((HW, HW, 1), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_fp32(jax_model_and_variables):
    """JAX's float fuser at tile 56, overlap 28 (one compiled forward for its calls)."""
    return jtiled.TiledFuser(*jax_model_and_variables, tile=56, overlap=28)


def _port(variables, impl="auto", **kw):
    return TiledFuser(ModelConfig(**TINY, attention_impl=impl), variables, device="cpu", **kw)


@pytest.mark.parametrize("length,tile,overlap", PLAN_CASES)
def test_plan_tiles_and_ramp_weights_equal_jax(length, tile, overlap):
    t = min(tile, length)
    starts = tiled.plan_tiles(length, t, overlap)
    assert starts == jtiled.plan_tiles(length, t, overlap)
    np.testing.assert_array_equal(tiled._ramp_weights(t, starts, length),
                                  jtiled._ramp_weights(t, starts, length))


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_tiled_fp32_matches_jax(jax_model_and_variables, jax_fp32, pair, impl):
    _, variables = jax_model_and_variables
    ir, vis = pair
    ref = jax_fp32.fuse(ir, vis)
    fuser = _port(variables, impl, tile=56, overlap=28)
    assert fuser.plan(HW, HW).n_tiles == 16
    out = fuser.fuse(ir, vis)
    assert out.dtype == np.float32 and out.shape == (HW, HW, 1)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_tiled_uint8_matches_jax(jax_model_and_variables, jax_fp32, pair):
    model, variables = jax_model_and_variables
    ir8, vis8 = ((a * 255).astype(np.uint8) for a in pair)
    ref = jtiled.TiledFuser(model, variables, tile=56, overlap=28, return_uint8=True).fuse(ir8, vis8)
    ref_float = jax_fp32.fuse(ir8, vis8)
    out = _port(variables, tile=56, overlap=28, return_uint8=True).fuse(ir8, vis8)
    assert out.dtype == np.uint8 and out.shape == (HW, HW, 1)
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    scaled = np.clip(ref_float, 0, 1) * 255.0
    near_half = np.abs(scaled - np.floor(scaled) - 0.5) <= 255.0 * ATOL
    assert near_half[diff != 0].all(), "a level differs away from a rounding knife-edge"


def test_tiled_short_last_chunk_equals_one_batch(jax_model_and_variables, pair):
    _, variables = jax_model_and_variables
    ir, vis = pair
    whole = _port(variables, tile=56, overlap=28).fuse(ir, vis)
    chunked_fuser = _port(variables, tile=56, overlap=28, max_batch=6)
    calls = []
    chunked_fuser.model.register_forward_pre_hook(lambda _, args: calls.append(args[0].shape[0]))
    chunked = chunked_fuser.fuse(ir, vis)
    assert calls == [6, 6, 4], "16 tiles: two chunks of 6 and the last at its true size"
    np.testing.assert_allclose(chunked, whole, atol=1e-6, rtol=0)


def test_tiled_matches_full_forward_in_interior(jax_model_and_variables, pair):
    """Away from tile borders tiled fusion equals the full-image forward; random weights
    are the worst case (no decay of context), so the bound is loose, as JAX's test's."""
    _, variables = jax_model_and_variables
    ir, vis = pair
    model = SwinFusionUNet(ModelConfig(**TINY))
    model.load_state_dict(variables_from_jax(flatten_variables(variables)))
    with torch.inference_mode():
        full = torch.clamp(model(torch.from_numpy(ir[None]), torch.from_numpy(vis[None])), 0, 1)[0].numpy()
    out = TiledFuser(model, variables, tile=98, overlap=70, device="cpu").fuse(ir, vis)
    assert out.shape == full.shape
    c = np.abs(out[30:-30, 30:-30] - full[30:-30, 30:-30])
    assert c.mean() < 3e-2
    assert np.median(c) < 1e-3


def test_tiled_small_pair_is_one_forward(jax_model_and_variables):
    """A pair no larger than a tile is one tile of weight 1 in the port's plan, fused in
    one forward of the whole pair; JAX's fuser takes a branch of its own for it (uint8
    scaled by 1/255 there, divided by 255 here): within one level of it."""
    model, variables = jax_model_and_variables
    rng = np.random.default_rng(3)
    ir8, vis8 = ((rng.random((40, 52, 1)) * 255).astype(np.uint8) for _ in range(2))
    ref = jtiled.TiledFuser(model, variables, tile=56, overlap=28, return_uint8=True).fuse(ir8, vis8)
    fuser = _port(variables, tile=56, overlap=28, return_uint8=True)
    shapes = []
    fuser.model.register_forward_pre_hook(lambda _, args: shapes.append(tuple(args[0].shape)))
    out = fuser.fuse(ir8, vis8)
    assert fuser.plan(40, 52).n_tiles == 1 and shapes == [(1, 40, 52, 1)]
    assert out.dtype == ref.dtype == np.uint8 and out.shape == ref.shape == (40, 52, 1)
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
