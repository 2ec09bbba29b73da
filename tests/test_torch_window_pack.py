"""The port's window packing and re-partition (K2's plain version) against the JAX
package's packed strips and its Pallas re-partition kernel in interpret mode.

Packing and re-partition move tokens and compute nothing, so every comparison here is
bit-exact. The JAX strips hold two 64-lane windows per 128 lanes, C-major; they are
decoded to the port's (S, B, nWin, T, C) by dropping lanes 49..63.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swin_unet_image_fusion_tpu.models import layers as jlayers
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

WINDOW = (7, 7)


def _x(hw, c=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, 2, *hw, c)).astype(np.float32)


def _decode_strips(xp):
    """JAX packed strips (S, B, nh, nPw, C, 128) -> (S, B, nh*nPw*2, 49, C)."""
    s, b, nh, npw, c, _ = xp.shape
    x = np.asarray(xp).reshape(s, b, nh, npw, c, 2, jpp.TOK)[..., :49]
    return x.transpose(0, 1, 2, 3, 5, 6, 4).reshape(s, b, nh * npw * 2, 49, c)


@pytest.mark.parametrize("hw", [(7, 7), (14, 28), (21, 35)])
@pytest.mark.parametrize("shift", [False, True])
def test_pack_unpack_round_trip_is_exact(hw, shift):
    x = torch.from_numpy(_x(hw))
    xw = twp.pack_windows(x, WINDOW, shift)
    assert xw.shape == (2, 2, (hw[0] // 7) * (hw[1] // 7), 49, 8)
    assert torch.equal(twp.unpack_windows(xw, hw, WINDOW, shift), x)


@pytest.mark.parametrize("hw", [(7, 7), (14, 28), (21, 35)])
def test_repartition_equals_packing_in_the_other_geometry(hw):
    x = torch.from_numpy(_x(hw, seed=1))
    normal, shifted = twp.pack_windows(x, WINDOW, False), twp.pack_windows(x, WINDOW, True)
    launches = twp.LAUNCHES
    assert torch.equal(twp.repartition_windows(normal, hw, WINDOW, False, True), shifted)
    assert torch.equal(twp.repartition_windows(shifted, hw, WINDOW, True, False), normal)
    assert twp.LAUNCHES == launches, "the plain version must not count as a kernel launch"


@pytest.mark.parametrize("hw", [(14, 28), (28, 14)])
def test_normal_packing_equals_jax_strips(hw):
    x = _x(hw, seed=2)
    xp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(jnp.asarray(x), -1, 2), WINDOW, shift=False)
    port = twp.pack_windows(torch.from_numpy(x), WINDOW, False).numpy()
    np.testing.assert_array_equal(port, _decode_strips(xp))


@pytest.mark.parametrize("to_shift", [True, False])
def test_repartition_equals_jax_pallas_kernel_in_wrap_mode(to_shift):
    """At 14x28 both window counts are even and the JAX shifted geometry is the wrap-roll
    (``use_wrap``), so its strips hold the port's windows in the port's order."""
    hw = (14, 28)
    assert jpp.use_wrap(hw, WINDOW, True)
    x = _x(hw, seed=3)
    xp, _ = jpp.pack_windows_cmajor(jnp.moveaxis(jnp.asarray(x), -1, 2), WINDOW, shift=not to_shift)
    ref = jpp.repartition_packed_pallas(xp, WINDOW, hw, not to_shift, to_shift, interpret=True)
    src = twp.pack_windows(torch.from_numpy(x), WINDOW, not to_shift)
    port = twp.repartition_windows(src, hw, WINDOW, not to_shift, to_shift).numpy()
    np.testing.assert_array_equal(port, _decode_strips(ref))


def test_pack_beneficial_equals_jax_rule():
    for c in (8, 16, 24, 32, 48, 64, 96, 127, 128, 192, 255, 256, 384):
        for w in (7, 14, 16, 21, 27, 28, 35, 64, 70, 100, 128, 133, 259, 300):
            assert twp.pack_beneficial(c, w) == jlayers.pack_beneficial(c, w), (c, w)


def test_wrapper_rejects_a_wrong_window_count():
    with pytest.raises(ValueError, match="windows of a 14x28 map"):
        twp.repartition_windows(torch.zeros(2, 1, 7, 49, 8), (14, 28), WINDOW, False, True)
