"""The port's Canny (``ops/edges.py::canny``) and the Canny texture term against the JAX
package's.

- ``canny`` against JAX ``canny`` on seeded 1- and 3-channel images (noise, a smooth
  pattern, the noisy step edge of ``tests/test_losses.py``), with and without
  hysteresis: the NMS magnitude to atol 2e-5, the edge map bit-equal; the same against
  ``tests/kornia_ref.py::Canny``.
- the chunked hysteresis at 1, 3 and 8 dilation steps a chunk, bit-equal, and the chunk
  count against the fixpoint's iterations.
- one call over a stacked batch giving each image its own maps, bit for bit (the texture
  term stacks its three batches).
- ``texture_term`` and ``total_fusion_loss`` with ``choose_canny_else_sobel=True`` against
  JAX's (rtol 1e-5), the Canny edge map carrying no gradient; ``config_from_cli`` reaching
  the option.

About 35 s in one process, most of it JAX's compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kornia_ref
from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import losses as jlosses
from swin_unet_image_fusion_tpu.ops.edges import canny as jax_canny
from swin_unet_image_fusion_tpu_torch import losses
from swin_unet_image_fusion_tpu_torch.config import LossConfig, config_from_cli
from swin_unet_image_fusion_tpu_torch.ops import edges

from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.random(shape, dtype=np.float32)
    if kind == "smooth":  # smooth stripes: long edges, many weak pixels for the hysteresis
        x = np.cumsum(np.cumsum(rng.random(shape), axis=1), axis=2)
        return (0.5 + 0.5 * np.sin(8 * x / x.max())).astype(np.float32)
    img = np.zeros(shape, np.float32)  # the noisy vertical step edge of tests/test_losses.py
    img[:, :, shape[2] // 2:, :] = 1.0
    return np.clip(img + 0.01 * rng.standard_normal(shape).astype(np.float32), 0, 1)


CASES = [("noise", (2, 40, 48, 1)), ("smooth", (2, 40, 48, 1)), ("noise", (2, 37, 41, 3)),
         ("smooth", (1, 64, 56, 3)), ("step", (1, 32, 32, 1))]
IDS = [f"{kind}-{'x'.join(map(str, shape))}" for kind, shape in CASES]


@pytest.mark.parametrize("hysteresis", [True, False], ids=["hysteresis", "thresholds"])
@pytest.mark.parametrize("kind,shape", CASES, ids=IDS)
def test_canny_matches_jax(kind, shape, hysteresis):
    x = _image(kind, shape, seed=len(IDS) + shape[1])
    ref_mag, ref_edges = (np.asarray(a) for a in jax_canny(jnp.asarray(x), hysteresis=hysteresis))
    mag, out = (a.numpy() for a in edges.canny(torch.from_numpy(x), hysteresis=hysteresis))
    assert mag.shape == out.shape == (*shape[:3], 1)
    np.testing.assert_allclose(mag, ref_mag, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out, ref_edges)
    if kind == "step":
        assert out[0, :, 14:18, 0].max() == 1.0 and out[0, :, :8, 0].max() == 0.0


@pytest.mark.parametrize("kind,shape", CASES, ids=IDS)
def test_canny_matches_kornia(kind, shape):
    x = _image(kind, shape, seed=shape[2])
    ref_mag, ref_edges = kornia_ref.Canny()(torch.from_numpy(x).permute(0, 3, 1, 2))
    mag, out = edges.canny(torch.from_numpy(x))
    np.testing.assert_allclose(mag.permute(0, 3, 1, 2).numpy(), ref_mag.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_array_equal(out.permute(0, 3, 1, 2).numpy(), ref_edges.numpy())


@pytest.mark.parametrize("kind,shape", CASES[:2] + CASES[3:], ids=IDS[:2] + IDS[3:])
def test_chunked_hysteresis_is_bit_equal_for_any_chunk(kind, shape, monkeypatch):
    x = torch.from_numpy(_image(kind, shape, seed=3))
    maps, chunks = {}, {}
    for k in (1, 3, 8):
        monkeypatch.setattr(edges, "HYSTERESIS_CHUNK", k)
        before = edges.HYSTERESIS_CHUNKS
        maps[k] = edges.canny(x)[1]
        chunks[k] = edges.HYSTERESIS_CHUNKS - before
    assert torch.equal(maps[1], maps[3]) and torch.equal(maps[1], maps[8])
    # a chunk of one step checks after every step: the c steps that change the map and
    # one that does not; k steps a chunk take ceil(c / k) chunks and one that changes nothing
    changing = chunks[1] - 1
    for k in (3, 8):
        assert chunks[k] == -(-changing // k) + 1


@pytest.mark.parametrize("kind,shape", CASES, ids=IDS)
def test_canny_of_a_stacked_batch_is_each_images_own(kind, shape):
    """The texture term runs one call over the fused, ir and vis batches stacked: each
    image's magnitude and edge map equal those of a call on that image alone."""
    images = [torch.from_numpy(_image(kind, shape, seed=s)) for s in (21, 22, 23)]
    mag, out = edges.canny(torch.cat(images))
    for i, x in enumerate(images):
        one_mag, one_out = edges.canny(x)
        assert torch.equal(mag[i * shape[0]:(i + 1) * shape[0]], one_mag)
        assert torch.equal(out[i * shape[0]:(i + 1) * shape[0]], one_out)


@pytest.mark.parametrize("choose_ms_ssim", [True, False], ids=["ms_ssim", "ssim"])
def test_canny_loss_terms_match_jax(choose_ms_ssim):
    rng = np.random.default_rng(11)
    fusion, ir, vis = (rng.random((2, 40, 36, 1), dtype=np.float32) for _ in range(3))
    jax_cfg = jcfg.LossConfig(choose_canny_else_sobel=True, choose_ms_ssim=choose_ms_ssim)
    port_cfg = LossConfig(choose_canny_else_sobel=True, choose_ms_ssim=choose_ms_ssim)
    ref_texture = jlosses.texture_term(jax_cfg, *map(jnp.asarray, (fusion, ir, vis)))
    texture = losses.texture_term(port_cfg, *map(torch.from_numpy, (fusion, ir, vis)))
    np.testing.assert_allclose(texture.item(), float(ref_texture), rtol=1e-5)
    assert texture.item() > 0

    _, ref_terms = jlosses.total_fusion_loss(jax_cfg, *map(jnp.asarray, (fusion, ir, vis)))
    ft = torch.from_numpy(fusion).requires_grad_()
    total, terms = losses.total_fusion_loss(port_cfg, ft, torch.from_numpy(ir), torch.from_numpy(vis))
    assert set(terms) == set(ref_terms)
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), float(ref_terms[name]), rtol=1e-5, err_msg=name)
    assert not terms["texture_loss"].requires_grad, "the edge map carries no gradient"
    total.backward()  # the other terms still carry the fused image's gradient
    assert ft.grad.abs().max() > 0


def test_canny_texture_gradient_is_zero_as_in_jax():
    rng = np.random.default_rng(12)
    fusion, ir, vis = (rng.random((1, 24, 28, 1), dtype=np.float32) for _ in range(3))
    cfg = jcfg.LossConfig(choose_canny_else_sobel=True)
    grad = jax.grad(lambda f: jlosses.texture_term(cfg, f, jnp.asarray(ir), jnp.asarray(vis)))(jnp.asarray(fusion))
    assert not np.asarray(grad).any()


def test_config_from_cli_reaches_the_canny_term():
    cfg = config_from_cli(["loss.choose_canny_else_sobel=true"])
    assert cfg.loss.choose_canny_else_sobel
    x = torch.from_numpy(_image("step", (1, 32, 32, 1), seed=1))
    value = losses.texture_term(cfg.loss, x * 0.5, x, x)
    expected = torch.mean(torch.abs(edges.canny(x * 0.5)[1] - edges.canny(x)[1]))
    assert value.item() == expected.item()
