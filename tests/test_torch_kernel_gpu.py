"""The CUDA kernels on the card: window attention (K3), the fused block (K1/K4) and the
window re-partition (K2) against their plain versions, and inside the whole model under
each kernel configuration against the CPU and without blocking the host.

These tests import no JAX, so they run on a machine with a card and without JAX:
``python -m pytest -m gpu --noconftest tests/test_torch_kernel_gpu.py`` (``tests/conftest.py``
imports JAX). Without a card they skip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_from_jax
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
from swin_unet_image_fusion_tpu_torch.models.unet import SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp


TINY = ModelConfig(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
                   att_dims_per_head_ratio=1 / 2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_kernel_matches_plain_on_card(shift, cross):
    """The CUDA kernel against its plain version on the card (stage-0 and C=384 widths,
    two images per stream). Tolerance atol 1e-4, rtol 1e-4: fp32 sums of up to 384
    terms, possibly in another order."""
    _need_card()
    for c, h in ((24, 28), (384, 21)):
        gen = torch.Generator(device="cpu").manual_seed(c)
        d = c // 8

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        args = (rand(2, 2, h, h, c), rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1),
                rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1),
                rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1),
                rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1), rand(2, 49, 49))
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross)
        launches = twa.LAUNCHES
        out = twa.window_attention(*args, **kw)
        torch.cuda.synchronize()
        assert twa.LAUNCHES == launches + 1
        torch.testing.assert_close(out, twa.window_attention_plain(*args, **kw), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_tiny_model_on_card_matches_cpu():
    """The tiny model through Fuser on the card (kernel route, both stages launch) against
    the CPU composition; atol 5e-5, rtol 1e-4 as the CPU kernel-route test."""
    _need_card()
    cfg = TINY
    variables = random_variables(cfg, seed=7)
    rng = np.random.default_rng(7)
    ir = rng.random((2, 57, 43, 1), dtype=np.float32)
    vis = rng.random((2, 57, 43, 1), dtype=np.float32)
    launches = twa.LAUNCHES
    out = Fuser(Config(model=cfg), variables).fuse_y(ir, vis)
    assert twa.LAUNCHES == launches + 16  # 2 stages x 4 blocks x (encoder + decoder)
    ref = Fuser(Config(model=cfg), variables, device="cpu").fuse_y(ir, vis)
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=1e-4)


@pytest.mark.gpu
def test_forward_never_blocks_the_host_after_warmup():
    """After a first call at a size, the forward copies nothing from the host: shape
    constants (bias indices, pad indices, masks) stay on the card, so no operation of
    the forward waits for the device (PyTorch's sync debug mode raises on one that does)."""
    _need_card()
    model = SwinFusionUNet(TINY)
    model.load_state_dict(variables_from_jax(random_variables(TINY, seed=8)))
    model.to("cuda").eval()
    ir, vis = torch.rand(2, 2, 57, 43, 1, device="cuda").unbind(0)
    with torch.inference_mode():
        model(ir, vis)
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(ir, vis)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def _block_args(c, hidden, hw, seed, layout, shift):
    """x (in ``layout``) and the 17 weights of one fused block, both streams."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    d = c // 8

    def rand(*shape, scale=1.0, offset=0.0):
        return (torch.randn(*shape, generator=gen) * scale + offset).cuda()

    x = rand(2, 2, *hw, c)
    if layout == "windows":
        x = twp.pack_windows(x, (7, 7), shift).contiguous()
    dense = lambda i, o: (rand(2, i, o, scale=i**-0.5), rand(2, o, scale=0.1))
    weights = (rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
               *dense(c, c), *dense(c, c), *dense(c, c), *dense(c, c), rand(2, 49, 49),
               rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
               *dense(c, hidden), *dense(hidden, c))
    return x, weights, d


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_fused_block_matches_plain_on_card(layout, shift, cross):
    """The fused block (K4 on the image, K1 on window-packed tokens) against its plain
    version on the card: stage-0 width with the encoder MLP and the decoder's hidden 4,
    and C=384 with its encoder MLP. atol/rtol 1e-4: fp32 sums of up to 1,536 terms in
    another order."""
    _need_card()
    for c, hidden, hw in ((24, 96, (28, 35)), (24, 4, (14, 14)), (384, 1536, (21, 21))):
        x, weights, d = _block_args(c, hidden, hw, c + hidden, layout, shift)
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross,
                  layout=layout, hw=hw)
        launches = tfb.LAUNCHES
        out = tfb.fused_block(x, *weights, **kw)
        torch.cuda.synchronize()
        assert tfb.LAUNCHES == launches + 1
        torch.testing.assert_close(out, tfb.fused_block_plain(x, *weights, **kw), atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [24, 6])
def test_repartition_is_bit_exact_on_card(c):
    """The re-partition kernel equals its plain version exactly, both directions, with
    16-byte pieces (C=24) and 4-byte ones (C=6)."""
    _need_card()
    for hw in ((7, 7), (14, 28), (35, 21)):
        x = torch.randn(2, 3, *hw, c, device="cuda")
        for from_shift in (False, True):
            xw = twp.pack_windows(x, (7, 7), from_shift).contiguous()
            launches = twp.LAUNCHES
            out = twp.repartition_windows(xw, hw, (7, 7), from_shift, not from_shift)
            torch.cuda.synchronize()
            assert twp.LAUNCHES == launches + 1
            assert torch.equal(out, twp.repartition_windows_plain(xw, hw, (7, 7), from_shift, not from_shift))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda_pack", "cuda_block"])
def test_tiny_model_under_fused_configs_on_card_matches_cpu(impl):
    """The tiny model through Fuser on the card under each fused-block configuration,
    with the launches its stage routes call for, against the CPU composition; atol 5e-5,
    rtol 1e-4 as the CPU kernel-route tests."""
    _need_card()
    cfg = dataclasses.replace(TINY, attention_impl=impl)
    variables = random_variables(cfg, seed=9)
    rng = np.random.default_rng(9)
    ir = rng.random((2, 57, 43, 1), dtype=np.float32)
    vis = rng.random((2, 57, 43, 1), dtype=np.float32)
    fuser = Fuser(Config(model=cfg), variables)
    routes = fuser.model.stage_impls(57, 43, "cuda")
    before = (tfb.LAUNCHES, twp.LAUNCHES, twa.LAUNCHES)
    out = fuser.fuse_y(ir, vis)
    got = tuple(n - b for n, b in zip((tfb.LAUNCHES, twp.LAUNCHES, twa.LAUNCHES), before))
    assert got == (8 * (routes.count("cuda_pack") + routes.count("cuda_block")),
                   6 * routes.count("cuda_pack"), 8 * routes.count("cuda"))
    assert got[0] > 0
    ref = Fuser(Config(model=TINY), variables, device="cpu").fuse_y(ir, vis)
    np.testing.assert_allclose(out, ref, atol=5e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda_pack", "cuda_block"])
def test_fused_configs_never_block_the_host_after_warmup(impl):
    """As ``test_forward_never_blocks_the_host_after_warmup``, under each fused-block
    configuration (its window masks and packing stay on the card too)."""
    _need_card()
    cfg = dataclasses.replace(TINY, attention_impl=impl)
    model = SwinFusionUNet(cfg)
    model.load_state_dict(variables_from_jax(random_variables(cfg, seed=8)))
    model.to("cuda").eval()
    ir, vis = torch.rand(2, 2, 57, 43, 1, device="cuda").unbind(0)
    with torch.inference_mode():
        model(ir, vis)
        torch.cuda.set_sync_debug_mode("error")
        try:
            model(ir, vis)
        finally:
            torch.cuda.set_sync_debug_mode("default")
