"""The CUDA kernels on the card: window attention (K3), the fused block (K1/K4) and the
window re-partition (K2) against their plain versions, forward and backward, and inside
the whole model under each kernel configuration against the CPU, without blocking the
host, and through one train step.

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
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close


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


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_attention_bwd_matches_plain_on_card(shift, cross):
    """K3's backward kernel against autograd of its plain version on the card, at the
    stage-0 width and at C=384, two images per stream."""
    _need_card()
    for c, h in ((24, 28), (384, 21)):
        gen = torch.Generator(device="cpu").manual_seed(c + 1)
        d = c // 8

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        args = [rand(2, 2, h, h, c), rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1),
                rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1),
                rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1),
                rand(2, c, c, scale=c**-0.5), rand(2, c, scale=0.1), rand(2, 49, 49)]
        g = rand(2, 2, h, h, c)
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross)
        inputs = [a.requires_grad_() for a in args]
        launches = twa.BWD_LAUNCHES
        got = torch.autograd.grad(twa.window_attention(*inputs, **kw), inputs, g)
        torch.cuda.synchronize()
        assert twa.BWD_LAUNCHES == launches + 1
        ref = twa.window_attention_bwd_plain(g, *args, **kw)
        assert_grads_close(got, ref, ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias"))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_fused_block_bwd_matches_plain_on_card(layout, shift, cross):
    """The fused block's backward kernel (K4 bwd on the image, K1 bwd on window-packed
    tokens) against autograd of its plain version on the card, at the shapes of the
    forward test."""
    _need_card()
    for c, hidden, hw in ((24, 96, (28, 35)), (24, 4, (14, 14)), (384, 1536, (21, 21))):
        x, weights, d = _block_args(c, hidden, hw, c + hidden + 1, layout, shift)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(c)).cuda()
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross,
                  layout=layout, hw=hw)
        inputs = [a.requires_grad_() for a in (x, *weights)]
        launches = tfb.BWD_LAUNCHES
        got = torch.autograd.grad(tfb.fused_block(*inputs, **kw), inputs, g)
        torch.cuda.synchronize()
        assert tfb.BWD_LAUNCHES == launches + 1
        ref = tfb.fused_block_bwd_plain(g, x, *weights, **kw)
        assert_grads_close(got, ref, ("x", *tfb.WEIGHT_NAMES))


@pytest.mark.gpu
@pytest.mark.parametrize("c", [24, 6])
def test_repartition_bwd_is_bit_exact_on_card(c):
    """The re-partition's backward (the kernel from the other geometry back) equals the
    plain inverse permutation exactly."""
    _need_card()
    for hw in ((7, 7), (14, 28), (35, 21)):
        for from_shift in (False, True):
            xw = twp.pack_windows(torch.randn(2, 3, *hw, c, device="cuda"), (7, 7), from_shift)
            xw = xw.contiguous().requires_grad_()
            g = torch.randn(xw.shape, device="cuda")
            launches = twp.BWD_LAUNCHES
            (got,) = torch.autograd.grad(
                twp.repartition_windows(xw, hw, (7, 7), from_shift, not from_shift), xw, g)
            torch.cuda.synchronize()
            assert twp.BWD_LAUNCHES == launches + 1
            ref = twp.repartition_windows_bwd_plain(g, hw, (7, 7), from_shift, not from_shift)
            assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "cuda_pack", "cuda_block"])
def test_tiny_train_step_on_card_matches_cpu(impl):
    """One train step of the tiny model on the card under each kernel configuration: every
    parameter gets a finite gradient through the backward kernels, each kernel's backward
    runs as often as its forward, and loss, gradients and BatchNorm statistics agree with
    the CPU composition (loss rtol 1e-5; gradients by ``testing.assert_grads_close``, as
    the kernel tests)."""
    _need_card()
    from swin_unet_image_fusion_tpu_torch.config import OptimConfig
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    variables = random_variables(TINY, seed=10)
    rng = np.random.default_rng(10)
    ir, vis = (torch.from_numpy(rng.random((2, 28, 28, 1), dtype=np.float32)) for _ in range(2))
    results = {}
    for name, device in ((impl, "cuda"), ("torch", "cpu")):
        cfg = Config(model=dataclasses.replace(TINY, attention_impl=name),
                     optim=OptimConfig(lr=1e-3))
        state = create_train_state(cfg, variables, 10, device=device)
        before = [(m.LAUNCHES, m.BWD_LAUNCHES) for m in (tfb, twa, twp)]
        terms = make_train_step(cfg)(state, ir.to(device), vis.to(device))
        counts = [(m.LAUNCHES - f, m.BWD_LAUNCHES - b) for m, (f, b) in zip((tfb, twa, twp), before)]
        grads = {n: p.grad for n, p in state.model.named_parameters()}
        results[name] = (terms, grads, state.model.final_head.bn.mean.cpu(), counts)
    terms, grads, bn_mean, counts = results[impl]
    assert all(f == b for f, b in counts) and sum(f for f, _ in counts) > 0, counts
    ref_terms, ref_grads, ref_bn_mean, _ = results["torch"]
    torch.testing.assert_close(terms["total_loss"].cpu(), ref_terms["total_loss"], rtol=1e-5, atol=0)
    for name, grad in grads.items():
        assert grad is not None and torch.isfinite(grad).all(), name
    assert_grads_close([grads[n].cpu() for n in ref_grads], list(ref_grads.values()), list(ref_grads))
    torch.testing.assert_close(bn_mean, ref_bn_mean, rtol=1e-5, atol=1e-6)


# ---- the bf16 forms of the forward kernels -----------------------------------------------

BF16_RTOL, BF16_ATOL = 2.0**-7, 2.0**-6  # atol times the reference's largest magnitude
# of the elements that may differ from the plain version at all: the right rounding points
# differ in up to 3.4% (K4 at C=384, where sums of 1,536 terms in another order flip more
# roundings), other rounding points in 66-75% (tests/test_torch_bf16.py)
MAX_MISMATCH_SHARE = 0.1


def _assert_bf16_close(out, ref, what):
    """bf16 kernel against its bf16 plain version: rtol 2^-7 (two bf16 ulps), atol 2^-6 x
    the largest magnitude (room for a rare flip of an intermediate rounding), and at most
    10% of the elements different at all."""
    assert out.dtype == ref.dtype == torch.bfloat16, what
    o, r = out.float(), ref.float()
    torch.testing.assert_close(o, r, rtol=BF16_RTOL, atol=BF16_ATOL * r.abs().max().item(),
                               msg=lambda m: f"{what}: {m}")
    share = (o != r).float().mean().item()
    assert share <= MAX_MISMATCH_SHARE, f"{what}: {share:.2%} of the elements differ"


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_bf16_kernels_match_plain_on_card(shift, cross):
    """K3, K4 (image) and K1 (windows) on bf16 activations against their bf16 plain
    versions on the card, at the stage-0 width and at C=384; each counts as a bf16 launch
    and never as an fp32 one."""
    _need_card()
    for c, hidden, hw in ((24, 96, (28, 35)), (384, 1536, (21, 21))):
        for layout in ("image", "windows"):
            x, weights, d = _block_args(c, hidden, hw, c + hidden, layout, shift)
            x = x.to(torch.bfloat16)
            kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross,
                      layout=layout, hw=hw)
            before = (tfb.LAUNCHES, tfb.BF16_LAUNCHES)
            out = tfb.fused_block(x, *weights, **kw)
            torch.cuda.synchronize()
            assert (tfb.LAUNCHES, tfb.BF16_LAUNCHES) == (before[0], before[1] + 1)
            _assert_bf16_close(out, tfb.fused_block_plain(x, *weights, **kw), f"{layout} C={c}")
            if layout == "image":
                attn = (x, *weights[2:11])
                akw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross)
                before = (twa.LAUNCHES, twa.BF16_LAUNCHES)
                out = twa.window_attention(*attn, **akw)
                torch.cuda.synchronize()
                assert (twa.LAUNCHES, twa.BF16_LAUNCHES) == (before[0], before[1] + 1)
                _assert_bf16_close(out, twa.window_attention_plain(*attn, **akw), f"K3 C={c}")


@pytest.mark.gpu
@pytest.mark.parametrize("c", [24, 6])
def test_repartition_bf16_is_bit_exact_on_card(c):
    """The re-partition kernel on bf16 tokens, 16-byte pieces (C=24) and 4-byte ones (C=6)."""
    _need_card()
    for hw in ((7, 7), (14, 28), (35, 21)):
        x = torch.randn(2, 3, *hw, c, device="cuda").to(torch.bfloat16)
        for from_shift in (False, True):
            xw = twp.pack_windows(x, (7, 7), from_shift).contiguous()
            before = (twp.LAUNCHES, twp.BF16_LAUNCHES)
            out = twp.repartition_windows(xw, hw, (7, 7), from_shift, not from_shift)
            torch.cuda.synchronize()
            assert (twp.LAUNCHES, twp.BF16_LAUNCHES) == (before[0], before[1] + 1)
            assert out.dtype == torch.bfloat16
            assert torch.equal(out, twp.repartition_windows_plain(xw, hw, (7, 7), from_shift, not from_shift))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "cuda_pack", "cuda_block"])
def test_tiny_bf16_model_on_card_matches_cpu(impl):
    """The tiny model in bf16 through Fuser on the card, launching only the bf16 kernel
    forms, against the CPU bf16 composition by the image-level criteria of
    ``testing.py`` (mean |diff| <= 1e-2, PSNR >= 30 dB): bf16 rounding flips amplify
    through the stages, so no largest difference is held."""
    from swin_unet_image_fusion_tpu_torch.testing import assert_bf16_fidelity

    _need_card()
    cfg = dataclasses.replace(TINY, attention_impl=impl, compute_dtype="bfloat16")
    variables = random_variables(cfg, seed=0)
    rng = np.random.default_rng(0)
    ir = rng.random((2, 56, 56, 1), dtype=np.float32)
    vis = rng.random((2, 56, 56, 1), dtype=np.float32)
    fuser = Fuser(Config(model=cfg), variables)
    routes = fuser.model.stage_impls(56, 56, "cuda")
    counters = (tfb.LAUNCHES, tfb.BF16_LAUNCHES, twp.LAUNCHES, twp.BF16_LAUNCHES,
                twa.LAUNCHES, twa.BF16_LAUNCHES)
    out = fuser.fuse_y(ir, vis)
    got = tuple(n - b for n, b in zip((tfb.LAUNCHES, tfb.BF16_LAUNCHES, twp.LAUNCHES,
                                       twp.BF16_LAUNCHES, twa.LAUNCHES, twa.BF16_LAUNCHES), counters))
    assert got == (0, 8 * (routes.count("cuda_pack") + routes.count("cuda_block")),
                   0, 6 * routes.count("cuda_pack"), 0, 8 * routes.count("cuda"))
    ref = Fuser(Config(model=dataclasses.replace(cfg, attention_impl="torch")), variables,
                device="cpu").fuse_y(ir, vis)
    assert_bf16_fidelity(out, ref, "bfloat16", f"{impl} bf16 on the card vs the CPU composition")


# ---- the hash-dropout forms of the forward and backward kernels -----------------------------

DROP_RATES = (0.5, 0.5, 0.5)  # at 0.5 a mask that differs in one element cannot hide
DROP_SEED = 1_234_567


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_dropout_kernels_match_plain_on_card(layout, shift, cross):
    """The dropout forms of K4 (image) and K1 (windows) with every site at rate 0.5, and
    of K3 (its attention site), forward and backward, against the plain versions with the
    same seed on the card: the masks must be the same element for element. Forward
    atol/rtol 1e-4 as the fp32 kernels; gradients by ``testing.assert_grads_close``. Each
    call counts as a dropout launch and never as a plain one."""
    _need_card()
    for c, hidden, hw in ((24, 96, (28, 35)), (384, 1536, (21, 21))):
        x, weights, d = _block_args(c, hidden, hw, c + hidden + 2, layout, shift)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(c + 2)).cuda()
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross,
                  layout=layout, hw=hw, drop_rates=DROP_RATES, drop_seed=DROP_SEED)
        inputs = [a.requires_grad_() for a in (x, *weights)]
        before = (tfb.LAUNCHES, tfb.DROP_LAUNCHES, tfb.BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES)
        out = tfb.fused_block(*inputs, **kw)
        got = torch.autograd.grad(out, inputs, g)
        torch.cuda.synchronize()
        assert (tfb.LAUNCHES, tfb.DROP_LAUNCHES, tfb.BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES) == (
            before[0], before[1] + 1, before[2], before[3] + 1)
        with torch.no_grad():
            torch.testing.assert_close(out, tfb.fused_block_plain(x, *weights, **kw), atol=1e-4, rtol=1e-4)
        assert_grads_close(got, tfb.fused_block_bwd_plain(g, x, *weights, **kw), ("x", *tfb.WEIGHT_NAMES),
                           f"{layout} C={c}")
        if layout == "image":
            attn = [a.detach().requires_grad_() for a in (x, *weights[2:11])]
            akw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross,
                       attn_drop_rate=0.5, drop_seed=DROP_SEED)
            before = (twa.LAUNCHES, twa.DROP_LAUNCHES, twa.BWD_LAUNCHES, twa.DROP_BWD_LAUNCHES)
            out = twa.window_attention(*attn, **akw)
            got = torch.autograd.grad(out, attn, g)
            torch.cuda.synchronize()
            assert (twa.LAUNCHES, twa.DROP_LAUNCHES, twa.BWD_LAUNCHES, twa.DROP_BWD_LAUNCHES) == (
                before[0], before[1] + 1, before[2], before[3] + 1)
            with torch.no_grad():
                plain = twa.window_attention_plain(*[a.detach() for a in attn], **akw)
            torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
            assert_grads_close(got, twa.window_attention_bwd_plain(g, *[a.detach() for a in attn], **akw),
                               ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias"), f"K3 C={c}")


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [False, True])
def test_composition_masks_match_plain_on_card(shift):
    """The composition's mask kernels (a token site at stage-0 and C=384 widths, the
    attention weights of a 14x21 map) against their plain versions on the card at rate
    0.5, forward and on the gradient, bit for bit: both compute ``keep ? x * scale : 0``.
    Each direction is one launch."""
    _need_card()
    gen = torch.Generator().manual_seed(int(shift) + 5)
    for hw, cols in (((28, 35), 24), ((21, 21), 1536)):
        key = dl.keying("k4", hw, (7, 7), shift, 8, 3, "cuda")
        x = torch.randn(2, 3, *hw, cols, generator=gen).cuda().requires_grad_()
        g = torch.randn(x.shape, generator=gen).cuda()
        before = (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES)
        out = dm.token_dropout(x, DROP_SEED, hd.SITE_MLP_HIDDEN, 0.5, key)
        (got,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
        assert (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        ref = dm.token_dropout_plain(x, DROP_SEED, hd.SITE_MLP_HIDDEN, 0.5, key)
        assert torch.equal(out, ref) and torch.equal(got, torch.autograd.grad(ref, x, g)[0])
    key = dl.keying("k4", (14, 21), (7, 7), shift, 8, 3, "cuda")
    weights = torch.rand(2, 3 * 6, 8, 49, 49, generator=gen).cuda().requires_grad_()
    g = torch.randn(weights.shape, generator=gen).cuda()
    before = (dm.ATTN_LAUNCHES, dm.ATTN_BWD_LAUNCHES)
    out = dm.attention_dropout(weights, DROP_SEED, 0.5, key)
    (got,) = torch.autograd.grad(out, weights, g)
    torch.cuda.synchronize()
    assert (dm.ATTN_LAUNCHES, dm.ATTN_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = dm.attention_dropout_plain(weights, DROP_SEED, 0.5, key)
    assert torch.equal(out, ref) and torch.equal(got, torch.autograd.grad(ref, weights, g)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["cuda", "cuda_pack", "cuda_block"])
def test_tiny_dropout_train_step_on_card_matches_cpu(impl):
    """One train step of the tiny model with every dropout ratio 0.2 on the card against
    the same configuration on the CPU (the plain versions) with the same block seeds: the
    hash masks make the two the same function. Loss rtol 1e-5; gradients by
    ``testing.assert_grads_close``; the dropout forms launch, the plain forms do not."""
    _need_card()
    from swin_unet_image_fusion_tpu_torch.config import OptimConfig
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    cfg = Config(model=dataclasses.replace(TINY, attention_impl=impl, attention_drop_ratio=0.2,
                                           linear_after_att_drop_ratio=0.2, mlp_drop_ratio=0.2),
                 optim=OptimConfig(lr=1e-3))
    variables = random_variables(TINY, seed=11)
    rng = np.random.default_rng(11)
    ir, vis = (torch.from_numpy(rng.random((2, 28, 28, 1), dtype=np.float32)) for _ in range(2))
    seeds = [(7_919 * (i + 1)) % (1 << 24) for i in range(16)]
    results = {}
    for device in ("cuda", "cpu"):
        state = create_train_state(cfg, variables, 10, device=device)
        before = [(m.LAUNCHES, m.DROP_LAUNCHES, m.DROP_BWD_LAUNCHES) for m in (tfb, twa)]
        terms = make_train_step(cfg)(state, ir.to(device), vis.to(device), seeds=seeds)
        counts = [(m.LAUNCHES - a, m.DROP_LAUNCHES - b, m.DROP_BWD_LAUNCHES - c)
                  for m, (a, b, c) in zip((tfb, twa), before)]
        results[device] = (terms, {n: p.grad for n, p in state.model.named_parameters()}, counts)
    terms, grads, counts = results["cuda"]
    assert all(a == 0 and b == c for a, b, c in counts) and sum(b for _, b, _ in counts) > 0, counts
    ref_terms, ref_grads, _ = results["cpu"]
    torch.testing.assert_close(terms["total_loss"].cpu(), ref_terms["total_loss"], rtol=1e-5, atol=0)
    assert_grads_close([grads[n].cpu() for n in ref_grads], list(ref_grads.values()), list(ref_grads))


# ---- bf16 training: the bf16 backward forms and the bf16 dropout forms ------------------

BF16 = torch.bfloat16
ATTENTION_NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")


def _bf16_bwd_cases(layout, shift, cross):
    """(what, module, args, kw, names) of the fused block in ``layout`` and, on the image,
    of K3, with bf16 x, at the stage-0 width and at C=384."""
    for c, hidden, hw in ((24, 96, (28, 35)), (384, 1536, (21, 21))):
        x, weights, d = _block_args(c, hidden, hw, c + hidden + 3, layout, shift)
        x = x.to(BF16)
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=shift, cross=cross)
        yield (f"{layout} C={c}", tfb, (x, *weights), dict(kw, layout=layout, hw=hw),
               ("x", *tfb.WEIGHT_NAMES))
        if layout == "image":
            yield f"K3 C={c}", twa, (x, *weights[2:11]), kw, ATTENTION_NAMES


def _bf16_call(module, args, kw, rate):
    """The wrapper of ``module`` with dropout at ``rate`` (every site of a block, the
    attention site of K3), and the counters of its forward and backward form."""
    if rate:
        kw = (dict(kw, drop_rates=(rate,) * 3, drop_seed=DROP_SEED) if module is tfb
              else dict(kw, attn_drop_rate=rate, drop_seed=DROP_SEED))
    fn = tfb.fused_block if module is tfb else twa.window_attention
    plain = tfb.fused_block_plain if module is tfb else twa.window_attention_plain
    plain_bwd = tfb.fused_block_bwd_plain if module is tfb else twa.window_attention_bwd_plain
    counters = ("BF16_DROP_LAUNCHES", "BF16_DROP_BWD_LAUNCHES") if rate else ("BF16_LAUNCHES",
                                                                              "BF16_BWD_LAUNCHES")
    return fn, plain, plain_bwd, kw, counters


def _counts(module):
    names = ("LAUNCHES", "BF16_LAUNCHES", "DROP_LAUNCHES", "BF16_DROP_LAUNCHES", "BWD_LAUNCHES",
             "BF16_BWD_LAUNCHES", "DROP_BWD_LAUNCHES", "BF16_DROP_BWD_LAUNCHES")
    return {n: getattr(module, n) for n in names}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_bf16_backward_kernels_match_plain_on_card(layout, shift, cross):
    """The bf16 backward forms of K4 (image), K1 (windows) and K3 against their plain
    bf16 backward (the fp32 backward at the upcast inputs, g_x rounded as JAX rounds it)
    on the card: g_x bf16 by the bf16 kernel criteria, every weight gradient fp32 by
    ``testing.assert_grads_close``. Each call counts one bf16 forward and one bf16
    backward launch and nothing else."""
    _need_card()
    for what, module, args, kw, names in _bf16_bwd_cases(layout, shift, cross):
        fn, _, plain_bwd, kw, (fwd, bwd) = _bf16_call(module, args, kw, 0.0)
        g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(7)).cuda().to(BF16)
        inputs = [a.detach().requires_grad_() for a in args]
        before = _counts(module)
        got = torch.autograd.grad(fn(*inputs, **kw), inputs, g)
        torch.cuda.synchronize()
        assert _counts(module) == {n: c + (n in (fwd, bwd)) for n, c in before.items()}, what
        ref = plain_bwd(g, *args, **kw)
        assert got[0].dtype == BF16 and all(t.dtype == torch.float32 for t in got[1:]), what
        _assert_bf16_close(got[0], ref[0], f"{what} g_x")
        assert_grads_close(got[1:], ref[1:], names[1:], what)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_bf16_dropout_kernels_match_plain_on_card(layout, shift, cross):
    """The bf16 dropout forms, forward and backward, with every site (K3: its attention
    site) at rate 0.5 against their plain bf16 versions with the same seed on the card,
    and their keep masks against the fp32 dropout form's: the bf16 backward computes the
    fp32 backward at the upcast inputs with the same kernels, so its weight gradients equal
    the fp32 dropout kernel's there bit for bit (a mask that differs in one element would
    move a sum), but the LN1 scale and bias of K1/K4 under cross, which sum the q and the
    k/v sides of LN1's gradient in another order."""
    _need_card()
    for what, module, args, kw, names in _bf16_bwd_cases(layout, shift, cross):
        fn, plain, plain_bwd, kw, (fwd, bwd) = _bf16_call(module, args, kw, 0.5)
        g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(8)).cuda().to(BF16)
        inputs = [a.detach().requires_grad_() for a in args]
        before = _counts(module)
        out = fn(*inputs, **kw)
        got = torch.autograd.grad(out, inputs, g)
        torch.cuda.synchronize()
        assert _counts(module) == {n: c + (n in (fwd, bwd)) for n, c in before.items()}, what
        with torch.no_grad():
            _assert_bf16_close(out, plain(*args, **kw), f"{what} forward")
        ref = plain_bwd(g, *args, **kw)
        _assert_bf16_close(got[0], ref[0], f"{what} g_x")
        assert_grads_close(got[1:], ref[1:], names[1:], what)
        fp32 = module._launch_bwd(g.float(), args[0].float(), args[1:], kw)
        apart = ("ln1_scale", "ln1_bias") if cross and module is tfb else ()  # q + k/v sums
        for name, a, b in zip(names[1:], got[1:], fp32[1:]):
            assert name in apart or torch.equal(a, b), f"{what} {name}: not the fp32 form's masks"
        assert_grads_close(got[1:], fp32[1:], names[1:], f"{what} against the fp32 form")


@pytest.mark.gpu
@pytest.mark.parametrize("c", [24, 6])
def test_repartition_bwd_bf16_is_bit_exact_on_card(c):
    """The re-partition's backward on a bf16 gradient equals the plain inverse permutation
    exactly and counts as a bf16 backward launch."""
    _need_card()
    for hw in ((14, 28), (35, 21)):
        x = torch.randn(2, 3, *hw, c, device="cuda").to(BF16)
        for from_shift in (False, True):
            xw = twp.pack_windows(x, (7, 7), from_shift).contiguous().requires_grad_()
            g = torch.randn(xw.shape, device="cuda").to(BF16)
            before = (twp.BWD_LAUNCHES, twp.BF16_BWD_LAUNCHES)
            (got,) = torch.autograd.grad(twp.repartition_windows(xw, hw, (7, 7), from_shift, not from_shift),
                                         xw, g)
            torch.cuda.synchronize()
            assert (twp.BWD_LAUNCHES, twp.BF16_BWD_LAUNCHES) == (before[0], before[1] + 1)
            ref = twp.repartition_windows_bwd_plain(g, hw, (7, 7), from_shift, not from_shift)
            assert got.dtype == BF16 and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [False, True])
def test_bf16_composition_masks_match_plain_on_card(shift):
    """The composition's mask kernels on bf16 tensors against their plain versions at rate
    0.1 (a scale not exact in bf16), forward and on the gradient, bit for bit, keeping the
    elements the fp32 masks keep; each direction one bf16 launch."""
    _need_card()
    gen = torch.Generator().manual_seed(int(shift) + 9)
    for hw, cols in (((28, 35), 24), ((21, 21), 1536)):
        key = dl.keying("k4", hw, (7, 7), shift, 8, 3, "cuda")
        x = torch.randn(2, 3, *hw, cols, generator=gen).cuda().to(BF16).requires_grad_()
        g = torch.randn(x.shape, generator=gen).cuda().to(BF16)
        before = (dm.BF16_TOKEN_LAUNCHES, dm.BF16_TOKEN_BWD_LAUNCHES, dm.TOKEN_LAUNCHES)
        out = dm.token_dropout(x, DROP_SEED, hd.SITE_MLP_OUT, 0.1, key)
        (got,) = torch.autograd.grad(out, x, g)
        torch.cuda.synchronize()
        assert (dm.BF16_TOKEN_LAUNCHES, dm.BF16_TOKEN_BWD_LAUNCHES, dm.TOKEN_LAUNCHES) == (
            before[0] + 1, before[1] + 1, before[2])
        ref = dm.token_dropout_plain(x, DROP_SEED, hd.SITE_MLP_OUT, 0.1, key)
        assert out.dtype == BF16 and torch.equal(out, ref)
        assert torch.equal(got, torch.autograd.grad(ref, x, g)[0])
        with torch.no_grad():
            fp32 = dm.token_dropout(x.float(), DROP_SEED, hd.SITE_MLP_OUT, 0.1, key)
        assert torch.equal(out, fp32.to(BF16))
    key = dl.keying("k4", (14, 21), (7, 7), shift, 8, 3, "cuda")
    weights = torch.rand(2, 3 * 6, 8, 49, 49, generator=gen).cuda().to(BF16)
    before = dm.BF16_ATTN_LAUNCHES
    out = dm.attention_dropout(weights, DROP_SEED, 0.1, key)
    torch.cuda.synchronize()
    assert dm.BF16_ATTN_LAUNCHES == before + 1
    assert torch.equal(out, dm.attention_dropout_plain(weights, DROP_SEED, 0.1, key))


def _stage_cases(hw, window=(7, 7)):
    """(stage, H, W, C, heads, d) of every attention stage of the default model at ``hw`` (its
    maps padded to ``window`` multiples)."""
    from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan

    cfg = ModelConfig()
    plan = make_plan(*hw, cfg.num_stages, cfg.merging_size, window)
    return [(k, *p.att_hw, cfg.out_dims_list[k], cfg.att_num_heads,
             cfg.dims_per_head(cfg.out_dims_list[k])) for k, p in enumerate(plan)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(512, 512), (100, 90)], ids=["512", "100x90"])
def test_k3_forward_matches_plain_at_every_stage_on_card(hw, dtype):
    """The forward without dropout (``csrc/window_attention_fwd.cu``: one launch at stages
    0-1, two at 2-4) against its plain version in all 20 stage x shift x cross cases of a
    request at ``hw``: fp32 within atol/rtol 1e-4 (fp32 sums of up to 384 terms in another
    order), bf16 by the share bound of the bf16 kernels; every call counted once in its
    dtype's counter and repeated bit for bit (no atomics, fixed sum orders)."""
    _need_card()
    counter = "BF16_LAUNCHES" if dtype == BF16 else "LAUNCHES"
    for k, h, w, c, heads, d in _stage_cases(hw):
        gen = torch.Generator().manual_seed(100 + k)
        inner = heads * d

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        args = (rand(2, 1, h, w, c).to(dtype), rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, inner, c, scale=inner**-0.5), rand(2, c, scale=0.1), rand(2, 49, 49))
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                before = getattr(twa, counter)
                out = twa.window_attention(*args, **kw)
                again = twa.window_attention(*args, **kw)
                torch.cuda.synchronize()
                assert getattr(twa, counter) == before + 2
                what = f"stage {k} {h}x{w} C={c} shift={shift} cross={cross}"
                assert torch.equal(out, again), f"{what}: a repeat gave other bits"
                ref = twa.window_attention_plain(*args, **kw)
                if dtype == BF16:
                    _assert_bf16_close(out, ref, what)
                else:
                    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4, msg=lambda m: f"{what}: {m}")


@pytest.mark.gpu
def test_k3_forward_plan_agrees_with_the_kernels_shared_memory():
    """The launch plan's shared-memory bytes (``ops/window_attention.py::attention_smem``,
    ``proj_smem``) are the ones the kernels' layouts give, at every stage in both dtypes
    and modes, with and without dropout, and within what a block may use: the 7x7 build's at
    7x7 windows, the any-window build's at 8x8, 4x4 and 7x8."""
    _need_card()
    for window in ((7, 7), (8, 8), (4, 4), (7, 8)):
        lib = twa._fwd_library(twa.window_class(window).build)
        for k, h, w, c, heads, d in _stage_cases((512, 512)):
            for bf16 in (False, True):
                for cross in (False, True):
                    for drop in (False, True):
                        plan = twa.fwd_plan(c, heads, d, window, cross, bf16, drop)
                        args = (int(bf16), int(plan.route == "fused"), int(cross), c, heads * d, heads, d,
                                plan.heads_per_block)
                        assert lib.swin_k3_fwd_smem(*args, 0, int(drop), *window) == plan.smem \
                            <= twa.SMEM_LIMIT_BYTES, (window, k, bf16, cross, drop)
                        if plan.route == "split":
                            assert lib.swin_k3_fwd_smem(*args, 1, int(drop), *window) == plan.proj_smem


def _check_k3_dropout_forward(hw, batch, dtype, stages, rate):
    """K3's dropout forward (``window_attention``: the dropout form of
    ``csrc/window_attention_fwd.cu``'s route, one launch at stages 0-1 and two at 2-4, as
    ``fwd_plan(..., drop=True)`` names it), the attention site at ``rate``, against its plain
    version and against the three launches of ``csrc/window_attention.cu`` with the same seed
    (``_launch_three``) in every stage x shift x cross case of ``stages`` at ``hw`` and
    ``batch``: fp32 within atol/rtol 1e-4, bf16 by the share bound of the bf16 kernels; each
    call counted once in its dtype's dropout counter and in no other, and repeated bit for
    bit."""
    counters = ("LAUNCHES", "BF16_LAUNCHES", "DROP_LAUNCHES", "BF16_DROP_LAUNCHES")
    counted = "BF16_DROP_LAUNCHES" if dtype == BF16 else "DROP_LAUNCHES"
    for k, h, w, c, heads, d in _stage_cases(hw):
        if k not in stages:
            continue
        gen = torch.Generator().manual_seed(600 + k)
        inner = heads * d

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        args = (rand(2, batch, h, w, c).to(dtype), rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, inner, c, scale=inner**-0.5), rand(2, c, scale=0.1), rand(2, 49, 49))
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift, cross=cross,
                          attn_drop_rate=rate, drop_seed=DROP_SEED + k)
                before = {n: getattr(twa, n) for n in counters}
                out = twa.window_attention(*args, **kw)
                again = twa.window_attention(*args, **kw)
                three = twa._launch_three(args[0], args[1:], kw)
                torch.cuda.synchronize()
                assert {n: getattr(twa, n) - b for n, b in before.items()} == {n: 2 * (n == counted) for n in counters}
                route = twa.fwd_plan(c, heads, d, (7, 7), cross, dtype == BF16, True).route
                what = f"stage {k} {h}x{w}x{batch} C={c} ({route}) shift={shift} cross={cross} rate={rate} {dtype}"
                assert torch.equal(out, again), f"{what}: a repeat gave other bits"
                ref = twa.window_attention_plain(*args, **kw)
                for other, name in ((ref, "plain"), (three, "three launches")):
                    if dtype == BF16:
                        _assert_bf16_close(out, other, f"{what} vs {name}")
                    else:
                        torch.testing.assert_close(out, other, atol=1e-4, rtol=1e-4,
                                                   msg=lambda m: f"{what} vs {name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("hw,batch,stages", [((224, 224), 2, range(5)), ((100, 90), 1, range(5)),
                                             ((512, 512), 1, (4,))], ids=["224x2", "100x90", "512-stage4"])
def test_k3_dropout_forward_matches_plain_and_three_launches_on_card(hw, batch, stages, rate, dtype):
    """K3's dropout forward at every stage of a 224² batch-2 step and a 100x90 map, and at the
    512² stage-4 shape (21², C = 384): the dropout form of the one-launch block at stages 0-1
    and of the split route at 2-4 (``_check_k3_dropout_forward``)."""
    _need_card()
    _check_k3_dropout_forward(hw, batch, dtype, stages, rate)


def _block_case(k, h, w, c, heads, d, hidden, dtype, batch=1):
    """x and the 17 weights of one fused block at a stage shape (LN scales near 1,
    He-scaled dense kernels, small biases, an N(0, 1) bias table)."""
    gen = torch.Generator().manual_seed(200 + k + hidden)
    inner = heads * d

    def rand(*shape, scale=1.0, offset=0.0):
        return (torch.randn(*shape, generator=gen) * scale + offset).cuda()

    def dense(i, o):
        return rand(2, i, o, scale=i**-0.5), rand(2, o, scale=0.1)

    return (rand(2, batch, h, w, c).to(dtype), rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
            *dense(c, inner), *dense(c, inner), *dense(c, inner), *dense(inner, c), rand(2, 49, 49),
            rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1), *dense(c, hidden), *dense(hidden, c))


def _check_block_forward(layout, hw, batch, dtype, stages, rate=0.0):
    """The forward (``csrc/fused_block_fwd.cu``; with every site at ``rate`` its dropout form)
    in ``layout`` against its plain version and against the five launches of
    ``csrc/fused_block.cu`` in every stage x MLP width (encoder, decoder) x shift x cross case of
    ``stages`` at ``hw`` and ``batch``: fp32 within atol/rtol 1e-4, bf16 by the share bound of
    the bf16 kernels; every call counted once in its dtype's (dropout) counter and repeated bit
    for bit."""
    cfg = ModelConfig()
    counter = ("BF16_" if dtype == BF16 else "") + ("DROP_LAUNCHES" if rate else "LAUNCHES")
    drop = dict(drop_rates=(rate,) * 3, drop_seed=DROP_SEED) if rate else {}
    for k, h, w, c, heads, d in _stage_cases(hw):
        if k not in stages:
            continue
        for hidden in (c * cfg.mlp_hidden_dims_ratio, cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio):
            x, *weights = _block_case(k, h, w, c, heads, d, hidden, dtype, batch)
            for shift in (False, True):
                for cross in (False, True):
                    xl = twp.pack_windows(x, (7, 7), shift).contiguous() if layout == "windows" else x
                    kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift,
                              cross=cross, layout=layout, hw=(h, w), **drop)
                    before = getattr(tfb, counter)
                    out = tfb.fused_block(xl, *weights, **kw)
                    again = tfb.fused_block(xl, *weights, **kw)
                    torch.cuda.synchronize()
                    assert getattr(tfb, counter) == before + 2
                    what = (f"{layout} stage {k} {h}x{w}x{batch} C={c} hidden={hidden} shift={shift} "
                            f"cross={cross} rate={rate}")
                    assert torch.equal(out, again), f"{what}: a repeat gave other bits"
                    five = tfb._launch_five(xl, weights, dict(kw, drop_rates=(rate,) * 3, drop_seed=DROP_SEED))
                    ref = tfb.fused_block_plain(xl, *weights, **kw)
                    for other, name in ((ref, "plain"), (five, "five launches")):
                        if dtype == BF16:
                            _assert_bf16_close(out, other, f"{what} vs {name}")
                        else:
                            torch.testing.assert_close(out, other, atol=1e-4, rtol=1e-4,
                                                       msg=lambda m: f"{what} vs {name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,batch", [((512, 512), 1), ((100, 90), 1), ((224, 224), 20)],
                         ids=["512", "100x90", "224x20"])
def test_k4_forward_matches_plain_and_five_launches_at_every_stage_on_card(hw, batch, dtype):
    """K4's forward without dropout (``csrc/fused_block_fwd.cu``: one launch at stages 0-1,
    six at 2-4) against its plain version and against the five launches of
    ``csrc/fused_block.cu`` in every stage x MLP width (encoder, decoder) x shift x cross
    case at ``hw`` and ``batch``: fp32 within atol/rtol 1e-4, bf16 by the share bound of the
    bf16 kernels; every call counted once in its dtype's counter and repeated bit for bit."""
    _need_card()
    _check_block_forward("image", hw, batch, dtype, range(5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,batch", [((512, 512), 1), ((100, 90), 1), ((224, 224), 20)],
                         ids=["512", "100x90", "224x20"])
def test_k1_forward_matches_plain_and_five_launches_at_every_stage_on_card(hw, batch, dtype):
    """K1's forward without dropout (``csrc/fused_block_fwd.cu`` on window-packed tokens, fp32
    inside in both dtypes: one launch at stages 0-1, six at 2-3) against its plain version
    and against the five launches of ``csrc/fused_block.cu`` at the stages ``cuda_pack``
    packs (0-3) in every MLP width x shift x cross case at ``hw`` and ``batch``: fp32 within
    atol/rtol 1e-4, bf16 by the share bound of the bf16 kernels; every call counted once in
    its dtype's counter and repeated bit for bit."""
    _need_card()
    _check_block_forward("windows", hw, batch, dtype, range(4))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("hw,batch,stages", [((224, 224), 2, range(4)), ((100, 90), 1, range(4)),
                                             ((448, 448), 1, (4,))], ids=["224x2", "100x90", "448-stage4"])
def test_block_dropout_forward_matches_plain_and_five_launches_at_every_stage_on_card(hw, batch, stages, rate,
                                                                                      dtype, layout):
    """K4's (image) and K1's (windows) dropout forward, every site at ``rate``: the dropout form
    of ``csrc/fused_block_fwd.cu``'s one-launch route at stages 0-1 and of its six launches at
    2-3 and at the C = 384 stage of a 448² map (``_check_block_forward``; K1 at stage 4 too,
    which ``cuda_pack`` leaves to K3)."""
    _need_card()
    _check_block_forward(layout, hw, batch, dtype, stages, rate)


@pytest.mark.gpu
def test_k4_forward_plan_agrees_with_the_kernels_shared_memory():
    """The launch plan's shared-memory bytes (``ops/fused_block.py::block_smem``) are the
    ones the kernels' layouts give, for every launch at every stage and MLP width in both
    dtypes, both layouts (K4's bf16 plan takes bf16 operands, K1's is the fp32 plan in both
    dtypes), both modes and both forms (without and with dropout), and within what a block may
    use."""
    _need_card()
    cfg = ModelConfig()
    lib = tfb._fwd_library()
    for k, h, w, c, heads, d in _stage_cases((512, 512)):
        for hidden in (c * cfg.mlp_hidden_dims_ratio, cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio):
            for layout in ("image", "windows"):
                for dtype in (torch.float32, BF16):
                    ops = tfb.rounds_operands(dtype, layout)
                    for cross in (False, True):
                        for drop in (False, True):
                            plan = tfb.block_fwd_plan(c, heads, d, hidden, (7, 7), cross, ops, drop)
                            for kind, smem in plan.smem:
                                got = lib.swin_k4_fwd_smem(tfb.KERNEL_KINDS.index(kind), int(ops), int(cross), c,
                                                           heads * d, heads, d, hidden, plan.heads_per_block,
                                                           plan.hidden_chunk, int(drop))
                                assert got == smem <= tfb.SMEM_LIMIT_BYTES, (k, hidden, layout, dtype, cross, drop,
                                                                             kind)


def _check_block_backward(layout, hw, batch, dtype, stages):
    """The backward without dropout (``_launch_bwd``: ``csrc/fused_block_bwd.cu`` where
    ``block_bwd_plan`` routes "fused" (stages 0-1), ``csrc/fused_block_bwd_split.cu`` where it
    routes "split" (stages 2-4)) in ``layout`` against the plain backward and
    against the five-launch backward (``_launch_bwd_five``) in every stage x MLP width x shift
    x cross case of ``stages`` at ``hw`` and ``batch``: every fp32 gradient by
    ``testing.assert_grads_close``, a bf16 g_x by the bf16 kernel criteria; each call counted
    once in its dtype's counter and repeated bit for bit (no atomics, fixed sum orders)."""
    cfg = ModelConfig()
    counter = "BF16_BWD_LAUNCHES" if dtype == BF16 else "BWD_LAUNCHES"
    for k, h, w, c, heads, d in _stage_cases(hw):
        if k not in stages:
            continue
        for hidden in (c * cfg.mlp_hidden_dims_ratio, cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio):
            x, *weights = _block_case(k, h, w, c, heads, d, hidden, dtype, batch)
            gen = torch.Generator().manual_seed(300 + k + hidden)
            for shift in (False, True):
                for cross in (False, True):
                    xl = twp.pack_windows(x, (7, 7), shift).contiguous() if layout == "windows" else x
                    g = torch.randn(xl.shape, generator=gen).cuda().to(dtype)
                    kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift,
                              cross=cross, layout=layout, hw=(h, w))
                    route = tfb.block_bwd_plan(c, heads, d, hidden, (7, 7), cross).route
                    assert route == ("fused" if k < 2 else "split"), (k, route)
                    before = getattr(tfb, counter)
                    got = tfb._launch_bwd(g, xl, weights, kw)
                    again = tfb._launch_bwd(g, xl, weights, kw)
                    five = tfb._launch_bwd_five(g, xl, weights, kw)
                    torch.cuda.synchronize()
                    assert getattr(tfb, counter) == before + 2
                    what = (f"{layout} stage {k} {h}x{w}x{batch} C={c} hidden={hidden} ({route}) shift={shift} "
                            f"cross={cross} {dtype}")
                    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: a repeat gave other bits"
                    ref = tfb.fused_block_bwd_plain(g, xl, *weights, **kw)
                    for other, name in ((ref, "plain"), (five, "five launches")):
                        if dtype == BF16:
                            _assert_bf16_close(got[0], other[0], f"{what} g_x vs {name}")
                            assert_grads_close(got[1:], other[1:], tfb.WEIGHT_NAMES, f"{what} vs {name}")
                        else:
                            assert_grads_close(got, other, ("x", *tfb.WEIGHT_NAMES), f"{what} vs {name}")


def _check_block_backward_drop(layout, hw, batch, dtype, stages):
    """The backward's dropout form (``_launch_bwd`` with every site at rate 0.1 and at 0.5: the
    fused route's at stages 0-1, the split route's at 2-4) in ``layout`` against the plain dropout
    backward and against the twenty-launch dropout backward (``_launch_bwd_five``) in every stage x MLP width x shift x cross case of
    ``stages`` at ``hw`` and ``batch``: every fp32 gradient by ``testing.assert_grads_close``,
    a bf16 g_x by the bf16 kernel criteria; each call counted once in its dtype's dropout
    counter and repeated bit for bit."""
    cfg = ModelConfig()
    counter = "BF16_DROP_BWD_LAUNCHES" if dtype == BF16 else "DROP_BWD_LAUNCHES"
    for k, h, w, c, heads, d in _stage_cases(hw):
        if k not in stages:
            continue
        hidden = c * cfg.mlp_hidden_dims_ratio
        x, *weights = _block_case(k, h, w, c, heads, d, hidden, dtype, batch)
        gen = torch.Generator().manual_seed(400 + k + hidden)
        for rate in (0.1, 0.5):
            for shift in (False, True):
                for cross in (False, True):
                    xl = twp.pack_windows(x, (7, 7), shift).contiguous() if layout == "windows" else x
                    g = torch.randn(xl.shape, generator=gen).cuda().to(dtype)
                    kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift, cross=cross,
                              layout=layout, hw=(h, w), drop_rates=(rate,) * 3, drop_seed=DROP_SEED + k)
                    route = tfb.block_bwd_plan(c, heads, d, hidden, (7, 7), cross, True).route
                    assert route == ("fused" if k < 2 else "split"), (k, route)
                    before = getattr(tfb, counter)
                    got = tfb._launch_bwd(g, xl, weights, kw)
                    again = tfb._launch_bwd(g, xl, weights, kw)
                    five = tfb._launch_bwd_five(g, xl, weights, kw)
                    torch.cuda.synchronize()
                    assert getattr(tfb, counter) == before + 2
                    what = (f"{layout} stage {k} {h}x{w}x{batch} C={c} ({route}) rate={rate} shift={shift} "
                            f"cross={cross} {dtype}")
                    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: a repeat gave other bits"
                    ref = tfb.fused_block_bwd_plain(g, xl, *weights, **kw)
                    for other, name in ((ref, "plain"), (five, "twenty launches")):
                        if dtype == BF16:
                            _assert_bf16_close(got[0], other[0], f"{what} g_x vs {name}")
                            assert_grads_close(got[1:], other[1:], tfb.WEIGHT_NAMES, f"{what} vs {name}")
                        else:
                            assert_grads_close(got, other, ("x", *tfb.WEIGHT_NAMES), f"{what} vs {name}")


# (map, batch, stages) of the block backward's card checks: every stage of a 224² batch-2 step
# and of a 100x90 map, and stage 4 (C = 384, 14x14) of a 448² step at batch 5 (a block a
# 49-token tile of the stepped MLP backward and the grouped g_ln product) and batch 20 (80
# tiles a stream: their blocks walk several tiles each)
BLOCK_BWD_MAPS = [((224, 224), 2, range(5)), ((100, 90), 1, range(5)), ((448, 448), 5, (4,)), ((448, 448), 20, (4,))]
BLOCK_BWD_IDS = ["224x2", "100x90", "448x5-stage4", "448x20-stage4"]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,batch,stages", [((224, 224), 2, range(4)), ((100, 90), 1, range(4)),
                                             ((448, 448), 5, (4,)), ((448, 448), 20, (4,))], ids=BLOCK_BWD_IDS)
def test_block_dropout_backward_matches_plain_and_twenty_launches_at_every_stage_on_card(hw, batch, stages, dtype,
                                                                                         layout):
    """K4's (image) and K1's (windows) dropout backward at stages 0-3 and at the 448² stage 4
    (batch 5 and 20), the dropout form of the fused route at stages 0-1 and of the split route
    at 2-4 (``_check_block_backward_drop``)."""
    _need_card()
    _check_block_backward_drop(layout, hw, batch, dtype, stages)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,batch,stages", BLOCK_BWD_MAPS, ids=BLOCK_BWD_IDS)
def test_k4_backward_matches_plain_and_five_launch_backward_at_every_stage_on_card(hw, batch, stages, dtype):
    """K4 bwd (the image layout) at every stage: the fused route of
    ``csrc/fused_block_bwd.cu`` at stages 0-1, the split route of
    ``csrc/fused_block_bwd_split.cu`` at 2-4 (``_check_block_backward``)."""
    _need_card()
    _check_block_backward("image", hw, batch, dtype, stages)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,batch,stages", [((224, 224), 2, range(4)), ((100, 90), 1, range(4)),
                                             ((448, 448), 5, (4,)), ((448, 448), 20, (4,))], ids=BLOCK_BWD_IDS)
def test_k1_backward_matches_plain_and_five_launch_backward_at_every_stage_on_card(hw, batch, stages, dtype):
    """K1 bwd (window-packed tokens) at the stages ``cuda_pack`` packs (0-3), and at the 448²
    stage 4 that the split route also takes in the windows layout: the fused route at stages
    0-1, the split route at 2-4 (``_check_block_backward``)."""
    _need_card()
    _check_block_backward("windows", hw, batch, dtype, stages)


@pytest.mark.gpu
def test_block_backward_plan_agrees_with_the_kernels_on_card():
    """The backward plan's shared memory (``bwd_smem``, ``split_smem``) and workspace
    (``bwd_workspace_floats``, ``split_workspace_floats``) are the ones
    ``csrc/fused_block_bwd.cu`` and ``csrc/fused_block_bwd_split.cu`` compute, at every fused-route and split-route stage and MLP
    width of a 224² batch-20 step in both modes, without and with dropout (whose blocks add the
    masks' hashes and keep words and whose workspace adds g_m, g_proj and the keep words); the
    split route's recomputed attention and K3 block, with and without dropout, take the shared
    memory that the forward's and K3's backward's libraries give them."""
    _need_card()
    cfg = ModelConfig()
    lib = tfb._bwd_library()
    sms = tfb._sm_count(torch.device("cuda"))
    for k, h, w, c, heads, d in _stage_cases((224, 224)):
        for hidden in (c * cfg.mlp_hidden_dims_ratio, cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio):
            for cross in (False, True):
                for drop in (False, True):
                    plan = tfb.block_bwd_plan(c, heads, d, hidden, (7, 7), cross, drop)
                    what = (k, hidden, cross, drop)
                    if plan.route == "split":
                        hg_fwd, hg_bwd = plan.heads_per_block
                        split = tfb._split_library()
                        for kind, (kernel, smem) in enumerate(plan.smem):
                            got = split.swin_block_bwd_split_smem(kind, c, heads, d, hidden, plan.hidden_chunk,
                                                                hg_fwd, hg_bwd, int(cross), int(drop))
                            assert got == smem <= tfb.SMEM_LIMIT_BYTES, (*what, kernel)
                        smem = dict(plan.smem)
                        assert smem["attention"] == tfb._fwd_library().swin_k4_fwd_smem(
                            1, 0, int(cross), c, heads * d, heads, d, hidden, hg_fwd, tfb.max_cols(False), int(drop))
                        assert smem["attention_bwd"] == twa._bwd_library().swin_k3_bwd_smem(
                            0, 0, int(cross), c, heads, d, hg_bwd, int(drop), 7, 7)
                        blocks = plan.blocks(2, 20, h, w, sms)
                        assert split.swin_block_bwd_split_workspace(2, 20, h, w, c, heads, d, hidden,
                                                                    plan.hidden_chunk, hg_bwd, *blocks,
                                                                    int(drop)) == \
                            tfb.split_workspace_floats(2, 20, h, w, c, heads, d, hidden, plan, blocks, drop), what
                    if plan.route != "fused":
                        continue
                    for kind, (kernel, smem) in enumerate(plan.smem):
                        got = lib.swin_block_bwd_smem(kind, c, heads, d, hidden, plan.hidden_chunk, int(cross),
                                                      int(drop))
                        assert got == smem <= tfb.SMEM_LIMIT_BYTES, (*what, kernel)
                    blocks = plan.blocks(2, 20, h, w, sms)
                    assert lib.swin_block_bwd_workspace(2, 20, h, w, c, heads, d, hidden, *blocks, int(cross),
                                                        int(drop)) == \
                        tfb.bwd_workspace_floats(2, 20, h, w, c, heads, d, hidden, blocks, cross, drop), what


def _check_k3_backward(hw, batch, dtype, stages, rate=0.0):
    """K3's backward (``_launch_bwd``: ``csrc/window_attention_bwd.cu`` on the route
    ``bwd_plan`` names; with the attention site at ``rate`` its dropout form) against the plain
    backward and against the three-launch backward of ``csrc/window_attention.cu``
    (``_launch_bwd_three``) in every stage x shift x cross case of ``stages`` at ``hw`` and
    ``batch``: every fp32 gradient by ``testing.assert_grads_close``, a bf16 g_x by the bf16
    kernel criteria; each call counted once in its dtype's (dropout) counter and repeated bit
    for bit (no atomics, fixed sum orders)."""
    counter = ("BF16_" if dtype == BF16 else "") + ("DROP_BWD_LAUNCHES" if rate else "BWD_LAUNCHES")
    drop = dict(attn_drop_rate=rate, drop_seed=DROP_SEED) if rate else {}
    for k, h, w, c, heads, d in _stage_cases(hw):
        if k not in stages:
            continue
        gen = torch.Generator().manual_seed(400 + k)
        inner = heads * d

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        x = rand(2, batch, h, w, c).to(dtype)
        weights = (rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                   rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                   rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                   rand(2, inner, c, scale=inner**-0.5), rand(2, c, scale=0.1), rand(2, 49, 49))
        g = rand(2, batch, h, w, c).to(dtype)
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift, cross=cross, **drop)
                before = getattr(twa, counter)
                got = twa._launch_bwd(g, x, weights, kw)
                again = twa._launch_bwd(g, x, weights, kw)
                three = twa._launch_bwd_three(g, x, weights, kw)
                torch.cuda.synchronize()
                assert getattr(twa, counter) == before + 2
                route = twa.bwd_plan(c, heads, d, (7, 7), cross, dtype == BF16, bool(rate)).route
                what = f"stage {k} {h}x{w}x{batch} C={c} ({route}) shift={shift} cross={cross} rate={rate} {dtype}"
                assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: a repeat gave other bits"
                ref = twa.window_attention_bwd_plain(g, x, *weights, **kw)
                for other, name in ((ref, "plain"), (three, "three launches")):
                    if dtype == BF16:
                        assert got[0].dtype == BF16, what
                        _assert_bf16_close(got[0], other[0], f"{what} g_x vs {name}")
                        assert_grads_close(got[1:], other[1:], ATTENTION_NAMES[1:], f"{what} vs {name}")
                    else:
                        assert_grads_close(got, other, ATTENTION_NAMES, f"{what} vs {name}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw,batch,stages", [((224, 224), 2, range(5)), ((100, 90), 1, range(5)),
                                             ((512, 512), 1, (4,)), ((448, 448), 5, (4,))],
                         ids=["224x2", "100x90", "512-stage4", "448x5-stage4"])
def test_k3_backward_matches_plain_and_three_launch_backward_on_card(hw, batch, stages, dtype):
    """K3 bwd at every stage of a 224² batch-2 step and a 100x90 map, and at the 512² and 448²
    batch-5 stage-4 shapes (21² and 14², C = 384, d = 48 on the tiled core): the fused route at
    stages 0-1, the split route at 2-4 (``_check_k3_backward``)."""
    _need_card()
    _check_k3_backward(hw, batch, dtype, stages)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("hw,batch,stages", [((224, 224), 2, range(5)), ((100, 90), 1, range(5)),
                                             ((512, 512), 1, (4,)), ((448, 448), 5, (4,))],
                         ids=["224x2", "100x90", "512-stage4", "448x5-stage4"])
def test_k3_dropout_backward_matches_plain_and_three_launch_backward_on_card(hw, batch, stages, rate, dtype):
    """K3's dropout backward, the attention site at ``rate``: the dropout form of the fused
    route at stages 0-1 and of the split route at 2-4 (``_check_k3_backward``)."""
    _need_card()
    _check_k3_backward(hw, batch, dtype, stages, rate)


@pytest.mark.gpu
def test_k3_backward_plan_agrees_with_the_kernels_on_card():
    """The backward plan's shared memory (``bwd_smem``, ``gx_smem``) and workspace
    (``bwd_workspace_floats``) are the ones ``csrc/window_attention_bwd.cu`` computes, at every
    stage of a 224² and a 512² batch-20 step in both modes, without and with dropout (whose
    block adds its heads' keep words; the workspace is the same)."""
    _need_card()
    sms = twa._sm_count(torch.device("cuda"))
    for window in ((7, 7), (8, 8), (4, 4), (7, 8)):  # the 7x7 build, then the any-window build
        lib = twa._bwd_library(twa.window_class(window).build)
        for hw in ((224, 224), (512, 512)):
            for k, h, w, c, heads, d in _stage_cases(hw, window):
                for cross in (False, True):
                    for drop in (True, False):
                        plan = twa.bwd_plan(c, heads, d, window, cross, False, drop)
                        fused, hg = int(plan.route == "fused"), plan.heads_per_block
                        for kind, (kernel, smem) in enumerate(plan.smem):
                            got = lib.swin_k3_bwd_smem(kind, fused, int(cross), c, heads, d, hg, int(drop), *window)
                            assert got == smem <= twa.SMEM_LIMIT_BYTES, (window, hw, k, cross, drop, kernel)
                    blocks = plan.blocks(2, 20, h, w, heads, sms)
                    assert lib.swin_k3_bwd_workspace(2, 20, h, w, c, heads, d, hg, fused, blocks, int(cross),
                                                     *window) == \
                        twa.bwd_workspace_floats(2, 20, h, w, c, heads, d, plan, blocks, cross)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("from_shift", [False, True], ids=["to_shifted", "to_normal"])
def test_k2_halo_form_matches_the_whole_map_on_card(dtype, from_shift):
    """K2's halo form (one launch of ``swin_repartition_halo_fwd`` a band, the halo row read in
    place) against the plain form and the whole map's launch, bit for bit, at 2 and 3 bands of
    a 63x35 map (an uneven last band) with 16-, 4- and 2-byte pieces (C = 8 and 3)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd
    from swin_unet_image_fusion_tpu_torch.parallel.spatial import split_rows

    _need_card()
    hw, (nh, nw) = (63, 35), (9, 5)
    for c in (8, 3):
        x = torch.randn(2, 2, nh * nw, 49, c, generator=torch.Generator().manual_seed(c)).to("cuda", dtype)
        whole = twp.repartition_windows(x, hw, (7, 7), from_shift, not from_shift)
        side = spmd.halo_side(from_shift, not from_shift)
        for bands in (2, 3):
            for lo, hi in split_rows(nh, bands):
                row = (lo - 1) % nh if side < 0 else hi % nh
                part, halo = x[:, :, lo * nw:hi * nw].contiguous(), x[:, :, row * nw:(row + 1) * nw].contiguous()
                before = spmd.BF16_HALO_LAUNCHES if dtype == BF16 else spmd.HALO_LAUNCHES
                out = spmd.repartition_halo(part, halo, hw, (7, 7), from_shift, not from_shift)
                after = spmd.BF16_HALO_LAUNCHES if dtype == BF16 else spmd.HALO_LAUNCHES
                assert after == before + 1
                assert torch.equal(out, whole[:, :, lo * nw:hi * nw])
                assert torch.equal(out, spmd.repartition_halo_plain(part, halo, hw, (7, 7), from_shift,
                                                                    not from_shift))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
def test_token_mask_forms_match_plain_on_card(dtype):
    """The token mask kernel in each of its vector widths (16 bytes, 8 bytes and one element:
    cols 24, 4 and 6, and a pointer 4 bytes off 16), in place (``out`` = ``in``, as
    ``fused_block.cu``'s backward launches it) and its first form, bit for bit against the
    plain version."""
    from swin_unet_image_fusion_tpu_torch.ops import _build

    _need_card()
    key = dl.keying("k4", (14, 21), (7, 7), True, 8, 3, "cuda")
    lib = dm._library()
    for cols in (24, 4, 6):
        x = torch.randn(2, 3, 14, 21, cols, generator=torch.Generator().manual_seed(cols)).to("cuda", dtype)
        ref = dm.token_dropout_plain(x, DROP_SEED, hd.SITE_MLP_OUT, 0.5, key)
        assert torch.equal(dm.token_dropout(x, DROP_SEED, hd.SITE_MLP_OUT, 0.5, key), ref)
        first = dm._token_launch(lib.swin_dropout_tokens_elementwise, x, DROP_SEED, hd.SITE_MLP_OUT, 0.5, key)
        assert torch.equal(first, ref)
        shifted = torch.empty(x.numel() + 8, dtype=dtype, device="cuda")
        offset = 4 // x.element_size()  # 4 bytes off the allocation's alignment
        inplace = shifted[offset:offset + x.numel()].view(x.shape)
        inplace.copy_(x)
        args = dm._site_args(key, hd.SITE_MLP_OUT, 0.5, DROP_SEED)
        rc = lib.swin_dropout_tokens(inplace.data_ptr(), inplace.data_ptr(), dl.drop_pointer(args),
                                     hd.SITES.index(hd.SITE_MLP_OUT), 2, 3, 14 * 21, cols,
                                     int(dtype == BF16), torch.cuda.current_stream().cuda_stream)
        _build.check_launch(lib, rc, "token dropout mask")
        assert torch.equal(inplace, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_activation_forms_match_plain_on_card(activation, layout, dtype):
    """K4's (image) and K1's (windows) relu and gelu forms at stages 0 (one launch) and 2 (the
    split route) of a 224² batch-2 step, shift and cross: the forward against its plain version
    (fp32 within atol/rtol 1e-4, bf16 by the share bound) and, under gelu in fp32, the backward
    against the plain backward (the erf form, as the TPU kernels'), each counted once in its
    activation's counter and repeated bit for bit. ``chip_smoke.py``'s ``[act]`` phase holds
    relu's backward, whose derivative jumps at 0, with the cotangent zeroed near it."""
    _need_card()
    for k, h, w, c, heads, d in _stage_cases((224, 224)):
        if k not in (0, 2):
            continue
        hidden = 4 * c
        x, *weights = _block_case(k, h, w, c, heads, d, hidden, dtype, 2)
        xl = twp.pack_windows(x, (7, 7), True).contiguous() if layout == "windows" else x
        kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=True, cross=True, layout=layout,
                  hw=(h, w), activation=activation)
        what = f"{activation} {layout} stage {k} {dtype}"
        before = tfb.ACTIVATION_LAUNCHES[activation]
        out, again = tfb.fused_block(xl, *weights, **kw), tfb.fused_block(xl, *weights, **kw)
        torch.cuda.synchronize()
        assert tfb.ACTIVATION_LAUNCHES[activation] == before + 2
        assert torch.equal(out, again), f"{what}: a repeat gave other bits"
        ref = tfb.fused_block_plain(xl, *weights, **kw)
        if dtype == BF16:
            _assert_bf16_close(out, ref, what)
            continue
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4, msg=lambda m: f"{what}: {m}")
        if activation == "gelu":
            g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(k)).cuda()
            got, again = tfb._launch_bwd(g, xl, weights, kw), tfb._launch_bwd(g, xl, weights, kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: a backward repeat gave other bits"
            assert_grads_close(got, tfb.fused_block_bwd_plain(g, xl, *weights, **kw), ("x", *tfb.WEIGHT_NAMES),
                               f"{what} bwd")
