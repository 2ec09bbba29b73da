"""The port's loss, schedule, optimiser and train step against the JAX package.

- ``total_fusion_loss`` (MS-SSIM + L1, Sobel texture, max-intensity L1; the single-scale
  SSIM and PSNR options) and its gradient with respect to the fused image, against the
  JAX function: values rtol 1e-5, gradients rtol 1e-4 with atol 1e-5 x their largest
  magnitude (exact fp32 on both sides, sums in another order).
- the cosine warm-restart schedule at counts 0 .. 3 epochs (rtol 1e-6: JAX computes it
  in float32), one Adam step and the global-norm clip against optax.
- one train step of the tiny model from the same numpy weights, the port under
  ``torch`` and ``cuda_pack`` (plain versions on the CPU) against JAX
  ``make_train_step`` under ``jnp`` and ``pallas_pack_interpret``: the loss terms
  (rtol 1e-5), every parameter's gradient (rtol 1e-3, atol 1e-4 x its own largest
  magnitude, floored at 1e-8 of the step's largest, or x the step's largest for the
  gradients that are exactly 0: ``testing.assert_grads_close``), the updated BatchNorm
  statistics (rtol 1e-5) and the updated parameters. Adam's first step moves each
  parameter by the learning rate times the sign of its gradient, so where a gradient is
  rounding noise (below 1e-4 x the largest) its sign may differ and the parameters may
  differ by up to twice the learning rate; elsewhere they agree to 1e-6.

About 140 s in one process (the JAX interpret-mode train step takes 95 s of it).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import losses as jlosses
from swin_unet_image_fusion_tpu import optim as joptim
from swin_unet_image_fusion_tpu import train as jtrain
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig, losses, optim
from swin_unet_image_fusion_tpu_torch.config import LossConfig, OptimConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_to_jax
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_eval_step, make_train_step

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
LR = 1e-3
ITERS = 10


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, dtype=np.float32) for _ in range(3)]


LOSS_CASES = {
    "ms_ssim_sobel": {},
    "ssim_psnr": dict(choose_ms_ssim=False, use_psnr=True, psnr_scale=0.1, psnr_loss_ratio=0.25),
}


@pytest.mark.parametrize("options", LOSS_CASES.values(), ids=LOSS_CASES.keys())
def test_total_loss_and_its_gradient_match_jax(options):
    fusion, ir, vis = _images((2, 40, 36, 1), seed=1)
    jax_cfg, port_cfg = jcfg.LossConfig(**options), LossConfig(**options)

    def jax_total(f):
        return jlosses.total_fusion_loss(jax_cfg, f, jnp.asarray(ir), jnp.asarray(vis))

    (_, ref_terms), ref_grad = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(fusion))
    ft = torch.from_numpy(fusion).requires_grad_()
    total, terms = losses.total_fusion_loss(port_cfg, ft, torch.from_numpy(ir), torch.from_numpy(vis))
    total.backward()
    assert set(terms) == set(ref_terms)
    for name, value in terms.items():
        assert value.ndim == 0
        np.testing.assert_allclose(value.item(), float(ref_terms[name]), rtol=1e-5, err_msg=name)
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(ft.grad.numpy(), ref_grad, rtol=1e-4, atol=1e-5 * np.abs(ref_grad).max())


def test_canny_texture_is_not_ported_and_raises():
    """The Canny texture term was not ported and raised; it is ported now, and equals the
    JAX term (tests/test_torch_canny.py holds Canny itself)."""
    fusion, ir, vis = _images((1, 14, 14, 1), seed=2)
    ref = jlosses.texture_term(jcfg.LossConfig(choose_canny_else_sobel=True), *map(jnp.asarray, (fusion, ir, vis)))
    got = losses.texture_term(LossConfig(choose_canny_else_sobel=True), *map(torch.from_numpy, (fusion, ir, vis)))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_schedule_matches_jax_over_three_epochs():
    iters = 7
    ref = joptim.cosine_warm_restarts_schedule(1e-2, 1e-5, 2, iters)
    port = optim.cosine_warm_restarts_schedule(1e-2, 1e-5, 2, iters)
    counts = np.arange(3 * iters + 1)
    np.testing.assert_allclose([port(int(n)) for n in counts],
                               np.asarray(jax.vmap(ref)(jnp.asarray(counts))), rtol=1e-6)
    assert port(0) == port(1) == 1e-2  # the reference's off-by-one: updates 0 and 1 share t = 0


def test_adam_step_and_clip_match_optax():
    rng = np.random.default_rng(3)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 5), (7,))]
    grads = [rng.standard_normal(p.shape).astype(np.float32) * 3 for p in params]
    for clip in (0.0, 1.0):
        tx = joptim.make_optimizer(jcfg.OptimConfig(lr=LR, grad_clip_norm=clip), ITERS)
        state = tx.init([jnp.asarray(p) for p in params])
        updates, _ = tx.update([jnp.asarray(g) for g in grads], state)
        ref = [np.asarray(optax.apply_updates(jnp.asarray(p), u)) for p, u in zip(params, updates)]
        tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
        tgrads = [torch.from_numpy(g.copy()) for g in grads]
        if clip:
            optim.clip_by_global_norm_(tgrads, clip)
        opt = optim.make_optimizer(tparams, OptimConfig(lr=LR))
        for p, g in zip(tparams, tgrads):
            p.grad = g
        opt.param_groups[0]["lr"] = optim.cosine_warm_restarts_schedule(LR, 1e-5, 20, ITERS)(0)
        opt.step()
        for p, r in zip(tparams, ref):
            np.testing.assert_allclose(p.detach().numpy(), r, rtol=1e-6, atol=1e-7)


@functools.lru_cache(maxsize=None)
def _jax_step(jax_impl):
    """JAX's step-1 terms, gradients, batch_stats and params from the tiny weights."""
    flat = random_variables(ModelConfig(**TINY), seed=21)
    ir, vis = _images((2, 28, 28, 1), seed=22)[:2]
    cfg = jcfg.Config(model=jcfg.ModelConfig(**TINY, attention_impl=jax_impl),
                      optim=jcfg.OptimConfig(lr=LR))
    variables = unflatten_dict(flat, sep="/")
    model = JaxUNet(cfg.model)
    state = jtrain.TrainState.create(apply_fn=model.apply, params=variables["params"],
                                     tx=joptim.make_optimizer(cfg.optim, ITERS),
                                     batch_stats=variables["batch_stats"])
    irj, visj = jnp.asarray(ir), jnp.asarray(vis)

    def loss_fn(params):
        fusion, _ = model.apply({"params": params, "batch_stats": state.batch_stats}, irj, visj,
                                train=True, mutable=["batch_stats"])
        return jlosses.total_fusion_loss(cfg.loss, jnp.clip(fusion, 0.0, 1.0), irj, visj)[0]

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    new_state, terms = jtrain.make_train_step(cfg, donate=False)(state, irj, visj)
    prefixed = lambda tree, c: {f"{c}/{k}": np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}
    return (flat, ir, vis, {k: float(v) for k, v in terms.items()}, prefixed(grads, "params"),
            prefixed(new_state.batch_stats, "batch_stats"), prefixed(new_state.params, "params"))


@pytest.mark.parametrize("impl,jax_impl", [("torch", "jnp"), ("cuda_pack", "pallas_pack_interpret")])
def test_tiny_train_step_matches_jax(impl, jax_impl):
    flat, ir, vis, ref_terms, ref_grads, ref_stats, ref_params = _jax_step(jax_impl)
    cfg = Config(model=ModelConfig(**TINY, attention_impl=impl), optim=OptimConfig(lr=LR))
    state = create_train_state(cfg, flat, ITERS, device="cpu")
    terms = make_train_step(cfg)(state, torch.from_numpy(ir), torch.from_numpy(vis))
    assert (state.step, state.updates) == (1, 1)
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), ref_terms[name], rtol=1e-5, err_msg=name)

    grads = variables_to_jax({n: p.grad for n, p in state.model.named_parameters()})
    assert set(grads) == set(ref_grads)
    assert_grads_close([torch.tensor(grads[n]) for n in ref_grads],
                       [torch.tensor(g) for g in ref_grads.values()], list(ref_grads))
    scale = max(np.abs(g).max() for g in ref_grads.values())

    new = variables_to_jax(state.model.state_dict())
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(new[name], ref, rtol=1e-5, atol=1e-7, err_msg=name)
    for name, ref in ref_params.items():
        noise = np.abs(ref_grads[name]) < 1e-4 * scale
        np.testing.assert_allclose(new[name][~noise], ref[~noise], rtol=0, atol=1e-6, err_msg=name)
        assert (np.abs(new[name][noise] - ref[noise]) <= 2 * LR + 1e-6).all(), name


def test_eval_step_clamps_and_nonfinite_step_is_skipped():
    cfg = Config(model=ModelConfig(**TINY), optim=OptimConfig(lr=LR, skip_nonfinite_updates=True))
    state = create_train_state(cfg, random_variables(ModelConfig(**TINY), seed=23), ITERS, device="cpu")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ir, vis = (torch.from_numpy(a) for a in _images((1, 14, 14, 1), seed=24)[:2])
    fusion, _ = make_eval_step(cfg)(state, ir, vis)
    assert fusion.shape == ir.shape and 0.0 <= fusion.min() and fusion.max() <= 1.0
    bad = ir.clone()
    bad[0, 0, 0, 0] = float("nan")
    terms = make_train_step(cfg)(state, bad, vis)
    assert not torch.isfinite(terms["total_loss"])
    assert (state.step, state.updates) == (1, 0)
    for name, value in state.model.state_dict().items():
        if not name.startswith("final_head.bn."):  # as in JAX, the statistics take the batch's
            assert torch.equal(value, before[name]), name


def test_training_with_dropout_or_remat_raises():
    """Dropout trains (``test_torch_dropout_model.py``), and so does bf16 with or without
    dropout (``test_torch_bf16_train.py``): the step runs and updates the fp32
    parameters. So does rematerialisation (its gradients against the step without it:
    ``test_torch_train_guards.py``); none of them raises."""
    ir = torch.zeros(1, 14, 14, 1)
    for field in ({"compute_dtype": "bfloat16"}, {"compute_dtype": "bfloat16", "mlp_drop_ratio": 0.1}):
        cfg = Config(model=ModelConfig(**TINY, **field))
        state = create_train_state(cfg, random_variables(ModelConfig(**TINY), seed=25), ITERS,
                                   device="cpu")
        terms = make_train_step(cfg)(state, ir, ir)
        assert torch.isfinite(terms["total_loss"]) and (state.step, state.updates) == (1, 1)
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
    cfg = Config(model=ModelConfig(**TINY, remat=True))
    state = create_train_state(cfg, random_variables(ModelConfig(**TINY), seed=25), ITERS,
                               device="cpu")
    terms = make_train_step(cfg)(state, ir, ir)
    assert torch.isfinite(terms["total_loss"]) and (state.step, state.updates) == (1, 1)


def test_create_train_state_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(Config(model=ModelConfig(**TINY)), random_variables(ModelConfig(**TINY), 0),
                           ITERS)


def test_variables_round_trip_through_jax_naming():
    model_cfg = dataclasses.replace(ModelConfig(**TINY))
    flat = random_variables(model_cfg, seed=26)
    state = create_train_state(Config(model=model_cfg), flat, ITERS, device="cpu")
    back = variables_to_jax(state.model.state_dict())
    assert set(back) == set(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
