"""Dropout training of the tiny model: the port against the JAX package, and the
statistics of the composition's masks.

- JAX's per-block seeds are pinned by wrapping the kernels' entry points
  (``test_torch_dropout.pinned_seeds``) and fed to the port as a sequence. Every active
  JAX site must be in a kernel, so: all three ratios under ``cuda_block`` against
  ``pallas_block_interpret`` (forward and one train step: loss terms, every gradient, the
  BatchNorm statistics), and the attention ratio alone under ``cuda`` against
  ``pallas_interpret`` and ``cuda_pack`` against ``pallas_pack_interpret`` (forward). The
  port's composition (``torch``) keys its masks on K4's geometry, so it is held to
  ``pallas_block_interpret`` as well. The port leaves no stage to the composition
  (``attention_jnp_max_tokens=None``): the JAX interpret routes are never gated.
  Forward atol 2e-4, rtol 1e-3 (``tests/test_model_parity.py``); loss terms rtol 1e-5;
  gradients by ``testing.assert_grads_close`` (``tests/test_torch_train.py``).
- Statistics, as ``tests/test_hash_dropout.py`` holds the JAX masks: the keep fraction of
  the composition's sites within a binomial bound, the inverted expectation, no dropout
  in eval, the same masks for the same seeds and other masks for others, and no change
  at every ratio 0.

About 175 s in one process (the JAX interpret-mode train step takes 120 s of it).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import losses as jlosses
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig, SwinFusionUNet
from swin_unet_image_fusion_tpu_torch.config import OptimConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import (
    random_variables,
    variables_from_jax,
    variables_to_jax,
)
from swin_unet_image_fusion_tpu_torch.models.layers import token_dropout
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step
from test_torch_dropout import pinned_seeds

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2, attention_jnp_max_tokens=None)
RATIO = 0.2
ALL_SITES = dict(attention_drop_ratio=RATIO, linear_after_att_drop_ratio=RATIO,
                 mlp_drop_ratio=RATIO)
ATTENTION = dict(attention_drop_ratio=RATIO)
ATOL, RTOL = 2e-4, 1e-3
LR, ITERS = 1e-3, 10
HW = (28, 28)
BLOCKS = 16  # 2 stages x (encoder + decoder) x 4 blocks
SEEDS = [(1_000_003 * (i + 1)) % (1 << 24) for i in range(BLOCKS)]
ENTRY_POINTS = [(jpb, "pallas_fused_block"), (jpa, "pallas_window_attention"),
                (jpp, "pallas_packed_block_strips")]


def _jax_cfg(impl, ratios):
    return jcfg.Config(model=jcfg.ModelConfig(**TINY, **ratios, attention_impl=impl),
                       optim=jcfg.OptimConfig(lr=LR))


@functools.lru_cache(maxsize=None)
def _inputs():
    flat = random_variables(ModelConfig(**TINY), seed=41)
    rng = np.random.default_rng(42)
    ir, vis = (rng.random((2, *HW, 1), dtype=np.float32) for _ in range(2))
    return flat, ir, vis


@functools.lru_cache(maxsize=None)
def _jax_run(impl, ratios, grads):
    """JAX's train-mode output (and with ``grads`` the loss terms, the gradients and the
    updated BatchNorm statistics) with the blocks' seeds pinned to SEEDS."""
    ratios = dict(ratios)
    flat, ir, vis = _inputs()
    cfg = _jax_cfg(impl, ratios)
    model = JaxUNet(cfg.model)
    variables = unflatten_dict(flat, sep="/")
    irj, visj = jnp.asarray(ir), jnp.asarray(vis)

    def loss_fn(params):
        fusion, mutated = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                      irj, visj, train=True, mutable=["batch_stats"],
                                      rngs={"dropout": jax.random.PRNGKey(0)})
        total, terms = jlosses.total_fusion_loss(cfg.loss, jnp.clip(fusion, 0.0, 1.0), irj, visj)
        return total, (fusion, terms, mutated["batch_stats"])

    with pinned_seeds(ENTRY_POINTS, SEEDS) as taken:
        if grads:
            (_, (fusion, terms, stats)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                variables["params"])
        else:
            fusion = jax.jit(lambda p: loss_fn(p)[1][0])(variables["params"])
    assert taken == SEEDS, f"JAX drew {len(taken)} block seeds, expected {BLOCKS}"
    if not grads:
        return np.asarray(fusion)
    prefixed = lambda tree, c: {f"{c}/{k}": np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}
    return (np.asarray(fusion), {k: float(v) for k, v in terms.items()}, prefixed(g, "params"),
            prefixed(stats, "batch_stats"))


class _Counted:
    """SEEDS, counting how many the port takes."""

    def __init__(self):
        self.taken = 0

    def __iter__(self):
        for seed in SEEDS:
            self.taken += 1
            yield seed


def _port_forward(impl, ratios):
    flat, ir, vis = _inputs()
    model = SwinFusionUNet(ModelConfig(**TINY, **ratios, attention_impl=impl))
    model.load_state_dict(variables_from_jax(flat))
    seeds = _Counted()
    with torch.no_grad():
        out = model(torch.from_numpy(ir), torch.from_numpy(vis), train=True, seeds=seeds)
    assert seeds.taken == BLOCKS
    return out.numpy()


@pytest.mark.parametrize("impl,jax_impl,ratios", [
    ("cuda", "pallas_interpret", ATTENTION),
    ("cuda_pack", "pallas_pack_interpret", ATTENTION),
    ("cuda_block", "pallas_block_interpret", ALL_SITES),
    ("torch", "pallas_block_interpret", ALL_SITES),
], ids=["cuda-attention", "cuda_pack-attention", "cuda_block-all", "torch-all"])
def test_tiny_model_dropout_forward_matches_jax(impl, jax_impl, ratios):
    key = tuple(sorted(ratios.items()))
    ref = _jax_run(jax_impl, key, jax_impl == "pallas_block_interpret")
    ref = ref[0] if isinstance(ref, tuple) else ref
    np.testing.assert_allclose(_port_forward(impl, ratios), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["cuda_block", "torch"])
def test_tiny_dropout_train_step_matches_jax(impl):
    """One train step with every site on: the port's step (K4's plain version, or the
    composition keyed as K4) against JAX's ``pallas_block_interpret`` gradients."""
    _, ref_terms, ref_grads, ref_stats = _jax_run("pallas_block_interpret",
                                                  tuple(sorted(ALL_SITES.items())), True)
    flat, ir, vis = _inputs()
    cfg = Config(model=ModelConfig(**TINY, **ALL_SITES, attention_impl=impl), optim=OptimConfig(lr=LR))
    state = create_train_state(cfg, flat, ITERS, device="cpu")
    seeds = _Counted()
    terms = make_train_step(cfg)(state, torch.from_numpy(ir), torch.from_numpy(vis), seeds=seeds)
    assert seeds.taken == BLOCKS
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), ref_terms[name], rtol=1e-5, err_msg=name)
    grads = variables_to_jax({n: p.grad for n, p in state.model.named_parameters()})
    assert set(grads) == set(ref_grads)
    assert_grads_close([torch.tensor(grads[n]) for n in ref_grads],
                       [torch.tensor(g) for g in ref_grads.values()], list(ref_grads), impl)
    new = variables_to_jax(state.model.state_dict())
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(new[name], ref, rtol=1e-5, atol=1e-7, err_msg=name)


# ---------------------------------------------------------------- statistics


def _bound(n, rate, sigmas=5.0):
    return sigmas * np.sqrt(rate * (1 - rate) / n)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_composition_keep_fraction_within_binomial_bound(rate):
    key = dl.keying("k4", (28, 21), (7, 7), True, 2, 4, "cpu")
    for site in (hd.SITE_PROJ, hd.SITE_MLP_HIDDEN, hd.SITE_MLP_OUT):
        keep = dl.token_keep(12345, site, rate, key, 2, 3, 32)
        assert abs(keep.float().mean().item() - (1 - rate)) < _bound(keep.numel(), rate)
    windows = dl.windows_table(key)
    keep = dl.attention_keep(12345, rate, key, windows, 2, 3, 2)
    assert abs(keep.float().mean().item() - (1 - rate)) < _bound(keep.numel(), rate)


def test_composition_dropout_keeps_the_expectation():
    """E_seed[drop(x)] = x: over 200 seeds the mean of a dropped tensor of ones stays
    within 5 standard errors of 1 everywhere, and the masks of two sites differ."""
    key = dl.keying("k4", (14, 14), (7, 7), False, 2, 4, "cpu")
    ones = torch.ones(2, 1, 14, 14, 8)
    rate = 0.3
    samples = torch.stack([token_dropout(ones, (seed, key), hd.SITE_MLP_OUT, rate)
                           for seed in range(200)])
    se = np.sqrt(rate / (1 - rate) / 200)  # std of x * keep / (1 - rate) is sqrt(r / (1 - r))
    assert (samples.mean(0) - 1).abs().max().item() < 5 * se
    proj = token_dropout(ones, (0, key), hd.SITE_PROJ, rate)
    assert 0.45 < ((proj == 0) == (samples[0] == 0)).float().mean().item() < 0.9


def _model(impl, ratios):
    flat, _, _ = _inputs()
    model = SwinFusionUNet(ModelConfig(**TINY, **dict(ratios), attention_impl=impl))
    model.load_state_dict(variables_from_jax(flat))
    return model


def _forward(model, train, seeds=None):
    _, ir, vis = _inputs()
    with torch.no_grad():
        return model(torch.from_numpy(ir), torch.from_numpy(vis), train=train, seeds=seeds)


@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda_pack", "cuda_block"])
def test_dropout_acts_in_training_only_and_repeats_per_seed(impl):
    ratios = tuple(sorted(ALL_SITES.items()))
    model, plain = _model(impl, ratios), _model(impl, ())
    assert torch.equal(_forward(model, False), _forward(plain, False))  # eval: no dropout
    first = _forward(model, True, SEEDS)
    assert torch.equal(_forward(model, True, SEEDS), first)
    assert not torch.equal(_forward(model, True, SEEDS[1:] + SEEDS[:1]), first)
    assert not torch.equal(_forward(plain, True), first)
    generator = _forward(model, True, torch.Generator().manual_seed(3))
    assert torch.equal(_forward(model, True, torch.Generator().manual_seed(3)), generator)
    with pytest.raises(ValueError, match="seed source"):
        _forward(model, True)
    # every ratio 0: a seed source is not read, and the step is the one without dropout
    assert torch.equal(_forward(plain, True, SEEDS), _forward(plain, True))


def test_train_step_draws_its_seeds_from_the_config_seed_and_the_step():
    flat, ir, vis = _inputs()
    cfg = Config(model=ModelConfig(**TINY, **ALL_SITES), optim=OptimConfig(lr=LR))
    step = make_train_step(cfg)
    runs = []
    for _ in range(2):
        state = create_train_state(cfg, flat, ITERS, device="cpu")
        runs.append([step(state, torch.from_numpy(ir), torch.from_numpy(vis))["total_loss"].item()
                     for _ in range(2)])
    assert runs[0] == runs[1]  # the same seeds at the same step
    other = Config(model=cfg.model, optim=cfg.optim, seed=1)
    state = create_train_state(other, flat, ITERS, device="cpu")
    assert make_train_step(other)(state, torch.from_numpy(ir), torch.from_numpy(vis))[
        "total_loss"].item() != runs[0][0]
