"""A model with 8x8 windows through the port's kernel route (``attention_impl="cuda"``), against
the JAX model with its Pallas attention kernel in interpret mode, on the CPU.

On the CPU the kernel wrappers run their plain versions, so this holds what the any-window build
of K3 (``csrc/window_attention_fwd_any.cu``, ``_bwd_any.cu``) is held to on the card against the
TPU kernel's semantics at 8x8 windows (64 tokens, padded by JAX to a multiple of 8: no padding),
inside the whole tiny model (two stages, C = 8 and 16, 2 heads): the forward at two input sizes
that are not window multiples (the stages pad their maps to 8x8 multiples: 16x16 or 16x24, then
8x8 or 8x16, every map above the 49-token gate, so every block runs K3), within atol 2e-4 and
rtol 1e-3; then one train step from the same numpy weights against JAX ``make_train_step`` under
``pallas_interpret``, held as ``tests/test_torch_train.py`` holds the tiny steps: the loss terms
(rtol 1e-5), the updated BatchNorm statistics and parameters, and every parameter's gradient
against JAX's (``testing.assert_grads_close``), each tensor's atol at least ROUNDING_NOISE times
its fp32 rounding, read from the port's composition (``torch``) in fp32 against the same in
float64. In this step the q and k gradients of the last decoder's shifted cross block are made by
cancellation: fp32 moves them by more than the 1e-4 of their largest that assert_grads_close
allows against JAX alone, in JAX and in the port alike. About a minute in one process (most of it
JAX's interpret-mode step)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import losses as jlosses
from swin_unet_image_fusion_tpu import optim as joptim
from swin_unet_image_fusion_tpu import train as jtrain
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig, SwinFusionUNet, losses
from swin_unet_image_fusion_tpu_torch.config import OptimConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_from_jax, variables_to_jax
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close, rounding_of
from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WINDOW = (8, 8)
TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2, att_dims_per_head_ratio=1 / 2,
            window_size=WINDOW)
LR = 1e-3
ITERS = 10
STEP_HW = (20, 28)


@pytest.fixture(scope="module")
def tiny_flat():
    return random_variables(ModelConfig(**TINY), seed=31)


def _images(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, dtype=np.float32) for _ in range(n)]


def _counts():
    return twa.LAUNCHES, twa.BWD_LAUNCHES


@pytest.mark.parametrize("hw", [(20, 28), (30, 18)], ids=["20x28", "30x18"])
def test_tiny_8x8_model_matches_pallas_interpret(tiny_flat, hw):
    """The forward under ``cuda`` (every stage on K3: its plain version) against the JAX model
    under ``pallas_interpret``."""
    ir, vis = _images((2, *hw, 1), seed=32)
    model = SwinFusionUNet(ModelConfig(**TINY, attention_impl="cuda"))
    model.load_state_dict(variables_from_jax(tiny_flat))
    assert model.stage_impls(*hw, "cpu") == ("cuda", "cuda")
    counts = _counts()
    with torch.no_grad():
        out = model(torch.from_numpy(ir), torch.from_numpy(vis)).numpy()
    assert _counts() == counts, "CPU tensors run the plain version, which never counts"
    jax_model = JaxUNet(jcfg.ModelConfig(**TINY, attention_impl="pallas_interpret"))
    ref = jax.jit(jax_model.apply)(unflatten_dict(tiny_flat, sep="/"), jnp.asarray(ir), jnp.asarray(vis))
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-4, rtol=1e-3)


def _jax_step(flat, ir, vis):
    """JAX's step-1 terms, gradients, batch_stats and params under ``pallas_interpret``."""
    cfg = jcfg.Config(model=jcfg.ModelConfig(**TINY, attention_impl="pallas_interpret"),
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

    def prefixed(tree, c):
        return {f"{c}/{k}": np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}

    return ({k: float(v) for k, v in terms.items()}, prefixed(grads, "params"),
            prefixed(new_state.batch_stats, "batch_stats"), prefixed(new_state.params, "params"))


def _composition_grads(flat, ir, vis, dtype):
    """Every parameter's gradient of the step's loss from the composition (``torch``) in
    ``dtype``, by flax name."""
    cfg = Config(model=ModelConfig(**TINY, attention_impl="torch"))
    model = SwinFusionUNet(cfg.model)
    model.load_state_dict(variables_from_jax(flat))
    model = model.to(dtype)
    a, b = torch.from_numpy(ir).to(dtype), torch.from_numpy(vis).to(dtype)
    fused = model(a, b, train=True)
    losses.total_fusion_loss(cfg.loss, fused.clamp(0.0, 1.0), a, b)[0].backward()
    return variables_to_jax({n: p.grad for n, p in model.named_parameters()})


def test_tiny_8x8_train_step_matches_jax(tiny_flat):
    """One train step under ``cuda`` (K3's plain forward and backward at 8x8) against JAX's under
    ``pallas_interpret``: the loss terms, every gradient, the BatchNorm statistics and the updated
    parameters (where a gradient is rounding noise, below 1e-4 of the largest, Adam's first step
    may take the other sign: up to twice the learning rate apart)."""
    ir, vis = _images((2, *STEP_HW, 1), seed=33)
    ref_terms, ref_grads, ref_stats, ref_params = _jax_step(tiny_flat, ir, vis)
    cfg = Config(model=ModelConfig(**TINY, attention_impl="cuda"), optim=OptimConfig(lr=LR))
    state = create_train_state(cfg, tiny_flat, ITERS, device="cpu")
    counts = _counts()
    terms = make_train_step(cfg)(state, torch.from_numpy(ir), torch.from_numpy(vis))
    assert _counts() == counts
    assert (state.step, state.updates) == (1, 1)
    for name, value in terms.items():
        np.testing.assert_allclose(value.item(), ref_terms[name], rtol=1e-5, err_msg=name)
    grads = variables_to_jax({n: p.grad for n, p in state.model.named_parameters()})
    assert set(grads) == set(ref_grads)
    fp32, fp64 = (_composition_grads(tiny_flat, ir, vis, dtype) for dtype in (torch.float32, torch.float64))
    rounding = rounding_of([torch.tensor(fp32[n]) for n in ref_grads], [torch.tensor(fp64[n]) for n in ref_grads])
    assert_grads_close([torch.tensor(grads[n]) for n in ref_grads], [torch.tensor(g) for g in ref_grads.values()],
                       list(ref_grads), "the 8x8 step against JAX's", rounding)
    scale = max(np.abs(g).max() for g in ref_grads.values())
    new = variables_to_jax(state.model.state_dict())
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(new[name], ref, rtol=1e-5, atol=1e-7, err_msg=name)
    for name, ref in ref_params.items():
        noise = np.abs(ref_grads[name]) < 1e-4 * scale
        np.testing.assert_allclose(new[name][~noise], ref[~noise], rtol=0, atol=1e-6, err_msg=name)
        assert (np.abs(new[name][noise] - ref[noise]) <= 2 * LR + 1e-6).all(), name
