"""Two options of the port's train step against their reference: ``skip_nonfinite_updates``
against ``optax.apply_if_finite`` and ``remat=True`` against the step without it.

- ``skip_nonfinite_updates``: a sequence of steps of the tiny model, finite ones and ones
  made non-finite by a NaN input pixel, with ``MAX_CONSECUTIVE_ERRORS`` set to 2, against
  ``optax.apply_if_finite(inner, max_consecutive_errors=2)`` over the JAX package's Adam and
  schedule fed the port's gradients: per step, whether the update was applied, the
  consecutive count, optax's inner counts against ``updates``, and the parameters (rtol
  1e-6, atol 1e-7; NaN exactly where optax's are NaN). The sequence holds a reset on a
  finite step and the forced updates after the third non-finite step in a row. Without the
  guard the step never reads the flag.
- ``remat=True``: the loss terms, every parameter's gradient and the BatchNorm statistics
  of one step of the tiny model equal those of the same step without it, bit for bit,
  under ``torch`` and ``cuda_block`` (their plain versions on the CPU), without dropout and
  with every ratio 0.1 and the same step seeds.

About 30 s in one process.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import optim as joptim
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig, optim
from swin_unet_image_fusion_tpu_torch.config import OptimConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_to_jax
from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
LR = 1e-3
ITERS = 10
# finite (True) or NaN-input (False) steps: two skipped, a reset, two skipped, then forced
FINITE = (True, False, False, True, False, False, False, False, True)
APPLIED = (True, False, False, True, False, False, True, True, True)
COUNTS = (0, 1, 2, 0, 1, 2, 3, 4, 5)  # a forced update does not reset the count


def _pair(seed, nan):
    rng = np.random.default_rng(seed)
    ir, vis = (rng.random((2, 14, 14, 1), dtype=np.float32) for _ in range(2))
    if nan:
        ir[1, 3, 5, 0] = np.nan
    return torch.from_numpy(ir), torch.from_numpy(vis)


def test_skip_nonfinite_updates_matches_optax_apply_if_finite(monkeypatch):
    monkeypatch.setattr(optim, "MAX_CONSECUTIVE_ERRORS", 2)
    flat = random_variables(ModelConfig(**TINY), seed=41)
    cfg = Config(model=ModelConfig(**TINY), optim=OptimConfig(lr=LR, skip_nonfinite_updates=True))
    state = create_train_state(cfg, flat, ITERS, device="cpu")
    step = make_train_step(cfg)

    tx = optax.apply_if_finite(joptim.make_optimizer(jcfg.OptimConfig(lr=LR), ITERS),
                               max_consecutive_errors=2)
    params = unflatten_dict({k[len("params/"):]: jnp.asarray(v) for k, v in flat.items()
                             if k.startswith("params/")}, sep="/")
    opt_state = tx.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), updates, opt_state

    for i, finite in enumerate(FINITE):
        updates_before = state.updates
        terms = step(state, *_pair(50 + i, nan=not finite))
        assert bool(torch.isfinite(terms["total_loss"])) == (finite and i < 6), i
        grads = variables_to_jax({n: p.grad for n, p in state.model.named_parameters()})
        jgrads = unflatten_dict({k[len("params/"):]: jnp.asarray(v) for k, v in grads.items()}, sep="/")
        params, updates, opt_state = update(jgrads, opt_state, params)

        applied = not all(bool(jnp.all(u == 0)) for u in jax.tree_util.tree_leaves(updates))
        assert applied == APPLIED[i] == (state.updates == updates_before + 1), i
        assert state.notfinite == int(opt_state.notfinite_count) == COUNTS[i], i
        adam, schedule = opt_state.inner_state
        assert int(adam.count) == int(schedule.count) == state.updates, i
        assert state.step == i + 1
        got = variables_to_jax(dict(state.model.named_parameters()))
        for key, ref in flatten_dict(params, sep="/").items():
            ref = np.asarray(ref)
            value = got[f"params/{key}"]
            np.testing.assert_array_equal(np.isnan(value), np.isnan(ref), err_msg=f"step {i} {key}")
            np.testing.assert_allclose(value, ref, rtol=1e-6, atol=1e-7, err_msg=f"step {i} {key}")
    assert any(np.isnan(v).any() for v in got.values())  # the forced NaN updates went through


def test_without_the_guard_the_step_reads_no_flag(monkeypatch):
    def no_read(grads):
        raise AssertionError("the step read the finite flag without skip_nonfinite_updates")

    monkeypatch.setattr(optim, "all_finite", no_read)
    flat = random_variables(ModelConfig(**TINY), seed=42)
    cfg = Config(model=ModelConfig(**TINY), optim=OptimConfig(lr=LR))
    state = create_train_state(cfg, flat, ITERS, device="cpu")
    step = make_train_step(cfg)
    step(state, *_pair(60, nan=True))
    assert (state.step, state.updates, state.notfinite) == (1, 1, 0)


DROP = dict(attention_drop_ratio=0.1, linear_after_att_drop_ratio=0.1, mlp_drop_ratio=0.1)


@pytest.mark.parametrize("impl", ["torch", "cuda_block"])
@pytest.mark.parametrize("dropout", [False, True], ids=["no_dropout", "dropout"])
def test_remat_gives_the_gradients_without_it(impl, dropout):
    flat = random_variables(ModelConfig(**TINY), seed=43)
    rng = np.random.default_rng(44)
    ir, vis = (torch.from_numpy(rng.random((2, 28, 28, 1), dtype=np.float32)) for _ in range(2))
    runs = []
    for remat in (False, True):
        model = ModelConfig(**TINY, attention_impl=impl, remat=remat, **(DROP if dropout else {}))
        cfg = Config(model=model, optim=OptimConfig(lr=LR))
        state = create_train_state(cfg, flat, ITERS, device="cpu")
        terms = make_train_step(cfg)(state, ir, vis)
        grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
        runs.append((terms, grads, {n: b.clone() for n, b in state.model.named_buffers()}))
    (terms, grads, stats), (rterms, rgrads, rstats) = runs
    for name, value in terms.items():
        assert torch.equal(rterms[name], value), name
    assert set(rgrads) == set(grads)
    for name, value in grads.items():
        assert torch.equal(rgrads[name], value), name
    for name, value in stats.items():  # the head's BatchNorm, outside the checkpointed pairs
        assert torch.equal(rstats[name], value), name
