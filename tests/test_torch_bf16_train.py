"""One bf16 train step of the tiny model: the port against JAX ``make_train_step`` at
``compute_dtype="bfloat16"``.

The JAX step runs the forward in bf16 (the head's output cast to fp32), clamps, takes the
fp32 loss and returns fp32 gradients of the fp32 parameters; Adam and the BatchNorm
statistics are fp32. Its kernels' backward bodies compute in fp32 at the bf16 inputs
(``test_torch_bf16_grad.py``). The port takes the same step from the same numpy weights:

- without dropout: the composition (``torch``) and the three kernel configurations
  (their plain bf16 forms on the CPU) against JAX ``jnp``;
- with every dropout ratio at 0.2: ``cuda_block`` against JAX ``pallas_block_interpret``,
  the JAX block seeds pinned (``test_torch_dropout.pinned_seeds``); no stage is gated to
  the composition, so every JAX dropout site is in a kernel. The composition's dropout
  step (keyed as K4) is held to JAX's loss terms and statistics.

A bf16 step is compared by criteria that JAX's own bf16 steps meet, never to fp32
rounding. The JAX steps run with XLA's excess precision off (:func:`jax_steps`), so that
every bf16 rounding point of the JAX modules holds; ``python
tests/test_torch_bf16_train.py`` prints the spread of JAX's own steps on these inputs
(CPU):

- without dropout, JAX's ``pallas_block_interpret``, ``pallas_pack_interpret`` and
  ``pallas_interpret`` steps against its ``jnp`` step: loss terms up to 1.693e-3
  relative; gradients, each against its own largest magnitude (a gradient that is exactly
  0 by construction, ``testing.exact_zero``, against the step's largest), largest error up
  to 0.209 of it and up to 0.613% of all elements off by more than 3e-2 of their tensor's
  largest; Adam's first step moves each parameter by about the learning rate times the
  sign of its gradient, and up to 1.415% of the parameters moved to the other side;
  BatchNorm statistics up to 1.115e-3 relative;
- with dropout (the same masks), JAX's ``pallas_block_interpret`` step with XLA's excess
  precision on against it off: loss terms 1.826e-3, gradients largest error 0.864 and
  22.398% of the elements off, 5.315% of the parameters moved to the other side,
  BatchNorm statistics 1.480e-3. Dropout at 0.2 on every site of these random weights
  makes the step far more sensitive to where bf16 rounds (in fp32 the port's step with and
  without dropout moves 0.93% and 0.06% of the gradient elements for the same input
  perturbation of 2^-9).

The criteria are twice that, set from JAX's spread before the port's numbers against
this reference were read (a first derivation against XLA's default excess precision was
set aside when the JAX output turned out not to be bf16 at all: XLA had dropped the
roundings).

About 120 s in one process (the JAX steps take 100 s of it, in a process of their own).
"""

import functools
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import optim as joptim
from swin_unet_image_fusion_tpu import train as jtrain
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
from swin_unet_image_fusion_tpu_torch.config import OptimConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_to_jax
from swin_unet_image_fusion_tpu_torch.testing import exact_zero
from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step
from test_torch_dropout import pinned_seeds

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2, attention_jnp_max_tokens=None)
LR, ITERS = 1e-3, 10
HW = (28, 28)
RATIO = 0.2
DROP = dict(attention_drop_ratio=RATIO, linear_after_att_drop_ratio=RATIO, mlp_drop_ratio=RATIO)
BLOCKS = 16  # 2 stages x (encoder + decoder) x 4 blocks
SEEDS = [(1_000_003 * (i + 1)) % (1 << 24) for i in range(BLOCKS)]
ENTRY_POINTS = [(jpb, "pallas_fused_block"), (jpa, "pallas_window_attention"),
                (jpp, "pallas_packed_block_strips")]

# criteria (module docstring): twice JAX's own spread, one bound on each number of
# spread(): loss terms (relative), the worst gradient error (x its tensor's largest), the
# share of gradient elements off by more than GRAD_NEAR x their tensor's largest, the
# share of parameters Adam moved to the other side, BatchNorm statistics (relative)
GRAD_NEAR = 3e-2
CRITERIA = (3.4e-3, 0.42, 0.0123, 0.028, 2.2e-3)
DROP_CRITERIA = (3.7e-3, 1.73, 0.448, 0.106, 3.0e-3)


class _GradsState(jtrain.TrainState):
    """JAX's train state that also keeps the gradients its step applied, so that one
    compiled ``make_train_step`` gives the terms, the gradients and the new state."""

    grads: Any = None

    def apply_gradients(self, *, grads, **kwargs):
        return super().apply_gradients(grads=grads, **kwargs).replace(grads=grads)


@functools.lru_cache(maxsize=None)
def _inputs():
    flat = random_variables(ModelConfig(**TINY), seed=61)
    rng = np.random.default_rng(62)
    ir, vis = (rng.random((2, *HW, 1), dtype=np.float32) for _ in range(2))
    return flat, ir, vis


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def _jax_step_here(impl, dropout):
    """(terms, gradients, new batch_stats, new params) of JAX's bf16 step in this process,
    flat names; with ``dropout`` every ratio at 0.2 and the block seeds pinned to SEEDS."""
    flat, ir, vis = _inputs()
    cfg = jcfg.Config(model=jcfg.ModelConfig(**TINY, **(DROP if dropout else {}), attention_impl=impl,
                                             compute_dtype="bfloat16"),
                      optim=jcfg.OptimConfig(lr=LR))
    variables = unflatten_dict(flat, sep="/")
    state = _GradsState.create(apply_fn=JaxUNet(cfg.model).apply, params=variables["params"],
                               tx=joptim.make_optimizer(cfg.optim, ITERS),
                               batch_stats=variables["batch_stats"])
    with pinned_seeds(ENTRY_POINTS if dropout else [], SEEDS) as taken:
        new, terms = jtrain.make_train_step(cfg, donate=False)(state, jnp.asarray(ir), jnp.asarray(vis))
        jax.block_until_ready(new)
    assert taken == (SEEDS if dropout else []), f"JAX drew {len(taken)} block seeds"
    return ({k: float(v) for k, v in terms.items()}, _flat(new.grads, "params"),
            _flat(new.batch_stats, "batch_stats"), _flat(new.params, "params"))


def jax_steps(keys, excess_precision=False):
    """JAX's bf16 steps ``{(impl, dropout): step}`` for ``keys``, taken in a fresh process
    whose XLA keeps every bf16 rounding point (``--xla_allow_excess_precision=false``)
    unless ``excess_precision``: by default XLA may compute a jitted chain of bf16 operations
    in fp32 and drop the roundings in between (the default JAX step's output is not even
    bf16), so the JAX modules' rounding points, which the port keeps, hold only with the
    flag. The flag is read when XLA starts, hence the process of its own."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, (str(root), os.environ.get("PYTHONPATH")))))
    if not excess_precision:
        env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} --xla_allow_excess_precision=false".strip()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "steps.pkl"
        subprocess.run([sys.executable, __file__, "--jax-steps", str(out),
                        *(f"{impl}:{int(dropout)}" for impl, dropout in keys)],
                       env=env, check=True, timeout=900)
        with open(out, "rb") as f:
            return pickle.load(f)


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX steps the tests compare with: ``jnp`` without dropout and
    ``pallas_block_interpret`` with it, every bf16 rounding point kept."""
    return jax_steps([("jnp", False), ("pallas_block_interpret", True)])


def _port_step(impl, dropout):
    flat, ir, vis = _inputs()
    cfg = Config(model=ModelConfig(**TINY, **(DROP if dropout else {}), attention_impl=impl,
                                   compute_dtype="bfloat16"), optim=OptimConfig(lr=LR))
    state = create_train_state(cfg, flat, ITERS, device="cpu")
    seeds = list(SEEDS) if dropout else None
    terms = make_train_step(cfg)(state, torch.from_numpy(ir), torch.from_numpy(vis), seeds=seeds)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    new = variables_to_jax(state.model.state_dict())
    return ({k: v.item() for k, v in terms.items()}, variables_to_jax(grads),
            {k: v for k, v in new.items() if k.startswith("batch_stats/")},
            {k: v for k, v in new.items() if k.startswith("params/")})


def spread(a, b):
    """How far step ``a`` is from step ``b``: (largest relative loss-term difference,
    the largest gradient error relative to its tensor's largest magnitude (the step's
    largest for a gradient that is exactly 0 by construction), the share of
    gradient elements off by more than GRAD_NEAR of it, the share of parameters moved to
    the other side, the largest relative BatchNorm statistic difference)."""
    terms_a, grads_a, stats_a, params_a = a
    terms_b, grads_b, stats_b, params_b = b
    assert set(grads_a) == set(grads_b) and set(params_a) == set(params_b)
    terms = max(abs(terms_a[k] - v) / max(abs(v), 1e-12) for k, v in terms_b.items())
    call = max(np.abs(g).max() for g in grads_b.values())
    worst, far, total = 0.0, 0, 0
    for name, ref in grads_b.items():
        scale = call if exact_zero(name) else max(np.abs(ref).max(), 1e-30)
        err = np.abs(grads_a[name] - ref) / scale
        worst = max(worst, float(err.max()))
        far += int((err > GRAD_NEAR).sum())
        total += ref.size
    flips = sum(int((np.abs(params_a[n] - ref) > LR).sum()) for n, ref in params_b.items())
    stats = max(float(np.max(np.abs(stats_a[n] - ref) / np.abs(ref))) for n, ref in stats_b.items())
    return terms, worst, far / total, flips / sum(p.size for p in params_b.values()), stats


def _assert_step_close(port, ref, what, criteria):
    """``port`` within ``criteria`` of ``ref``, each bound on a number of :func:`spread`."""
    terms, worst, far, flips, stats = spread(port, ref)
    terms_max, worst_max, far_max, flips_max, stats_max = criteria
    print(f"{what}: terms {terms:.2e}, gradients worst {worst:.3f} of their largest, "
          f"{far:.3%} off by > {GRAD_NEAR}, parameters {flips:.3%} flipped, stats {stats:.2e}")
    assert terms <= terms_max, f"{what}: loss terms {terms:.2e}"
    assert worst <= worst_max, f"{what}: a gradient is off by {worst:.3f} of its largest"
    assert far <= far_max, f"{what}: {far:.2%} of the gradient elements are off"
    assert flips <= flips_max, f"{what}: {flips:.2%} of the parameters moved the other way"
    assert stats <= stats_max, f"{what}: BatchNorm statistics {stats:.2e}"
    _, _, _, params = port
    assert all(np.all(np.abs(params[n] - v) <= 2 * LR + 1e-6) for n, v in ref[3].items())


@pytest.mark.parametrize("impl", ["torch", "cuda", "cuda_pack", "cuda_block"])
def test_bf16_train_step_matches_jax(impl):
    _assert_step_close(_port_step(impl, False), _reference()[("jnp", False)], f"{impl} vs jnp",
                       CRITERIA)


def test_bf16_dropout_train_step_matches_jax():
    """Every site at rate 0.2 with the same block seeds: ``cuda_block`` (K4's plain bf16
    forms) against ``pallas_block_interpret``, the same function."""
    ref = _reference()[("pallas_block_interpret", True)]
    _assert_step_close(_port_step("cuda_block", True), ref, "cuda_block dropout vs pallas_block_interpret",
                       DROP_CRITERIA)
    assert spread(ref, _reference()[("jnp", False)])[0] > CRITERIA[0], "dropout must move the loss"


def test_bf16_dropout_composition_step_matches_jax_forward():
    """The composition's dropout step (its masks keyed as K4) against
    ``pallas_block_interpret``: the loss terms and the BatchNorm statistics. In bf16 the
    composition rounds elsewhere than K4 (a route change, which without dropout moves 0.37%
    of JAX's gradient elements), and dropout multiplies how far a change of rounding moves
    the gradients (module docstring): the port's composition and K4 steps differ from each
    other as much as from JAX's, so no JAX spread bounds its gradients; they are held to be
    finite fp32 where JAX's are nonzero."""
    ref = _reference()[("pallas_block_interpret", True)]
    port = _port_step("torch", True)
    terms, _, _, _, stats = spread(port, ref)
    print(f"torch dropout vs pallas_block_interpret: terms {terms:.2e}, stats {stats:.2e}")
    assert terms <= DROP_CRITERIA[0] and stats <= DROP_CRITERIA[4]
    assert all(np.isfinite(g).all() and g.dtype == np.float32 for g in port[1].values())
    assert all(np.abs(port[1][n]).max() > 0 for n, g in ref[1].items() if np.abs(g).max() > 0)


def test_step_accumulates_bf16_products_in_fp32_through_the_backward():
    """The step's scope turns cuBLAS's reduced-precision reduction of bf16 GEMMs (and TF32)
    off while the backward runs, not only the forward, and restores the caller's setting
    after the step."""
    matmul = torch.backends.cuda.matmul
    flat, ir, vis = _inputs()
    cfg = Config(model=ModelConfig(**TINY, compute_dtype="bfloat16"), optim=OptimConfig(lr=LR))
    state = create_train_state(cfg, flat, ITERS, device="cpu")
    seen = []
    for param in state.model.parameters():  # a parameter's hook runs in the backward
        param.register_hook(lambda g: seen.append(
            (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32)))
    before = (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32)
    try:
        for setting in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = matmul.allow_tf32 = setting
            make_train_step(cfg)(state, torch.from_numpy(ir), torch.from_numpy(vis))
            assert (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32) == (setting,) * 2
    finally:
        matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32 = before
    assert len(seen) == 2 * len(list(state.model.parameters()))
    assert set(seen) == {(False, False)}


def test_criteria_fail_a_step_with_a_wrong_gradient():
    """A step whose one gradient is scaled by 1.5, or whose loss is off by 1%, fails."""
    ref = _reference()[("jnp", False)]
    terms, grads, stats, params = ref
    name = max(grads, key=lambda n: grads[n].size)
    with pytest.raises(AssertionError, match="gradient"):
        _assert_step_close((terms, {**grads, name: grads[name] * 1.5}, stats, params), ref,
                           "scaled", CRITERIA)
    with pytest.raises(AssertionError, match="loss terms"):
        _assert_step_close(({k: v * 1.01 for k, v in terms.items()}, grads, stats, params), ref,
                           "off", CRITERIA)


def _print_spread(what, a, b):
    terms, worst, far, flips, stats = spread(a, b)
    print(f"{what}: loss terms {terms:.3e} relative; gradients worst {worst:.4f} of their "
          f"largest, {far:.4%} of the elements off by > {GRAD_NEAR}; {flips:.4%} of the "
          f"parameters moved the other way; BatchNorm statistics {stats:.3e} relative")


def main(argv) -> int:
    """``--jax-steps OUT IMPL:DROPOUT ...`` pickles those JAX steps (:func:`jax_steps`);
    without arguments, print JAX's own spread, the basis of the criteria: between its bf16
    routes without dropout, and with dropout between its ``pallas_block_interpret`` step
    with and without XLA's excess precision (the same masks, other rounding points)."""
    if argv[:1] == ["--jax-steps"]:
        jax.config.update("jax_platforms", "cpu")  # env alone may be overridden (conftest.py)
        keys = [(impl, bool(int(d))) for impl, d in (key.split(":") for key in argv[2:])]
        with open(argv[1], "wb") as f:
            pickle.dump({key: _jax_step_here(*key) for key in keys}, f)
        return 0
    routes = ("jnp", "pallas_block_interpret", "pallas_pack_interpret", "pallas_interpret")
    steps = jax_steps([(impl, False) for impl in routes] + [("pallas_block_interpret", True)])
    for impl in routes[1:]:
        _print_spread(f"JAX {impl} vs jnp, bf16", steps[(impl, False)], steps[("jnp", False)])
    excess = jax_steps([("pallas_block_interpret", True)], excess_precision=True)
    _print_spread("JAX pallas_block_interpret with dropout, excess precision on vs off",
                  excess[("pallas_block_interpret", True)], steps[("pallas_block_interpret", True)])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
