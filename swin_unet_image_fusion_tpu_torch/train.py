"""Training step (port of the JAX ``train.py::make_train_step``, ``make_eval_step`` and
``create_train_state``).

A step is: forward with ``train=True`` (the head's BatchNorm on batch statistics,
its running statistics updated in place), the output clamped to [0, 1] *before* the
loss (the clamp's zero gradient outside the range is part of the reference's training
dynamics), ``total_fusion_loss``, backward, the opt-in guards, the learning rate of the
per-iteration cosine warm-restart schedule, and Adam's update. Under a kernel
configuration the backward runs the backward kernels (``ops/fused_block.py``,
``ops/window_attention.py``, ``ops/window_pack.py``). A step returns the loss terms as
0-d device tensors and never waits for the device.

TF32 stays off for the whole step, backward included (fp32 parity with the JAX
package's ``Precision.HIGHEST``): cuBLAS matmuls and cuDNN convolutions. So does cuBLAS's
reduced-precision reduction of bf16 GEMMs, which would let a split-K GEMM of a
``compute_dtype="bfloat16"`` step reduce its partial sums in bf16 where JAX accumulates in
fp32: the model's forward turns it off while it runs, and the step's scope keeps it off
through the loss and the backward. The caller's settings are restored after the step.

At ``compute_dtype="bfloat16"`` the forward runs in bf16 and returns fp32 at the head (JAX
``models/unet.py:269``); the clamp, the loss, the gradients of the fp32 parameters, the
BatchNorm statistics and Adam's state are fp32, as in the JAX step.

With a nonzero dropout ratio a step draws its per-block dropout seeds from a CPU
``torch.Generator`` seeded from (``cfg.seed``, step): the counterpart of the JAX step's
``fold_in(PRNGKey(cfg.seed), step)``, with other bits and the same determinism (the same
state, batch and step number give the same step). A step with every ratio 0 draws
nothing.

The ``Trainer`` of the JAX package (data loader, TensorBoard, checkpoints) is not
ported yet.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Config
from .losses import total_fusion_loss
from .models.from_jax import flatten_variables, variables_from_jax
from .models.unet import SwinFusionUNet, fp32_accumulation
from .optim import all_finite, clip_by_global_norm_, cosine_warm_restarts_schedule, make_optimizer


@dataclass
class TrainState:
    """The model (in ``train()`` mode), its Adam optimiser and the step counts."""

    model: SwinFusionUNet
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0  # steps taken
    updates: int = 0  # updates applied: the schedule's count (a skipped step adds none)


def create_train_state(cfg: Config, variables: Mapping, iters_per_epoch: int, *,
                       device: torch.device | str = "cuda") -> TrainState:
    """A train state on ``device`` ("cuda" unless the caller passes "cpu") from flax
    variables, nested or flat (as :func:`~.models.from_jax.variables_from_jax` takes)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_train_state was asked for a CUDA device and none is "
                           "available; pass device='cpu' to run on the CPU")
    model = SwinFusionUNet(cfg.model)
    model.load_state_dict(variables_from_jax(flatten_variables(variables)))
    model.to(device).train()
    o = cfg.optim
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), o),
                      schedule=cosine_warm_restarts_schedule(o.lr, o.minimum_lr, o.scheduler_t0,
                                                             iters_per_epoch))


@contextlib.contextmanager
def fp32_mode():
    """TF32 off in cuBLAS matmuls and cuDNN convolutions, and cuBLAS's bf16 GEMMs
    accumulating in fp32 (:func:`~.models.unet.fp32_accumulation`), restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), fp32_accumulation():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def dropout_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s dropout seeds under ``cfg.seed`` = ``seed``:
    seeded with 32 bits of numpy's ``SeedSequence((seed, step))`` (the CPU generator
    keeps only 32 bits of its seed)."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence((seed & 0xFFFFFFFF, step)).generate_state(1)[0]))


def make_train_step(cfg: Config) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, ir, vis, seeds=None) -> terms``: one update of ``state`` in place on
    an (B, H, W, 1) pair. The gradients of the step stay in each parameter's ``.grad``.
    With dropout, ``seeds`` (a sequence of per-block seeds) replaces the step's generator
    (:func:`dropout_generator`)."""
    loss_cfg, optim_cfg = cfg.loss, cfg.optim

    def step(state: TrainState, ir: torch.Tensor, vis: torch.Tensor,
             seeds: Optional[Iterable[int]] = None) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if model.has_dropout and seeds is None:
            seeds = dropout_generator(cfg.seed, state.step)
        with fp32_mode():
            opt.zero_grad(set_to_none=True)
            fusion = torch.clamp(model(ir, vis, train=True, seeds=seeds), 0.0, 1.0)
            total, terms = total_fusion_loss(loss_cfg, fusion, ir, vis)
            total.backward()
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            apply = not optim_cfg.skip_nonfinite_updates or all_finite(grads)
            if apply:
                if optim_cfg.grad_clip_norm > 0.0:
                    clip_by_global_norm_(grads, optim_cfg.grad_clip_norm)
                for group in opt.param_groups:
                    group["lr"] = state.schedule(state.updates)
                opt.step()
                state.updates += 1
        state.step += 1
        return {name: value.detach() for name, value in terms.items()}

    return step


def make_eval_step(cfg: Config) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                            Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``step(state, ir, vis) -> (fusion, terms)``: the eval forward (running BatchNorm
    statistics), clamped, and its loss terms."""

    @torch.no_grad()
    def step(state: TrainState, ir: torch.Tensor, vis: torch.Tensor):
        with fp32_mode():
            fusion = torch.clamp(state.model(ir, vis, train=False), 0.0, 1.0)
            _, terms = total_fusion_loss(cfg.loss, fusion, ir, vis)
        return fusion, terms

    return step
