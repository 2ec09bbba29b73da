"""Optimiser and learning-rate schedule (port of the JAX ``optim.py``).

Adam with torch's default betas and eps, whose update equals optax ``scale_by_adam``
(mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), and the reference's
``CosineAnnealingWarmRestarts(T_0=20, eta_min=1e-5)`` stepped every iteration with a
fractional epoch. The reference steps the scheduler *after* the optimiser, so update
``n`` (0-based) runs with the rate of fractional epoch ``max(0, n - 1) / iters_per_epoch``;
the off-by-one is kept so that the curve matches sample for sample.

Two opt-in guards, both off by default as in the JAX package: ``grad_clip_norm > 0``
scales the gradients to that global norm first (optax ``clip_by_global_norm``), and
``skip_nonfinite_updates`` skips an update whose gradients are not all finite, leaving
the parameters and the optimiser state as they were, as optax ``apply_if_finite(tx,
max_consecutive_errors=100)`` does (:func:`apply_if_finite`): after more than
:data:`MAX_CONSECUTIVE_ERRORS` non-finite steps in a row every further one is applied, until
a finite step resets the count.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Tuple

import torch

from .config import OptimConfig

# The JAX package's ``optax.apply_if_finite(..., max_consecutive_errors=100)``.
MAX_CONSECUTIVE_ERRORS = 100


def cosine_warm_restarts_schedule(base_lr: float, eta_min: float, t0_epochs: int,
                                  iters_per_epoch: int) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0-based):
    eta_min + (base - eta_min) * (1 + cos(pi * (t mod T0) / T0)) / 2 with
    t = max(count - 1, 0) / iters_per_epoch."""

    def schedule(count: int) -> float:
        t = max(count - 1, 0) / iters_per_epoch
        t_cur = math.fmod(t, t0_epochs)
        return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * t_cur / t0_epochs)) / 2.0

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimConfig) -> torch.optim.Adam:
    """Adam (betas 0.9/0.999, eps 1e-8); the step sets its rate from the schedule."""
    return torch.optim.Adam(list(params), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place to global norm ``max_norm`` where it is larger (optax
    ``clip_by_global_norm``), without a host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def all_finite(grads: List[torch.Tensor]) -> bool:
    """Whether every gradient is finite. Reads one flag from the device: the
    ``skip_nonfinite_updates`` guard costs one host synchronisation per step."""
    return bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())


def apply_if_finite(grads: List[torch.Tensor], notfinite: int) -> Tuple[bool, int]:
    """``(apply, notfinite)``: optax ``apply_if_finite``'s decision for gradients ``grads``
    after ``notfinite`` consecutive non-finite steps. A finite step applies and resets the
    count to 0; a non-finite one adds 1 and applies only where the count now exceeds
    :data:`MAX_CONSECUTIVE_ERRORS` (a forced update does not reset it)."""
    if all_finite(grads):
        return True, 0
    notfinite += 1
    return notfinite > MAX_CONSECUTIVE_ERRORS, notfinite
