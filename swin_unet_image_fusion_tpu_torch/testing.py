"""The gradient comparison that holds the backward kernels to their plain versions, shared
by ``chip_smoke.py`` and the tests."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-4  # times each tensor's scale
SCALE_FLOOR = 1e-8  # of the call's largest magnitude


def exact_zero(name: str) -> bool:
    """Whether the gradient named ``name`` (a kernel argument, or a parameter in the port's
    or flax's naming) is exactly 0 by construction, so that what a run computes is rounding
    noise: a key bias (a constant added to every key of a window leaves its softmax
    unchanged, while no score reaches the softmax clamp of 80) and the bias of the head's first conv in training (the BatchNorm after it
    subtracts the batch mean)."""
    name = name.replace("/", ".")
    return name == "bk" or name.endswith(("attn.k.bias", "final_head.conv1.bias"))


class GradCheck(NamedTuple):
    worst: float  # the largest absolute error
    worst_own: float  # the largest error of a tensor over its own largest magnitude, zeros aside
    smallest: float  # the smallest own largest magnitude over the call's, zeros aside
    floored: int  # tensors held to the floor instead of their own scale
    zeros: Tuple[str, ...]  # the exactly-zero gradients, held to the call's scale
    zero_noise: float  # their largest magnitude, either side, over the call's largest


def assert_grads_close(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                       names: Sequence[str], what: str = "") -> GradCheck:
    """Every gradient in ``got`` finite and within rtol 1e-3 and atol 1e-4 x its scale of
    ``ref``'s (fp32 sums over up to B*H*W tokens per stream, in another order than
    autograd's). Raises on the first gradient that fails.

    A tensor's scale is its reference's own largest magnitude, but at least 1e-8 of the
    largest magnitude of all of ``ref``: a small gradient made by cancellation agrees only
    to ~3e-3 of itself (the stage-4 q/k gradients of the random-weight 224² train step are
    2e-12 to 4e-11 of the step's largest), and the floor still fails a zeroed gradient down
    to 1e-12 of the largest. An exactly-zero gradient (:func:`exact_zero`) is held to the
    call's largest magnitude.
    """
    own = [float(b.abs().max()) if b.numel() else 0.0 for b in ref]
    call = max(own)
    worst, worst_own, smallest, floored, zeros, zero_noise = 0.0, 0.0, 1.0, 0, [], 0.0
    for name, a, b, scale in zip(names, got, ref, own):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: the gradient of {name} is not finite")
        err = float((a - b).abs().max()) if b.numel() else 0.0
        if exact_zero(name):
            zeros.append(name)
            zero_noise = max(zero_noise, float(a.abs().max()) / call, scale / call)
            scale = call
        else:
            if scale > 0.0:
                smallest = min(smallest, scale / call)
                worst_own = max(worst_own, err / scale)
            if scale < SCALE_FLOOR * call:
                floored += 1
                scale = SCALE_FLOOR * call
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale,
                                   msg=lambda m: f"{what}, {name}: {m}")
        worst = max(worst, err)
    return GradCheck(worst, worst_own, smallest, floored, tuple(zeros), zero_noise)
