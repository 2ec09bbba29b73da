"""The comparisons shared by ``chip_smoke.py`` and the tests: the gradient check that holds
the backward kernels to their plain versions, and the image-level criteria that hold a
bf16 forward of the whole model to a reference forward; and a dataset of seeded arrays
for the trainer where no image folder or decoder is at hand."""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DataConfig
from .data.dataset import FusionPairDataset

GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-4  # times each tensor's scale
SCALE_FLOOR = 1e-8  # of the call's largest magnitude
ROUNDING_NOISE = 8.0  # times an fp32 evaluation's own distance from its float64 evaluation


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
    widened: Tuple[str, ...] = ()  # with ``rounding``: the tensors whose atol their rounding set


def assert_grads_close(got: Sequence[torch.Tensor], ref: Sequence[torch.Tensor],
                       names: Sequence[str], what: str = "",
                       rounding: Optional[Sequence[float]] = None) -> GradCheck:
    """Every gradient in ``got`` finite and within rtol 1e-3 and atol 1e-4 x its scale of
    ``ref``'s (fp32 sums over up to B*H*W tokens per stream, in another order than
    autograd's). Raises on the first gradient that fails.

    A tensor's scale is its reference's own largest magnitude, but at least 1e-8 of the
    largest magnitude of all of ``ref``: a small gradient made by cancellation agrees only
    to ~3e-3 of itself (the stage-4 q/k gradients of the random-weight 224² train step are
    2e-12 to 4e-11 of the step's largest), and the floor still fails a zeroed gradient down
    to 1e-12 of the largest. An exactly-zero gradient (:func:`exact_zero`) is held to the
    call's largest magnitude.

    ``rounding``: where ``ref`` is an fp32 evaluation of the function by another implementation
    (not a plain version of the code under test), each tensor's fp32 rounding: the largest
    distance of an fp32 evaluation from the float64 evaluation of the same code
    (:func:`rounding_of`). It measures how far fp32 moves that gradient, and a fault of the code
    under test does not widen it, since ``got`` takes no part in it. Each tensor's atol is then
    the larger of the above and ROUNDING_NOISE times it: a gradient summed with cancellation over
    thousands of windows (a relative-position table, the q and k gradients of a block whose
    scores barely move) lies further from its exact value in fp32 than 1e-4 of its scale, two
    fp32 evaluations in other orders lie up to about twice that apart, and a wrong gradient lies
    orders of magnitude further.
    """
    own = [float(b.abs().max()) if b.numel() else 0.0 for b in ref]
    call = max(own)
    worst, worst_own, smallest, floored, zeros, zero_noise, widened = 0.0, 0.0, 1.0, 0, [], 0.0, []
    rounding = [0.0] * len(own) if rounding is None else rounding
    for name, a, b, scale, fp32 in zip(names, got, ref, own, rounding):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{what}: the gradient of {name} is not finite")
        noise = ROUNDING_NOISE * fp32
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
        atol = GRAD_ATOL * scale
        if noise > atol:
            atol = noise
            widened.append(name)
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=atol, msg=lambda m: f"{what}, {name}: {m}")
        worst = max(worst, err)
    return GradCheck(worst, worst_own, smallest, floored, tuple(zeros), zero_noise, tuple(widened))


def rounding_of(fp32: Sequence[torch.Tensor], fp64: Sequence[torch.Tensor]) -> list:
    """Each tensor's largest distance between an fp32 evaluation and the float64 evaluation of
    the same code: the ``rounding`` of :func:`assert_grads_close`."""
    return [float((a.double() - b.to(a.device, torch.float64)).abs().max()) if a.numel() else 0.0
            for a, b in zip(fp32, fp64)]


# A bf16 forward of the whole model is held to a reference by image metrics on the
# clamped output, never by a largest difference: rounding flips amplify through the
# stages, and the JAX package's own bf16 routes differ from each other by up to 0.8 at
# isolated pixels. Against an fp32 forward, the JAX package's bar
# (tests/test_bf16_fidelity.py); against another bf16 forward, the JAX package's own
# route-to-route spread with room: its pallas_interpret and jnp bf16 forwards of the tiny
# model in tests/test_torch_bf16_model.py differ by a mean of 5.9e-3 (PSNR 36.7 dB; run
# that file as a script for the table), above the 5e-3 first proposed.
# The maps must keep at least 10% of their pixels inside (0, 1): a map that the clamp
# saturates everywhere compares equal to anything.
BF16_VS_FP32 = dict(min_ssim=0.98, min_psnr=30.0)
BF16_VS_BF16 = dict(max_mean_abs=1e-2, min_psnr=30.0)
MIN_INTERIOR = 0.1


class Fidelity(NamedTuple):
    mean_abs: float
    max_abs: float
    psnr: float  # dB, peak 1
    ssim: float  # mean SSIM index, 11x11 Gaussian window
    interior: float  # the reference's share of pixels strictly inside (0, 1)


def image_fidelity(out, ref) -> Fidelity:
    """Metrics of the clamped fused maps ``out`` against ``ref`` (B, H, W, 1), numpy or
    torch; computed in fp32 on the CPU."""
    from .ops.ssim import psnr, ssim_index

    def cpu(m):
        m = m.detach().cpu() if isinstance(m, torch.Tensor) else torch.from_numpy(np.array(m))
        return m.float().clamp(0.0, 1.0)

    a, b = cpu(out), cpu(ref)
    diff = (a - b).abs()
    return Fidelity(float(diff.mean()), float(diff.max()), float(psnr(a, b)),
                    float(ssim_index(a, b).mean()), float(((b > 0.0) & (b < 1.0)).float().mean()))


def assert_bf16_fidelity(out, ref, ref_dtype: str, what: str = "") -> Fidelity:
    """Hold a bf16 forward's output to a reference forward's: ``ref_dtype`` "float32"
    (SSIM > 0.98 and PSNR > 30 dB) or "bfloat16" (mean |diff| <= 1e-2 and PSNR >= 30 dB),
    on a reference with at least 10% of its pixels inside (0, 1)."""
    f = image_fidelity(out, ref)
    if f.interior < MIN_INTERIOR:
        raise AssertionError(f"{what}: only {f.interior:.1%} of the reference's pixels lie "
                             f"inside (0, 1); the comparison would show nothing")
    if ref_dtype == "float32":
        ok = f.ssim > BF16_VS_FP32["min_ssim"] and f.psnr > BF16_VS_FP32["min_psnr"]
        bar = f"SSIM > {BF16_VS_FP32['min_ssim']} and PSNR > {BF16_VS_FP32['min_psnr']} dB"
    elif ref_dtype == "bfloat16":
        ok = f.mean_abs <= BF16_VS_BF16["max_mean_abs"] and f.psnr >= BF16_VS_BF16["min_psnr"]
        bar = f"mean |diff| <= {BF16_VS_BF16['max_mean_abs']} and PSNR >= {BF16_VS_BF16['min_psnr']} dB"
    else:
        raise ValueError(f"ref_dtype must be 'float32' or 'bfloat16', got {ref_dtype!r}")
    if not ok:
        raise AssertionError(f"{what}: bf16 against the {ref_dtype} forward misses {bar}: {f}")
    return f


class ArrayPairDataset(FusionPairDataset):
    """``n`` seeded pairs of ``hw`` arrays in place of decoded images: IR gray (H, W, 1)
    and VIS YCrCb (H, W, 3), uniform in [0, 1], pair ``i`` drawn from
    ``default_rng((seed, i))``. Everything else (augmentation, batching, prefetch) is
    :class:`~.data.dataset.FusionPairDataset`'s; it needs no folder and no cv2."""

    def __init__(self, n: int, hw: Tuple[int, int], cfg: DataConfig = DataConfig(), seed: int = 0):
        self.is_test = False
        self.cfg = cfg
        self.hw = tuple(hw)
        self.ir_paths = [f"arrays/ir/{i:05d}" for i in range(n)]
        self.vis_paths = [f"arrays/vis/{i:05d}" for i in range(n)]
        self.seed = seed
        self._aug_epoch = 0

    def _read_pair(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng((self.seed, index))
        return (rng.random((*self.hw, 1), dtype=np.float32),
                rng.random((*self.hw, 3), dtype=np.float32))
