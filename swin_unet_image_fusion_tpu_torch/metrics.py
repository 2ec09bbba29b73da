"""Image-quality metrics for evaluation: SSIM, the MS-SSIM index and PSNR (port of the JAX
``metrics.py``, NHWC tensors).

The evaluation metrics score fusion quality; the training losses live in ``losses.py`` /
``ops/ssim.py``, whose ``ssim_index`` and ``psnr`` are re-exported here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .ops.ssim import _blur, _nchw, gaussian_kernel_2d, psnr, ssim_index  # noqa: F401

DEFAULT_MSSSIM_WEIGHTS: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ssim(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM index over the batch (Wang et al. 2004, Gaussian 11x11 sigma 1.5)."""
    return ssim_index(img1, img2, max_val=max_val).mean()


def ms_ssim_index(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0,
                  weights: Tuple[float, ...] = DEFAULT_MSSSIM_WEIGHTS) -> torch.Tensor:
    """Wang et al.'s multi-scale SSIM *index*: the power-weighted product over
    ``len(weights)`` dyadic scales (VALID 11x11 sigma 1.5 Gaussian windows, 2x2 average
    pooling between scales; each scale's term clamped at 0). The standard evaluation
    MS-SSIM, distinct from the Zhao-style MS-SSIM + L1 training loss in ``ops/ssim.py``.
    The image must keep at least 11 pixels a side at the coarsest scale."""
    x, y = _nchw(img1), _nchw(img2)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    sigmas = (1.5,) * x.shape[1]
    levels = len(weights)
    mcs = []
    for level in range(levels):
        mux, muy = _blur(x, 11, sigmas), _blur(y, 11, sigmas)
        sigmax2 = _blur(x * x, 11, sigmas) - mux * mux
        sigmay2 = _blur(y * y, 11, sigmas) - muy * muy
        sigmaxy = _blur(x * y, 11, sigmas) - mux * muy
        cs_map = (2 * sigmaxy + c2) / (sigmax2 + sigmay2 + c2)
        if level < levels - 1:
            mcs.append(torch.clamp(cs_map.mean(), min=0.0))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
        else:
            l_map = (2 * mux * muy + c1) / (mux * mux + muy * muy + c1)
            mcs.append(torch.clamp((l_map * cs_map).mean(), min=0.0))
    out = torch.ones((), dtype=torch.float32, device=x.device)
    for w, v in zip(weights, mcs):
        out = out * v**w
    return out


__all__ = ["ssim", "ssim_index", "ms_ssim_index", "psnr", "gaussian_kernel_2d"]
