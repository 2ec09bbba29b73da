"""Sobel edge magnitude (kornia ``filters.Sobel`` parity) in plain PyTorch (port of the
JAX ``ops/edges.py::sobel_magnitude``, NHWC).

kornia's Sobel: replicate-pad by 1, a depthwise convolution with the normalised Sobel
pair (each kernel divided by its absolute sum, 8), magnitude ``sqrt(gx^2 + gy^2 + eps)``
with eps 1e-6. The reference trains with it. The JAX package's Canny option is not
ported yet: its edge map comes from comparisons and carries no gradient.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .window import device_constant

SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
SOBEL_Y = SOBEL_X.T


@functools.lru_cache(maxsize=8)
def _sobel_kernels(num_channels: int, normalized: bool) -> np.ndarray:
    """(2C, 1, 3, 3) depthwise kernels: per channel, [gx, gy]."""
    kx, ky = SOBEL_X, SOBEL_Y
    if normalized:
        kx = kx / np.abs(kx).sum()
        ky = ky / np.abs(ky).sum()
    k = np.stack([kx, ky])[:, None]  # (2, 1, 3, 3)
    return np.tile(k, (num_channels, 1, 1, 1)).astype(np.float32)


def sobel_magnitude(x: torch.Tensor, *, normalized: bool = True, eps: float = 1e-6) -> torch.Tensor:
    """Sobel edge magnitude of an NHWC image (B, H, W, C): sqrt(gx^2 + gy^2 + eps)."""
    b, h, w, c = x.shape
    kernels = device_constant(_sobel_kernels, (c, normalized), x.device)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    g = F.conv2d(xp, kernels, groups=c).reshape(b, c, 2, h, w)
    return torch.sqrt(torch.sum(g * g, dim=2) + eps).permute(0, 2, 3, 1)
