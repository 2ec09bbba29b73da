"""Sobel edge magnitude and Canny edges (kornia ``filters.Sobel`` / ``filters.Canny``
parity) in plain PyTorch (port of the JAX ``ops/edges.py``, NHWC).

kornia's Sobel: replicate-pad by 1, a depthwise convolution with the normalised Sobel
pair (each kernel divided by its absolute sum, 8), magnitude ``sqrt(gx^2 + gy^2 + eps)``
with eps 1e-6. The reference trains with it.

The Canny option (``LossConfig.choose_canny_else_sobel``): gaussian blur -> unnormalised
Sobel gradients -> 45-degree non-maximum suppression (strict >) -> double threshold ->
hysteresis to a fixpoint. Its edge map comes from comparisons and carries no gradient.
Each step uses only correctly rounded operations (the blur and the gradients as sums of
shifted slices in a fixed order, the direction from comparisons of |gy| with
tan(22.5°)|gx| and tan(67.5°)|gx|, the bins of ``round(atan2(gy, gx) / 45°)``), so a CUDA
device and the CPU give the same bits; an ``atan2`` differs between them in the last
place, and a pixel near a bin border could change its bin.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .ssim import gaussian_kernel_2d
from .window import device_constant

SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], np.float32)
SOBEL_Y = SOBEL_X.T

# kornia get_canny_nms_kernel direction order: E, SE, S, SW, W, NW, N, NE (y-down)
_NMS_OFFSETS = ((0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1))
# the direction bins' borders at 22.5° and 67.5° as float32 slopes
_TAN_22_5 = float(np.float32(np.tan(np.pi / 8)))
_TAN_67_5 = float(np.float32(np.tan(3 * np.pi / 8)))
# hysteresis runs its 8-neighbour dilation this many steps between two checks for the
# fixpoint (each check reads the device); past the fixpoint a step changes nothing
HYSTERESIS_CHUNK = 8
HYSTERESIS_CHUNKS = 0  # chunks run by every ``canny`` call so far (``chip_smoke.py`` reads it)


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


def _correlate(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """VALID 2-D correlation of (B, 1, Hp, Wp) with a small kernel, summed tap by tap in
    row-major order (zero taps skipped)."""
    kh, kw = kernel.shape
    h, w = x.shape[-2] - kh + 1, x.shape[-1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            k = float(kernel[i, j])
            if k != 0.0:
                term = x[..., i:i + h, j:j + w] * k
                out = term if out is None else out + term
    return out


def _gaussian_blur(x: torch.Tensor, kernel_size: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Gaussian blur of (B, 1, H, W) over a reflect-padded border (kornia
    ``gaussian_blur2d``)."""
    pad = kernel_size // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    return _correlate(xp, gaussian_kernel_2d(kernel_size, sigma))


def _direction(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """``round(atan2(gy, gx) / 45°) mod 8`` (int64), from comparisons and signs."""
    ax, ay = gx.abs(), gy.abs()
    sx, sy = torch.signbit(gx), torch.signbit(gy)
    horizontal = torch.where(sx, 4, 0)  # atan2(±0, -0) is ±pi, as for any negative gx
    vertical = torch.where(sy, 6, 2)
    diagonal = torch.where(sy, torch.where(sx, 5, 7), torch.where(sx, 3, 1))
    return torch.where(ay <= _TAN_22_5 * ax, horizontal,
                       torch.where(ay >= _TAN_67_5 * ax, vertical, diagonal))


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> torch.Tensor:
    """Weak pixels 8-adjacent to strong ones become strong, to the fixpoint."""
    global HYSTERESIS_CHUNKS
    while True:
        before = strong
        for _ in range(HYSTERESIS_CHUNK):
            grown = F.max_pool2d(strong.float(), 3, stride=1, padding=1) > 0
            strong = strong | (weak & grown)
        HYSTERESIS_CHUNKS += 1
        if torch.equal(strong, before):
            return strong


def canny(x: torch.Tensor, *, low_threshold: float = 0.1, high_threshold: float = 0.2,
          kernel_size: int = 5, sigma: float = 1.0, hysteresis: bool = True,
          eps: float = 1e-6) -> tuple:
    """Canny edges of an NHWC image, kornia ``filters.Canny`` parity: (nms magnitude,
    edges), each (B, H, W, 1).

    x: (B, H, W, C) float in [0, 1]; C = 3 is converted to grayscale first (kornia's
    weights). Gaussian blur (reflect border) -> **unnormalised** Sobel gradients
    (replicate border) -> the direction quantised to 45° -> NMS, strictly greater than
    both neighbours along it (zero border) -> double threshold (strict >) -> hysteresis
    to the fixpoint; the edge map keeps the strong set, binary. ``hysteresis=False``
    returns kornia's {0, 0.5, 1} map.
    """
    if x.shape[-1] == 3:  # kornia rgb_to_grayscale
        x = 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]
    if x.shape[-1] != 1:
        raise ValueError(f"canny expects 1 or 3 channels, got {x.shape[-1]}")
    dtype = x.dtype
    blurred = _gaussian_blur(x.float().permute(0, 3, 1, 2), kernel_size, sigma)
    bp = F.pad(blurred, (1, 1, 1, 1), mode="replicate")
    gx, gy = _correlate(bp, SOBEL_X), _correlate(bp, SOBEL_Y)
    magnitude = torch.sqrt(gx * gx + gy * gy + eps)  # (B, 1, H, W)

    idx_pos = _direction(gx, gy)
    idx_neg = torch.remainder(idx_pos + 4, 8)
    h, w = magnitude.shape[-2:]
    mp = F.pad(magnitude, (1, 1, 1, 1))
    diffs = torch.cat([magnitude - mp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                       for dy, dx in _NMS_OFFSETS], dim=1)  # (B, 8, H, W)
    sel_pos = torch.gather(diffs, 1, idx_pos)
    sel_neg = torch.gather(diffs, 1, idx_neg)
    magnitude = magnitude * (torch.minimum(sel_pos, sel_neg) > 0.0)

    low = magnitude > low_threshold
    high = magnitude > high_threshold
    if hysteresis:
        edges = _hysteresis(high, low & ~high).to(dtype)
    else:
        edges = low.to(dtype) * 0.5 + high.to(dtype) * 0.5
    return magnitude.permute(0, 2, 3, 1), edges.permute(0, 2, 3, 1)
