"""SSIM, MS-SSIM and PSNR in plain PyTorch (port of the JAX ``ops/ssim.py``, NHWC).

The reference's SSIM term is kornia's ``MS_SSIMLoss``: the mixed MS-SSIM +
Gaussian-weighted L1 objective of Zhao et al. (per-scale Gaussians with sigmas
(0.5, 1, 2, 4, 8), luminance from the coarsest scale, contrast-structure product across
scales, an L1 term smoothed by the largest-sigma Gaussian, ``compensation=200`` and
``alpha=0.025``), or ``2 * kornia.losses.ssim_loss`` (11-tap Gaussian, sigma 1.5,
reflect padding). The JAX package computes the blurs as XLA band-matrix einsums; they
are not TPU kernels, so here they are separable depthwise convolutions. The train step
runs them with TF32 off (fp32 parity), so both are exact fp32 and differ only in the
order of their sums.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .window import device_constant

DEFAULT_MS_SIGMAS: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0, 8.0)


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """Normalised 1-D Gaussian, matching kornia/Zhao ``_fspecial_gauss_1d``."""
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def gaussian_kernel_2d(size: int, sigma: float) -> np.ndarray:
    g = gaussian_kernel_1d(size, sigma)
    return np.outer(g, g)


@functools.lru_cache(maxsize=16)
def _bank(size: int, sigmas: Tuple[float, ...]) -> np.ndarray:
    """(M, size): one 1-D Gaussian per slot."""
    return np.stack([gaussian_kernel_1d(size, s) for s in sigmas])


def _blur(x: torch.Tensor, size: int, sigmas: Tuple[float, ...]) -> torch.Tensor:
    """Valid separable Gaussian blur of (B, M, Hp, Wp), slot m with ``sigmas[m]``."""
    m = len(sigmas)
    bank = device_constant(_bank, (size, tuple(sigmas)), x.device)
    x = F.conv2d(x, bank.reshape(m, 1, size, 1), groups=m)
    return F.conv2d(x, bank.reshape(m, 1, 1, size), groups=m)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ms_ssim_l1_loss(img1: torch.Tensor, img2: torch.Tensor, *,
                    sigmas: Tuple[float, ...] = DEFAULT_MS_SIGMAS, data_range: float = 1.0,
                    k: Tuple[float, float] = (0.01, 0.03), alpha: float = 0.025,
                    compensation: float = 200.0) -> torch.Tensor:
    """kornia ``MS_SSIMLoss`` parity: mixed MS-SSIM + Gaussian-weighted L1 (Zhao et al.).

    img1/img2: (B, H, W, C) in [0, data_range], C in (1, 3). Returns the scalar mean
    loss. kornia's mask bank is triplicated per sigma and applied with ``groups=C``: slot
    ``j`` of its 15 is input channel ``j // (3*n_sigmas // C)`` at sigma ``j // 3``, the
    luminance is the product of the three coarsest slots and the contrast-structure term
    the product over all slots. For 1-channel images that cubes both products against
    the textbook formula; kept exactly, as the JAX function does.
    """
    c = img1.shape[-1]
    n_s = len(sigmas)
    if (3 * n_s) % c or 3 % c:
        raise ValueError(f"kornia's grouped MS-SSIM mask bank supports C in (1, 3); got C={c}")
    size = int(4 * sigmas[-1] + 1)
    pad = int(2 * sigmas[-1])
    c1 = (k[0] * data_range) ** 2
    c2 = (k[1] * data_range) ** 2
    x, y = _nchw(img1), _nchw(img2)
    slot_channels = list(np.arange(c * n_s) // n_s)  # channel-major slots (c0s0, c0s1, ..)
    slot_sigmas = tuple(sigmas) * c

    def blur(a):  # (B, C, H, W) -> (B, C*n_s, H, W)
        return _blur(F.pad(a[:, slot_channels], (pad, pad, pad, pad)), size, slot_sigmas)

    mux, muy = blur(x), blur(y)
    mux2, muy2, muxy = mux * mux, muy * muy, mux * muy
    sigmax2 = blur(x * x) - mux2
    sigmay2 = blur(y * y) - muy2
    sigmaxy = blur(x * y) - muxy
    l_map = (2.0 * muxy + c1) / (mux2 + muy2 + c1)  # (B, C*n_s, H, W)
    cs_map = (2.0 * sigmaxy + c2) / (sigmax2 + sigmay2 + c2)

    slots = np.arange(3 * n_s)
    slot_index = list((slots // (3 * n_s // c)) * n_s + slots // 3)  # kornia slot -> ours
    lm = torch.prod(l_map[:, slot_index[-3:]], dim=1)
    pics = torch.prod(cs_map[:, slot_index], dim=1)
    loss_ms_ssim = 1.0 - lm * pics  # (B, H, W)

    # L1 smoothed by the largest-sigma Gaussian, kornia's last three masks averaged
    l1 = torch.abs(x - y)
    smoothed = _blur(F.pad(l1, (pad, pad, pad, pad)), size, (sigmas[-1],) * c)
    gaussian_l1 = smoothed[:, list(np.arange(3) // (3 // c))].mean(dim=1)
    loss_mix = alpha * loss_ms_ssim + (1.0 - alpha) * gaussian_l1 / data_range
    return compensation * loss_mix.mean()


def ssim_index(img1: torch.Tensor, img2: torch.Tensor, *, window_size: int = 11,
               max_val: float = 1.0, sigma: float = 1.5, k: Tuple[float, float] = (0.01, 0.03),
               padding: str = "same") -> torch.Tensor:
    """Per-pixel SSIM map (B, H, W, C), kornia ``metrics.ssim`` parity: a Gaussian window
    over reflect-padded inputs for ``padding="same"``; ``"valid"`` crops the border."""
    c = img1.shape[-1]
    pad = window_size // 2
    c1 = (k[0] * max_val) ** 2
    c2 = (k[1] * max_val) ** 2
    x = F.pad(_nchw(img1), (pad, pad, pad, pad), mode="reflect")
    y = F.pad(_nchw(img2), (pad, pad, pad, pad), mode="reflect")

    def blur(a):
        return _blur(a, window_size, (sigma,) * c)

    mux, muy = blur(x), blur(y)
    mux2, muy2, muxy = mux * mux, muy * muy, mux * muy
    sigmax2 = blur(x * x) - mux2
    sigmay2 = blur(y * y) - muy2
    sigmaxy = blur(x * y) - muxy
    ssim_map = ((2.0 * muxy + c1) * (2.0 * sigmaxy + c2)) / (
        (mux2 + muy2 + c1) * (sigmax2 + sigmay2 + c2))
    if padding == "valid":
        ssim_map = ssim_map[:, :, pad:-pad, pad:-pad]
    return ssim_map.permute(0, 2, 3, 1)


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, *, window_size: int = 11,
              max_val: float = 1.0) -> torch.Tensor:
    """kornia ``ssim_loss`` parity: mean of clamp((1 - SSIM) / 2, 0, 1)."""
    s = ssim_index(img1, img2, window_size=window_size, max_val=max_val)
    return torch.clamp((1.0 - s) / 2.0, 0.0, 1.0).mean()


def psnr(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img1.float() - img2.float()) ** 2)
    return 10.0 * torch.log10(max_val**2 / mse)


def psnr_loss(img1: torch.Tensor, img2: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """kornia ``PSNRLoss`` parity: negative PSNR."""
    return -psnr(img1, img2, max_val)
