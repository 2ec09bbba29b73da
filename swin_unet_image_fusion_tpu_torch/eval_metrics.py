"""Standard infrared/visible fusion evaluation metrics (port of the JAX
``eval_metrics.py``).

- EN    — entropy of the fused image
- SD    — standard deviation (contrast)
- SF    — spatial frequency
- MI    — mutual information MI(fused, ir) + MI(fused, vis)
- SCD   — sum of correlations of differences
- Qabf  — gradient-based fusion quality (Xydeas & Petrovic)
- plus SSIM/PSNR re-exported from ``metrics.py``

The histogram and gradient terms take HxW or HxWx1 float arrays in [0, 1] and run in
numpy on the host, as in the JAX package (offline metrics, not losses; the same
arithmetic, so the same values). :func:`score_fusion` computes SSIM and PSNR with
``metrics.py`` on a device, the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import psnr, ssim
from .utils.device import require_device

_BINS = 256


def _to_gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        img = img[..., 0] if img.shape[-1] == 1 else img.mean(-1)
    return np.clip(img, 0.0, 1.0)


def entropy(img: np.ndarray) -> float:
    """EN: Shannon entropy of the 8-bit histogram."""
    g = (_to_gray(img) * 255).round().astype(np.int32)
    hist = np.bincount(g.ravel(), minlength=_BINS).astype(np.float64)
    p = hist / hist.sum()
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def std_deviation(img: np.ndarray) -> float:
    """SD: global standard deviation (in 8-bit units, the conventional scale)."""
    return float((_to_gray(img) * 255).std())


def spatial_frequency(img: np.ndarray) -> float:
    """SF: sqrt(row-frequency^2 + column-frequency^2), 8-bit units."""
    g = _to_gray(img) * 255
    rf = np.sqrt(np.mean(np.diff(g, axis=1) ** 2))
    cf = np.sqrt(np.mean(np.diff(g, axis=0) ** 2))
    return float(np.sqrt(rf**2 + cf**2))


def mutual_information(a: np.ndarray, b: np.ndarray) -> float:
    """MI between two images from their joint 256-bin histogram."""
    ga = (_to_gray(a) * 255).round().astype(np.int32).ravel()
    gb = (_to_gray(b) * 255).round().astype(np.int32).ravel()
    joint = np.zeros((_BINS, _BINS), np.float64)
    np.add.at(joint, (ga, gb), 1.0)
    pxy = joint / joint.sum()
    px = pxy.sum(1, keepdims=True)
    py = pxy.sum(0, keepdims=True)
    nz = pxy > 0
    return float((pxy[nz] * np.log2(pxy[nz] / (px @ py)[nz])).sum())


def fusion_mutual_information(fused, ir, vis) -> float:
    """MI_F = MI(F, IR) + MI(F, VIS) — the standard fusion MI."""
    return mutual_information(fused, ir) + mutual_information(fused, vis)


def scd(fused, ir, vis) -> float:
    """Sum of Correlations of Differences (Aslantas & Bendes)."""

    def corr(x, y):
        x = x - x.mean()
        y = y - y.mean()
        denom = np.sqrt((x**2).sum() * (y**2).sum())
        return float((x * y).sum() / denom) if denom > 0 else 0.0

    f, a, b = _to_gray(fused), _to_gray(ir), _to_gray(vis)
    return corr(f - b, a) + corr(f - a, b)


def _sobel_xy(g: np.ndarray):
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float64)
    ky = kx.T
    gp = np.pad(g, 1, mode="edge")
    h, w = g.shape
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    for dy in range(3):
        for dx in range(3):
            patch = gp[dy: dy + h, dx: dx + w]
            gx += kx[dy, dx] * patch
            gy += ky[dy, dx] * patch
    return gx, gy


def qabf(fused, ir, vis, *, tg=0.9994, kg=-15.0, dg=0.5, ta=0.9879, ka=-22.0, da=0.8) -> float:
    """Qabf: edge-information preservation (Xydeas & Petrovic 2000).

    Standard constants; higher is better, in [0, 1].
    """
    f, a, b = (_to_gray(x) * 255 for x in (fused, ir, vis))

    def strength_angle(g):
        gx, gy = _sobel_xy(g)
        s = np.hypot(gx, gy)
        alpha = np.arctan2(gy, gx + 1e-12)
        return s, alpha

    gf, af = strength_angle(f)
    ga, aa = strength_angle(a)
    gb, ab = strength_angle(b)

    def q_af(gs, als, gf_, af_):
        with np.errstate(divide="ignore", invalid="ignore"):
            g_ratio = np.where(gs > gf_, gf_ / np.where(gs == 0, 1, gs),
                               np.where(gf_ == 0, 0.0, gs / np.where(gf_ == 0, 1, gf_)))
        a_sim = 1.0 - np.abs(als - af_) / (np.pi / 2)
        a_sim = np.abs(a_sim)
        qg = tg / (1 + np.exp(kg * (g_ratio - dg)))
        qa = ta / (1 + np.exp(ka * (a_sim - da)))
        return qg * qa

    qaf = q_af(ga, aa, gf, af)
    qbf = q_af(gb, ab, gf, af)
    wa, wb = ga, gb
    denom = (wa + wb).sum()
    if denom == 0:
        return 0.0
    return float((qaf * wa + qbf * wb).sum() / denom)


def score_fusion(fused, ir, vis, *, device: torch.device | str = "cuda") -> dict:
    """All metrics in one call; returns a plain dict of floats. SSIM and PSNR run on
    ``device`` (the card by default; raises without one unless ``device="cpu"``)."""
    device = require_device(device, "score_fusion")

    def nhwc(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = x[None, :, :, None]
        elif x.ndim == 3:
            x = x[None]
        return torch.as_tensor(x, device=device)

    f, a, b = nhwc(fused), nhwc(ir), nhwc(vis)
    on_device = torch.stack([ssim(f, a), ssim(f, b), psnr(f, a), psnr(f, b)]).tolist()
    return {
        "EN": entropy(fused),
        "SD": std_deviation(fused),
        "SF": spatial_frequency(fused),
        "MI": fusion_mutual_information(fused, ir, vis),
        "SCD": scd(fused, ir, vis),
        "Qabf": qabf(fused, ir, vis),
        **dict(zip(("SSIM_ir", "SSIM_vis", "PSNR_ir", "PSNR_vis"), on_device)),
    }
