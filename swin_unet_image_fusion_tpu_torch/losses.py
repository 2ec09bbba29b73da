"""Unsupervised fusion objective: MS-SSIM + Sobel texture + max-intensity L1 (port of
the JAX ``losses.py``).

  ssim      = [MS-SSIM(fus, ir) * w_ir + MS-SSIM(fus, vis) * (1 - w_ir)] * ssim_scale
  texture   = mean|sobel(fus) - max(sobel(ir), sobel(vis))| * texture_scale
              (Canny's binary edge maps instead with ``choose_canny_else_sobel``)
  intensity = ||fus - max(ir, vis)||_1 / numel * intensity_scale
  psnr      = optional, off by default
  total     = sum(term * ratio), ratios 1/3 each.

Every value returned is a 0-d tensor on the inputs' device; nothing here synchronises
with the host (no ``.item()``), so a caller decides when to read the terms.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .config import LossConfig
from .ops.edges import canny, sobel_magnitude
from .ops.ssim import ms_ssim_l1_loss, psnr_loss, ssim_loss


def ssim_term(cfg: LossConfig, fusion: torch.Tensor, ir: torch.Tensor,
              vis: torch.Tensor) -> torch.Tensor:
    """MS-SSIM + L1 (or doubled single-scale SSIM), 0.2 ir / 0.8 vis by default."""
    if cfg.choose_ms_ssim:
        fus_ir = ms_ssim_l1_loss(fusion, ir)
        fus_vis = ms_ssim_l1_loss(fusion, vis)
    else:
        # kornia ssim_loss is (1 - ssim) / 2; the reference doubles it
        fus_ir = 2.0 * ssim_loss(fusion, ir, window_size=cfg.ssim_window_size)
        fus_vis = 2.0 * ssim_loss(fusion, vis, window_size=cfg.ssim_window_size)
    w = cfg.fus_ir_ssim_weight
    return fus_ir * w + fus_vis * (1.0 - w)


def texture_term(cfg: LossConfig, fusion: torch.Tensor, ir: torch.Tensor,
                 vis: torch.Tensor) -> torch.Tensor:
    """The fused edges should dominate both inputs'. With ``choose_canny_else_sobel`` the
    edges are Canny's binary maps (``canny(x)[1]``), which come from comparisons and carry
    no gradient, in JAX and in kornia alike: they are computed without a graph, in one
    call over the three batches (each image's map is its own, so the maps are those of
    three calls, for a third of the launches and of the hysteresis' device reads)."""
    if cfg.choose_canny_else_sobel:
        with torch.no_grad():
            edges = canny(torch.cat([fusion, ir, vis]))[1]
        edge_fus, edge_ir, edge_vis = torch.split(edges, [len(fusion), len(ir), len(vis)])
    else:
        edge_fus = sobel_magnitude(fusion)
        edge_ir = sobel_magnitude(ir)
        edge_vis = sobel_magnitude(vis)
    return torch.mean(torch.abs(edge_fus - torch.maximum(edge_ir, edge_vis)))


def intensity_term(fusion: torch.Tensor, ir: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
    """L1 toward the elementwise-max image."""
    return torch.sum(torch.abs(fusion - torch.maximum(ir, vis))) / fusion.numel()


def psnr_term(cfg: LossConfig, fusion: torch.Tensor, ir: torch.Tensor,
              vis: torch.Tensor) -> torch.Tensor:
    w = cfg.fus_ir_psnr_weight
    return psnr_loss(fusion, ir) * w + psnr_loss(fusion, vis) * (1.0 - w)


def total_fusion_loss(cfg: LossConfig, fusion: torch.Tensor, ir: torch.Tensor,
                      vis: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted total and the per-term breakdown, all 0-d tensors on the device."""
    the_ssim = ssim_term(cfg, fusion, ir, vis) * cfg.ssim_scale
    texture = texture_term(cfg, fusion, ir, vis) * cfg.texture_scale
    intensity = intensity_term(fusion, ir, vis) * cfg.intensity_scale
    if cfg.use_psnr:
        psnr = psnr_term(cfg, fusion, ir, vis) * cfg.psnr_scale
    else:
        psnr = fusion.new_zeros(())
    total = (the_ssim * cfg.ssim_loss_ratio + texture * cfg.texture_loss_ratio
             + intensity * cfg.intensity_loss_ratio + psnr * cfg.psnr_loss_ratio)
    terms = {"ssim_loss": the_ssim, "texture_loss": texture, "intensity_loss": intensity,
             "psnr_loss": psnr, "total_loss": total}
    return total, terms
