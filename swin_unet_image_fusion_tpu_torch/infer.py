"""Inference entry point: arbitrary-resolution fusion of the visible Y channel (PyTorch port
of the JAX ``infer.py::Fuser.fuse_y``).

``Fuser`` runs the eval forward on the device it was given (``"cuda"`` by default) and
clamps the fused Y to [0, 1]. With ``bucket=N`` it reflect-pads the inputs bottom/right
up to multiples of N and crops the output back; the padding changes the reflect context
at the crop border, so ``bucket=0`` (the default) is parity mode. The inputs go to the
device as fp32; under ``compute_dtype="bfloat16"`` the model casts them there.
:meth:`Fuser.from_checkpoint` loads trained weights: a reference ``.pth`` or the
``Trainer``'s checkpoint file.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import Config
from .models.from_jax import flatten_variables, variables_from_jax, variables_to_jax
from .models.torch_import import load_torch_checkpoint
from .models.unet import SwinFusionUNet
from .ops.shape_plan import pad_amount


class Fuser:
    """Fusion engine on one device.

    ``variables`` are the flax variables of the JAX model, nested
    (``{"params": ..., "batch_stats": ...}``) or flat ("/"-joined paths, as
    :func:`~.models.from_jax.variables_from_jax` takes them).
    """

    def __init__(self, cfg: Config, variables: Mapping, *, bucket: int = 0,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Fuser was asked for a CUDA device and none is available; "
                               "pass device='cpu' to run on the CPU")
        self.cfg = cfg
        self.bucket = bucket
        self.model = SwinFusionUNet(cfg.model)
        self.model.load_state_dict(variables_from_jax(flatten_variables(variables)))
        self.model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, cfg: Config, path: str, *, bucket: int = 0,
                        device: torch.device | str = "cuda") -> "Fuser":
        """A fuser over trained weights: a path ending in ``.pth`` is a reference checkpoint
        (``models/torch_import.py``), any other the ``Trainer``'s checkpoint file (its
        model's state dict)."""
        if path.endswith(".pth"):
            state_dict, _ = load_torch_checkpoint(path, cfg.model)
        else:
            state_dict = torch.load(path, map_location="cpu", weights_only=True)["model"]
        return cls(cfg, variables_to_jax(state_dict), bucket=bucket, device=device)

    @torch.inference_mode()
    def fuse_y(self, ir: np.ndarray, vis_y: np.ndarray) -> np.ndarray:
        """Fuse NHWC float [0,1] arrays; returns the clamped fused Y (B, H, W, 1)."""
        h, w = ir.shape[1], ir.shape[2]
        if self.bucket:
            ph, pw = pad_amount(h, self.bucket), pad_amount(w, self.bucket)
            if ph or pw:
                widths = [(0, 0), (0, ph), (0, pw), (0, 0)]
                ir = np.pad(ir, widths, mode="reflect")
                vis_y = np.pad(vis_y, widths, mode="reflect")
        ir_t = torch.as_tensor(np.asarray(ir, np.float32), device=self.device)
        vis_t = torch.as_tensor(np.asarray(vis_y, np.float32), device=self.device)
        out = torch.clamp(self.model(ir_t, vis_t), 0.0, 1.0)
        return out[:, :h, :w, :].cpu().numpy()
