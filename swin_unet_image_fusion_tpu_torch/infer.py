"""Inference entry point: arbitrary-resolution fusion with YCrCb colour reconstruction
(PyTorch port of the JAX ``infer.py``).

``Fuser`` runs the eval forward on the device it was given (``"cuda"`` by default) and
clamps the fused Y to [0, 1]. With ``bucket=N`` it reflect-pads the inputs bottom/right
up to multiples of N and crops the output back; the padding changes the reflect context
at the crop border, so ``bucket=0`` (the default) is parity mode. The inputs go to the
device as fp32; under ``compute_dtype="bfloat16"`` the model casts them there.
:meth:`Fuser.from_checkpoint` loads trained weights: a reference ``.pth`` or the
``Trainer``'s checkpoint file.

:meth:`Fuser.fuse_pair_ycrcb` is the colour path: the visible image's Y channel goes
through the model with the IR image, the fused Y is re-attached to the visible Cr/Cb and
converted to RGB on the device (:func:`ycrcb_to_rgb`, cv2's float ``COLOR_YCrCb2RGB``).
:func:`run_test` fuses a test folder one pair at a time and writes
``{orig}_MKX_SELF.jpg`` files:

    python -m swin_unet_image_fusion_tpu_torch.infer log.using_state_path=weights.pth \\
        data.test_dataset_folder=./test/input data.test_result_folder=./test/output
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np
import torch

from .config import Config, ModelConfig
from .data.dataset import FusionPairDataset
from .models.from_jax import flatten_variables, variables_from_jax, variables_to_jax
from .models.torch_import import load_torch_checkpoint
from .models.unet import SwinFusionUNet
from .ops.shape_plan import pad_amount
from .utils.device import require_device
from .utils.term import green

# cv2's float YCrCb -> RGB (delta 0.5): R = Y + 1.403 (Cr - 1/2),
# G = Y - 0.714 (Cr - 1/2) - 0.344 (Cb - 1/2), B = Y + 1.773 (Cb - 1/2)
_CR_R, _CR_G, _CB_G, _CB_B = 1.403, -0.714, -0.344, 1.773


def load_model(model: SwinFusionUNet | ModelConfig, variables: Mapping,
               device: torch.device) -> SwinFusionUNet:
    """A new eval-mode ``SwinFusionUNet`` on ``device`` holding the flax ``variables``
    (nested or flat). ``model`` is its ``ModelConfig`` or a model whose config is taken;
    that model's own weights are left as they are."""
    cfg = model.cfg if isinstance(model, SwinFusionUNet) else model
    net = SwinFusionUNet(cfg)
    net.load_state_dict(variables_from_jax(flatten_variables(variables)))
    return net.to(device).eval()


def fused_y(model: SwinFusionUNet, ir: torch.Tensor, vis_y: torch.Tensor) -> torch.Tensor:
    """The served output: the model's fused Y of NHWC tensors, clamped to [0, 1]."""
    return torch.clamp(model(ir, vis_y), 0.0, 1.0)


def ycrcb_to_rgb(ycrcb: torch.Tensor) -> torch.Tensor:
    """(..., 3) float YCrCb in [0, 1] -> (..., 3) RGB, cv2's float conversion (not clipped)."""
    y, cr, cb = ycrcb[..., 0:1], ycrcb[..., 1:2] - 0.5, ycrcb[..., 2:3] - 0.5
    return torch.cat([y + cr * _CR_R, y + cr * _CR_G + cb * _CB_G, y + cb * _CB_B], dim=-1)


class Fuser:
    """Fusion engine on one device.

    ``variables`` are the flax variables of the JAX model, nested
    (``{"params": ..., "batch_stats": ...}``) or flat ("/"-joined paths, as
    :func:`~.models.from_jax.variables_from_jax` takes them).
    """

    def __init__(self, cfg: Config, variables: Mapping, *, bucket: int = 0,
                 device: torch.device | str = "cuda"):
        self.device = require_device(device, "Fuser")
        self.cfg = cfg
        self.bucket = bucket
        self.model = load_model(cfg.model, variables, self.device)

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

    def _fuse_y_on_device(self, ir: np.ndarray, vis_y: np.ndarray) -> torch.Tensor:
        h, w = ir.shape[1], ir.shape[2]
        if self.bucket:
            ph, pw = pad_amount(h, self.bucket), pad_amount(w, self.bucket)
            if ph or pw:
                widths = [(0, 0), (0, ph), (0, pw), (0, 0)]
                ir = np.pad(ir, widths, mode="reflect")
                vis_y = np.pad(vis_y, widths, mode="reflect")
        ir_t = torch.as_tensor(np.asarray(ir, np.float32), device=self.device)
        vis_t = torch.as_tensor(np.asarray(vis_y, np.float32), device=self.device)
        return fused_y(self.model, ir_t, vis_t)[:, :h, :w, :]

    @torch.inference_mode()
    def fuse_y(self, ir: np.ndarray, vis_y: np.ndarray) -> np.ndarray:
        """Fuse NHWC float [0,1] arrays; returns the clamped fused Y (B, H, W, 1)."""
        return self._fuse_y_on_device(ir, vis_y).cpu().numpy()

    @torch.inference_mode()
    def fuse_pair_ycrcb(self, ir: np.ndarray, vis_ycrcb: np.ndarray) -> np.ndarray:
        """The colour path: ir (B, H, W, 1) and the visible image as YCrCb (B, H, W, 3), float
        [0, 1]; returns RGB (B, H, W, 3) clipped to [0, 1]. The fused Y, the re-attached
        Cr/Cb and the conversion stay on the device; the RGB crosses back once."""
        fus_y = self._fuse_y_on_device(ir, vis_ycrcb[..., 0:1])
        cr_cb = torch.as_tensor(np.asarray(vis_ycrcb[..., 1:3], np.float32), device=self.device)
        rgb = ycrcb_to_rgb(torch.cat([fus_y, cr_cb], dim=-1))
        return torch.clamp(rgb, 0.0, 1.0).cpu().numpy()


def save_image(rgb: np.ndarray, path: str) -> None:
    """Save an HWC float [0, 1] RGB image as 8 bits (torchvision ``save_image``'s
    rounding), through cv2."""
    import cv2

    arr = np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8)
    cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))


def run_test(cfg: Optional[Config] = None, name_suffix: str = "MKX_SELF", *,
             device: torch.device | str = "cuda") -> None:
    """Fuse every pair of ``cfg.data.test_dataset_folder`` one at a time with the weights
    at ``cfg.log.using_state_path`` and write ``{orig}_{name_suffix}.jpg`` files into
    ``cfg.data.test_result_folder``. ``cfg`` defaults to the command line's
    ``section.key=value`` overrides (:func:`~.config.config_from_cli`)."""
    from .config import config_from_cli

    cfg = cfg or config_from_cli()
    fuser = Fuser.from_checkpoint(cfg, cfg.log.using_state_path, device=device)
    dataset = FusionPairDataset(is_test=True, dataset_folder=cfg.data.test_dataset_folder,
                                cfg=cfg.data)
    os.makedirs(cfg.data.test_result_folder, exist_ok=True)
    for i in range(len(dataset)):
        item = dataset[i]
        rgb = fuser.fuse_pair_ycrcb(item["ir"][None], item["vis"][None])[0]
        orig = os.path.splitext(os.path.basename(item["ir_path"]))[0]
        out_path = os.path.join(cfg.data.test_result_folder, f"{orig}_{name_suffix}.jpg")
        save_image(rgb, out_path)
        print(green(f"Result of {orig} saved to {out_path}"))


if __name__ == "__main__":
    run_test()
