"""swin_unet_image_fusion_tpu_torch: the PyTorch and CUDA port of
``swin_unet_image_fusion_tpu``, the dual-stream Swin U-Net for IR/visible fusion.

The JAX package is the reference this port is tested against; the port imports
neither it nor JAX. Entry points (``Fuser`` serves, ``Trainer`` trains) run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

from .config import Config, ModelConfig
from .models.unet import SwinFusionUNet

__all__ = ["Config", "ModelConfig", "SwinFusionUNet", "Fuser", "Trainer"]


def __getattr__(name):
    # ``Fuser`` and ``Trainer`` on first use: importing ``infer`` or ``train`` with the
    # package would load it twice under ``python -m swin_unet_image_fusion_tpu_torch.infer``
    # (or ``.train``)
    if name == "Fuser":
        from .infer import Fuser
        return Fuser
    if name == "Trainer":
        from .train import Trainer
        return Trainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
