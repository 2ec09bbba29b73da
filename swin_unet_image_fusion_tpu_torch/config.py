"""Frozen dataclass configuration tree (PyTorch port).

Counterpart of ``swin_unet_image_fusion_tpu/config.py``: the same dataclasses with the
same defaults, kept as a separate copy so that the port never imports the JAX package.
Like the JAX module it imports nothing but the standard library.
The one field whose values differ is ``ModelConfig.attention_impl``: the port knows
``"auto"``, ``"torch"`` (the plain PyTorch composition), ``"cuda"`` (the hand-written
window-attention kernel, ``ops/window_attention.py``; the JAX ``"pallas"``),
``"cuda_pack"`` (the JAX ``"pallas_pack"``: stages that ``pack_beneficial`` accepts run
each block as one fused kernel on window-packed tokens with the re-partition kernel
between blocks, ``ops/fused_block.py`` and ``ops/window_pack.py``; the other stages run
``"cuda"``) and ``"cuda_block"`` (the JAX ``"pallas_block"``: every block as one fused
kernel on the image).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

ATTENTION_IMPLS = ("auto", "torch", "cuda", "cuda_pack", "cuda_block")
COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass(frozen=True)
class ModelConfig:
    """Model shape hyper-parameters (JAX ``config.py::ModelConfig``)."""

    window_size: Tuple[int, int] = (7, 7)
    merging_size: Tuple[int, int] = (2, 2)
    in_dims_list: Tuple[int, ...] = (1, 24, 48, 96, 192)
    out_dims_list: Tuple[int, ...] = (24, 48, 96, 192, 384)
    att_num_heads: int = 8
    att_dims_per_head_ratio: float = 1 / 8
    attention_drop_ratio: float = 0.0
    linear_after_att_drop_ratio: float = 0.0
    mlp_hidden_dims_ratio: int = 4
    mlp_activation: str = "elu"
    mlp_drop_ratio: float = 0.0
    final_conv_layer_kernel_size: int = 3
    use_qkv_bias: bool = True
    # "float32" or "bfloat16" (serving only): the activations' dtype between layers;
    # parameters stay float32, as in the JAX package.
    compute_dtype: str = "float32"
    # "auto" resolves from the device the caller passed: "cuda" on a CUDA device,
    # "torch" on the CPU. A kernel impl ("cuda", "cuda_pack", "cuda_block") on a CPU
    # tensor runs the kernels' plain versions.
    attention_impl: str = "auto"
    # Stages whose attention map has at most this many tokens (H*W) run the torch
    # composition instead of the kernel: the JAX package's static routing on shapes
    # (unet.py, the same field). 49 gates exactly the one-window 7x7 map. A stage that
    # "cuda_pack" packs is never gated.
    attention_jnp_max_tokens: Optional[int] = 49
    remat: bool = False
    bn_axis_name: str = ""

    def resolved_attention_impl(self, device) -> str:
        """Resolve "auto" from the caller's device (a ``torch.device`` or a string such
        as ``"cuda:0"``), never from what the machine has."""
        impl = self.attention_impl
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {impl!r}; expected one of {ATTENTION_IMPLS}")
        if impl == "auto":
            device_type = getattr(device, "type", None) or str(device).split(":")[0]
            impl = "cuda" if device_type == "cuda" else "torch"
        return impl

    @property
    def num_stages(self) -> int:
        return len(self.in_dims_list)

    def dims_per_head(self, stage_dims: int) -> int:
        return math.floor(stage_dims * self.att_dims_per_head_ratio)


@dataclass(frozen=True)
class LossConfig:
    """Loss switches and weights (JAX ``config.py::LossConfig``)."""

    choose_ms_ssim: bool = True
    fus_ir_ssim_weight: float = 0.2
    choose_canny_else_sobel: bool = False
    use_psnr: bool = False
    fus_ir_psnr_weight: float = 0.4
    ssim_scale: float = 0.305
    texture_scale: float = 250.0
    intensity_scale: float = 45.0
    psnr_scale: float = 0.0
    ssim_loss_ratio: float = 1 / 3
    texture_loss_ratio: float = 1 / 3
    intensity_loss_ratio: float = 1 / 3
    psnr_loss_ratio: float = 0.0
    ssim_window_size: int = 11


@dataclass(frozen=True)
class OptimConfig:
    """Optimiser and schedule (JAX ``config.py::OptimConfig``)."""

    lr: float = 1e-2
    minimum_lr: float = 1e-5
    scheduler_t0: int = 20
    epochs: int = 20
    batch_size: int = 20
    training_set_ratio: float = 0.99
    drop_last: bool = True
    grad_clip_norm: float = 0.0
    skip_nonfinite_updates: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset paths and augmentation (JAX ``config.py::DataConfig``)."""

    training_dataset_folder: str = "./data/train"
    test_dataset_folder: str = "./test/input"
    test_result_folder: str = "./test/output"
    crop_size: Tuple[int, int] = (224, 224)
    hflip_prob: float = 0.5
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    crop_ratio: Tuple[float, float] = (3 / 4, 4 / 3)
    prefetch_depth: int = 2


@dataclass(frozen=True)
class LogConfig:
    """Logging and checkpoint cadence (JAX ``config.py::LogConfig``)."""

    use_saved_state: bool = False
    using_state_path: str = ""
    save_model_to_folder: str = "./checkpoints"
    save_vali_results_to_folder: str = "./vali_results"
    print_training_info_in_iters: int = 5
    vali_interval_in_iters: int = 100
    save_model_interval_in_epochs: int = 1
    tensorboard_log_dir: str = ""
    tensorboard_flush_interval_secs: int = 60


@dataclass(frozen=True)
class ParallelConfig:
    """Parallel layout (JAX ``config.py::ParallelConfig``)."""

    data_axis: str = "data"
    space_axis: str = "space"
    num_data: int = 0
    num_space: int = 1
    use_shard_map: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    log: LogConfig = field(default_factory=LogConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    epsilon: float = 1e-10
    seed: int = 0
