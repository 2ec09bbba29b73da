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

:func:`config_from_cli` builds a config from ``section.key=value`` overrides, as the JAX
``config_from_cli`` does: ``python -m swin_unet_image_fusion_tpu_torch.train optim.lr=1e-3``.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import sys
import typing
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

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


def _check_key(obj, name: str, dotted_key: str) -> None:
    """Raise unless ``name`` is a field of the dataclass ``obj``, listing the valid keys."""
    names = {f.name for f in dataclasses.fields(obj)}
    if name not in names:
        raise ValueError(
            f"unknown config key {dotted_key!r} ({name!r} is not a field of "
            f"{type(obj).__name__}); valid keys: {', '.join(sorted(names))}"
        )


def _is_optional_field(obj, name: str) -> bool:
    """Whether the dataclass field's annotation is ``Optional[...]`` (accepts None)."""
    t = typing.get_type_hints(type(obj)).get(name)
    return (t is not None and typing.get_origin(t) is typing.Union
            and type(None) in typing.get_args(t))


def _parse_value(value: str, current, optional: bool, dotted_key: str):
    """Parse a command-line string against the field's current value and type; raise on
    a mismatch."""
    if optional and value in ("None", "none", "null"):
        return None
    if isinstance(current, bool):
        low = value.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse {value!r} as bool for {dotted_key!r}")
    if isinstance(current, str):
        return value
    try:
        lit = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        expected = "a literal" if current is None else type(current).__name__
        raise ValueError(f"cannot parse {value!r} for {dotted_key!r} (expected {expected})") from None
    if current is None:
        return lit  # an Optional field that is None now takes the literal as it is
    try:
        return type(current)(lit)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"cannot convert {value!r} to {type(current).__name__} for {dotted_key!r}: {e}"
        ) from None


def _apply_override(cfg: Config, dotted_key: str, raw_value: str) -> Config:
    """One ``section.key=value`` (or top-level ``key=value``) override -> a new config."""
    parts = dotted_key.split(".")
    if len(parts) > 2:
        raise ValueError(f"override key too deep: {dotted_key}")
    if len(parts) == 1:
        key = parts[0]
        _check_key(cfg, key, dotted_key)
        parsed = _parse_value(raw_value, getattr(cfg, key), _is_optional_field(cfg, key), dotted_key)
        return dataclasses.replace(cfg, **{key: parsed})
    section, key = parts
    _check_key(cfg, section, dotted_key)
    sub = getattr(cfg, section)
    _check_key(sub, key, dotted_key)
    parsed = _parse_value(raw_value, getattr(sub, key), _is_optional_field(sub, key), dotted_key)
    return dataclasses.replace(cfg, **{section: dataclasses.replace(sub, **{key: parsed})})


def config_from_cli(argv: Optional[Sequence[str]] = None, base: Optional[Config] = None) -> Config:
    """A config from ``section.key=value`` arguments (``sys.argv[1:]`` by default) applied
    in order to ``base`` (the defaults by default). An unknown or too deep key, an argument
    without ``=`` or a value that does not parse as the field's type raises ``ValueError``;
    ``None`` sets an ``Optional`` field."""
    cfg = base or Config()
    for arg in (sys.argv[1:] if argv is None else argv):
        if "=" not in arg:
            raise ValueError(f"expected key=value override, got: {arg}")
        key, value = arg.split("=", 1)
        cfg = _apply_override(cfg, key, value)
    return cfg
