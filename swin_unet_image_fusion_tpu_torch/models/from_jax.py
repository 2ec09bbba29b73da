"""Carry flax variables of the JAX ``SwinFusionUNet`` into the port's state dict.

The flat naming joins the flax path with "/", collection first:
``params/enc0_blocks/self_normal/attn/q/kernel``, ``params/final_head/conv1/kernel``,
``batch_stats/final_head/bn/mean``. The port's modules mirror the flax tree, so each
key maps to the state-dict key of the same path joined with "."; stacked ``(S, ...)``
weights keep their shape. The one change of layout: flax conv kernels
``(kh, kw, in, out)`` become torch conv weights ``(out, in, kh, kw)`` named ``weight``.

Load the result with ``model.load_state_dict(...)`` (strict by default), so a missing
or extra key, or a wrong shape, raises. ``variables_to_jax`` is the inverse: a state dict
(or any dict of tensors by parameter or buffer name, such as gradients) back to flat flax
naming. ``random_variables`` makes seeded numpy weights in the same flat naming without
JAX, for the tests and ``chip_smoke.py``; ``init_variables`` draws a model's starting
weights from the distributions of the JAX ``model.init``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from .unet import SwinFusionUNet

COLLECTIONS = ("params", "batch_stats")
BATCH_STATS_LEAVES = ("mean", "var")  # the model's only buffers: the head's BatchNorm


def flatten_variables(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested ``{"params": {...}, "batch_stats": {...}}`` -> flat "/"-joined numpy dict.

    An already flat dict comes back unchanged (as numpy arrays).
    """
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(flatten_variables(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def variables_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables -> the port's state dict (float32)."""
    state = {}
    for key, value in flat.items():
        collection, *path = key.split("/")
        if collection not in COLLECTIONS or not path:
            raise KeyError(f"{key!r} is not a flax variable path under {COLLECTIONS}")
        arr = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel" and arr.ndim == 4:  # conv (kh, kw, in, out)
            arr = arr.transpose(3, 2, 0, 1)
            path[-1] = "weight"
        state[".".join(path)] = torch.tensor(arr)  # a copy: JAX arrays are read-only
    return state


def variables_to_jax(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's state dict (or tensors named as its keys) -> flat flax variables:
    the inverse of :func:`variables_from_jax`. BatchNorm's running ``mean``/``var`` go to
    ``batch_stats``, everything else to ``params``."""
    flat = {}
    for name, tensor in tensors.items():
        path = name.split(".")
        arr = tensor.detach().cpu().numpy()
        if path[-1] == "weight" and arr.ndim == 4:  # torch conv (out, in, kh, kw)
            arr = arr.transpose(2, 3, 1, 0)
            path[-1] = "kernel"
        collection = "batch_stats" if path[-1] in BATCH_STATS_LEAVES else "params"
        flat["/".join([collection, *path])] = arr
    return flat


def flax_variable_shapes(model: nn.Module) -> Dict[str, Tuple[int, ...]]:
    """The flat flax paths and shapes of a port module's variables: the inverse of
    :func:`variables_from_jax` applied to the module's state dict."""
    buffers = {name for name, _ in model.named_buffers()}
    shapes = {}
    for name, tensor in model.state_dict().items():
        path = name.split(".")
        shape = tuple(tensor.shape)
        if path[-1] == "weight" and tensor.ndim == 4:  # torch conv (out, in, kh, kw)
            path[-1] = "kernel"
            shape = (shape[2], shape[3], shape[1], shape[0])
        collection = "batch_stats" if name in buffers else "params"
        shapes["/".join([collection, *path])] = shape
    return shapes


def random_variables_like(shapes: Mapping[str, Tuple[int, ...]], seed: int) -> Dict[str, np.ndarray]:
    """Seeded float32 numpy values for flat flax paths, drawn by the variable's role:
    dense and conv kernels He-normal over their fan-in, scales near 1, small biases,
    N(0, 1) relative-position tables, and BatchNorm statistics away from (0, 1)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key in sorted(shapes):
        shape = tuple(shapes[key])
        leaf = key.rsplit("/", 1)[-1]
        normal = rng.standard_normal(shape)
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
            value = normal * np.sqrt(2.0 / fan_in)
        elif leaf == "scale":
            value = 1.0 + 0.1 * normal
        elif leaf == "var":
            value = rng.uniform(0.5, 1.5, shape)
        elif leaf == "rel_pos_bias_table":
            value = normal
        else:  # bias, mean
            value = 0.1 * normal
        flat[key] = value.astype(np.float32)
    return flat


def model_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """The flat flax paths and shapes of the variables of ``SwinFusionUNet(cfg)``."""
    with torch.device("meta"):
        return flax_variable_shapes(SwinFusionUNet(cfg))


def random_variables(cfg: ModelConfig, seed: int) -> Dict[str, np.ndarray]:
    """Seeded numpy variables of the whole model in flat flax naming (no JAX needed)."""
    return random_variables_like(model_shapes(cfg), seed)


def init_variables(cfg: ModelConfig, seed: int) -> Dict[str, np.ndarray]:
    """A model's starting variables in flat flax naming, from the distributions of the
    JAX ``model.init`` (JAX ``models/layers.py``): every kernel He-normal over its fan-in,
    ``N(0, 2 / fan_in)`` (a stacked ``(S, in, out)`` kernel's fan-in is ``in``: the stream
    axis is a batch of layers, ``stacked_kaiming_normal``; a conv's ``kh * kw * in``), the
    relative-position tables ``N(0, 1)``, biases 0, LayerNorm and BatchNorm scales 1,
    BatchNorm's running mean 0 and variance 1.

    The draws come from ``np.random.default_rng(seed)`` over the sorted paths, so the CPU
    and a card start from the same float32 bits; they are not JAX's threefry bits."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in sorted(model_shapes(cfg).items()):
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 else shape[-2]
            value = rng.standard_normal(shape, dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in))
        elif leaf == "rel_pos_bias_table":
            value = rng.standard_normal(shape, dtype=np.float32)
        elif leaf in ("scale", "var"):
            value = np.ones(shape, np.float32)
        else:  # bias, mean
            value = np.zeros(shape, np.float32)
        flat[key] = value
    return flat
