"""The port's weights out as a reference ``.pth`` (port of the JAX
``models/torch_export.py``): the inverse of ``models/torch_import.py``, through the same
:func:`~.torch_import.key_map`.

The state dict is keyed exactly as the reference model's ``state_dict()``, every alias of
a module registered under several names included, with the buffers the reference holds
beside its weights (``buffer_to_show_device`` on each merge layer, the head's BatchNorm
``num_batches_tracked``), so that the reference loads it with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from .from_jax import variables_to_jax
from .torch_import import CONV, CONV1X1, LINEAR, SINGLE, key_map


def export_torch_state_dict(state_dict_or_model: Union[nn.Module, Mapping[str, torch.Tensor]],
                            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port's model (or its state dict) -> a reference-keyed state dict of CPU
    tensors."""
    state = state_dict_or_model
    if isinstance(state, nn.Module):
        state = state.state_dict()
    flat = variables_to_jax(state)
    out: Dict[str, np.ndarray] = {}
    for entry in key_map(cfg):
        value = flat[entry.path]
        if entry.layout == SINGLE:
            out[entry.names[0]] = value
        elif entry.layout == CONV:  # flax HWIO -> (O, I, kh, kw)
            out[entry.names[0]] = value.transpose(3, 2, 0, 1)
        else:
            if entry.layout == LINEAR:  # (S, in, out) -> per stream (out, in)
                value = value.transpose(0, 2, 1)
            elif entry.layout == CONV1X1:  # -> per stream (out, in, 1, 1)
                value = value.transpose(0, 2, 1)[..., None, None]
            for x, y in entry.names:
                out[x], out[y] = value[0], value[1]
    for k in range(cfg.num_stages):  # a buffer on each merge layer
        for ref in (f"encoder_list.{k}.1", f"decoder_list.{k}.2"):
            out[f"{ref}.buffer_to_show_device"] = np.zeros((1,), np.float32)
    out["final_layer.1.num_batches_tracked"] = np.asarray(0, np.int64)
    return {key: torch.from_numpy(np.array(value, order="C")) for key, value in out.items()}


def save_torch_checkpoint(path: str, model: Union[nn.Module, Mapping[str, torch.Tensor]],
                          cfg: ModelConfig, epoch: int = 0) -> None:
    """Write a reference-format ``.pth``: the model's state and ``current_epoch``, with an
    empty optimiser and scheduler state (the reference's trainer starts them fresh)."""
    torch.save({
        "model_state": export_torch_state_dict(model, cfg),
        "optimizer_state": {},
        "scheduler_state": {},
        "current_epoch": epoch,
    }, path)
