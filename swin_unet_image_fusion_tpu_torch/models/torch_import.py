"""Reference ``.pth`` checkpoints into the port (port of the JAX ``models/torch_import.py``).

The reference PyTorch model saves ``{model_state, optimizer_state, scheduler_state,
current_epoch}``; its ``model_state`` keys follow its own module tree. :func:`key_map`
holds the one correspondence between those keys and the port's flat flax naming
(``models/from_jax.py``), which import and export (``models/torch_export.py``) both read:

  encoder_list.{k}.1  (PatchMergingAndLinearLayer)        -> enc{k}_merge
  encoder_list.{k}.3  (SelfAndCrossBlockPair)             -> enc{k}_blocks
  decoder_list.{j}.0  (SelfAndCrossBlockPair, j = n-1-k)  -> dec{k}_blocks
  decoder_list.{j}.2  (PatchMergingAndLinearLayer)        -> dec{k}_unmerge
  final_layer.{0,1,3} (conv / BatchNorm / conv)           -> final_head

Within a block pair, ``self_att_block.normal_window_block`` is ``self_normal``,
``self_att_block.shifted_window_block`` ``self_shift``, and ``cross_att_block``'s two are
``cross_normal`` and ``cross_shift``.

Layouts: per-stream (``*_x`` / ``*_y``) pairs stack on the leading stream axis; an
``nn.Linear`` weight (out, in) transposes to (in, out); a 1x1 ``nn.Conv2d`` weight
(out, in, 1, 1) squeezes and transposes to (in, out); the head's 3x3 conv weights keep
torch's (O, I, kh, kw), which is the port's own layout. The reference registers some
modules under several names (``stage_1.other_module``, ``stage_2.other_module``, the MLP's
``sequence_{x,y}``): each entry lists them all, import reads the first and export writes
every one.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from .from_jax import variables_from_jax

BLOCK_NAME_MAP = {
    "self_normal": "self_att_block.normal_window_block",
    "self_shift": "self_att_block.shifted_window_block",
    "cross_normal": "cross_att_block.normal_window_block",
    "cross_shift": "cross_att_block.shifted_window_block",
}
# the layout of an entry's reference tensors: a per-stream pair of nn.Linear weights,
# of 1x1 conv weights, or of tensors kept as they are; one 3x3 conv weight; one tensor
# kept as it is
LINEAR, CONV1X1, PAIR, CONV, SINGLE = "linear", "conv1x1", "pair", "conv", "single"


class Entry(NamedTuple):
    path: str  # the flat flax path (models/from_jax.py)
    layout: str
    names: Tuple  # reference keys, the first read: (x, y) pairs, or keys of a SINGLE


def _pairs(prefixes: List[Tuple[str, str]], leaf: str) -> Tuple[Tuple[str, str], ...]:
    return tuple((f"{x}.{leaf}", f"{y}.{leaf}") for x, y in prefixes)


def _dense(out: List[Entry], path: str, layout: str, prefixes, bias: bool = True) -> None:
    out.append(Entry(f"{path}/kernel", layout, _pairs(prefixes, "weight")))
    if bias:
        out.append(Entry(f"{path}/bias", PAIR, _pairs(prefixes, "bias")))


def _norm(out: List[Entry], path: str, x: str, y: str) -> None:
    out.append(Entry(f"{path}/scale", PAIR, _pairs([(x, y)], "weight")))
    out.append(Entry(f"{path}/bias", PAIR, _pairs([(x, y)], "bias")))


def _block(out: List[Entry], path: str, ref: str, qkv_bias: bool) -> None:
    _norm(out, f"{path}/norm1", f"{ref}.stage_1.norm_layer_1", f"{ref}.stage_1.norm_layer_2")
    _norm(out, f"{path}/norm2", f"{ref}.stage_2.norm_layer_1", f"{ref}.stage_2.norm_layer_2")
    attns = [f"{ref}.auto_path_win_att", f"{ref}.stage_1.other_module"]
    for ours, theirs in (("q", "q_for_heads"), ("k", "k_for_heads"), ("v", "v_for_heads"),
                         ("proj", "linear_projection")):
        prefixes = [(f"{a}.window_attention_x.{theirs}", f"{a}.window_attention_y.{theirs}")
                    for a in attns]
        _dense(out, f"{path}/attn/{ours}", LINEAR, prefixes, qkv_bias or ours == "proj")
    out.append(Entry(f"{path}/attn/rel_pos_bias_table", PAIR, tuple(
        (f"{a}.window_attention_x.relative_position_bias_table",
         f"{a}.window_attention_y.relative_position_bias_table") for a in attns)))
    mlps = [f"{ref}.auto_path_mlp", f"{ref}.stage_2.other_module"]
    for ours, n, seq in (("fc1", 1, 0), ("fc2", 2, 3)):
        prefixes = [p for m in mlps for p in ((f"{m}.mlp_x_{n}", f"{m}.mlp_y_{n}"),
                                               (f"{m}.sequence_x.{seq}", f"{m}.sequence_y.{seq}"))]
        _dense(out, f"{path}/mlp/{ours}", CONV1X1, prefixes)


def _merge(out: List[Entry], path: str, ref: str) -> None:
    _dense(out, f"{path}/linear", CONV1X1, [(f"{ref}.mlp_layer_x", f"{ref}.mlp_layer_y")])
    _norm(out, f"{path}/norm", f"{ref}.layer_norm_x", f"{ref}.layer_norm_y")


def key_map(cfg: ModelConfig) -> List[Entry]:
    """Every variable of the port's model beside the reference keys it comes from."""
    n = cfg.num_stages
    out: List[Entry] = []
    for k in range(n):
        j = n - 1 - k  # decoder_list is ordered [stage n-1 ... stage 0]
        _merge(out, f"params/enc{k}_merge", f"encoder_list.{k}.1")
        for ours, theirs in (("enc", f"encoder_list.{k}.3"), ("dec", f"decoder_list.{j}.0")):
            for block, ref in BLOCK_NAME_MAP.items():
                _block(out, f"params/{ours}{k}_blocks/{block}", f"{theirs}.{ref}", cfg.use_qkv_bias)
        _merge(out, f"params/dec{k}_unmerge", f"decoder_list.{j}.2")
    for conv, ref in (("conv1", "final_layer.0"), ("conv2", "final_layer.3")):
        out.append(Entry(f"params/final_head/{conv}/kernel", CONV, (f"{ref}.weight",)))
        out.append(Entry(f"params/final_head/{conv}/bias", SINGLE, (f"{ref}.bias",)))
    for path, ref in (("params/final_head/bn/scale", "weight"), ("params/final_head/bn/bias", "bias"),
                      ("batch_stats/final_head/bn/mean", "running_mean"),
                      ("batch_stats/final_head/bn/var", "running_var")):
        out.append(Entry(path, SINGLE, (f"final_layer.1.{ref}",)))
    return out


def _read(sd: Mapping, entry: Entry) -> np.ndarray:
    def get(key):
        value = sd[key]
        return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)

    if entry.layout == SINGLE:
        return get(entry.names[0])
    if entry.layout == CONV:  # (O, I, kh, kw) -> flax HWIO
        return get(entry.names[0]).transpose(2, 3, 1, 0)
    x, y = (get(key) for key in entry.names[0])
    if entry.layout in (LINEAR, CONV1X1):  # (out, in[, 1, 1]) -> (in, out)
        x, y = (w.reshape(w.shape[0], w.shape[1]).T for w in (x, y))
    return np.stack([x, y])


def convert_torch_state_dict(state_dict: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference ``model_state`` (torch tensors or anything ``np.asarray`` takes) -> the
    port's state dict, for ``SwinFusionUNet(cfg).load_state_dict``. A missing key raises
    ``KeyError``."""
    return variables_from_jax({e.path: _read(state_dict, e) for e in key_map(cfg)})


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> Tuple[Dict[str, torch.Tensor], int]:
    """A reference ``.pth`` file -> (the port's state dict, the finished epoch). The file
    holds ``{"model_state": ..., "current_epoch": ...}`` or a bare ``model_state``; only
    the model's weights and BatchNorm statistics are read (an optimiser starts fresh).
    The file is unpickled (``weights_only=False``, as the JAX package reads it): load only
    files from a trusted source."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    model_state = state["model_state"] if "model_state" in state else state
    epoch = int(state.get("current_epoch", 0)) if "model_state" in state else 0
    return convert_torch_state_dict(model_state, cfg), epoch
