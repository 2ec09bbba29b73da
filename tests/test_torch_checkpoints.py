"""The port's reference ``.pth`` import and export, its initialisation, its command-line
config and its loss meter, against the JAX package.

- ``.pth`` (``models/torch_import.py``, ``models/torch_export.py``): the JAX export of
  seeded flax variables read by the port equals ``variables_from_jax`` of the same
  variables exactly; the port's export has exactly the JAX export's keys, dtypes and
  values, and JAX's import of it gives the variables back exactly; a file written by
  either ``save_torch_checkpoint`` loads through either ``load_torch_checkpoint`` to the
  same weights and epoch; ``Fuser.from_checkpoint`` on a ``.pth`` serves bit for bit what
  a ``Fuser`` over the variables serves. No file of the reference model is needed.
- ``init_variables``: the keys and shapes of ``jax.jit(SwinFusionUNet(cfg).init)`` on the
  tiny and the default model; each kernel's and each stream's standard deviation within
  sampling bounds of sqrt(2 / fan-in), the relative-position tables N(0, 1) within bounds,
  biases and means exactly 0, scales and variances exactly 1; a seed gives the same bits.
- ``config_from_cli``: the fields of JAX's for the same overrides, and the same errors.
- ``LossMeter``: JAX's means and history for the same records.

About 20 s in one process.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu.models import torch_export as jexport
from swin_unet_image_fusion_tpu.models import torch_import as jimport
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.utils.meters import LossMeter as JaxLossMeter
from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
from swin_unet_image_fusion_tpu_torch.config import config_from_cli
from swin_unet_image_fusion_tpu_torch.models import torch_export, torch_import
from swin_unet_image_fusion_tpu_torch.models.from_jax import (
    flatten_variables,
    init_variables,
    random_variables,
    variables_from_jax,
)
from swin_unet_image_fusion_tpu_torch.utils.meters import LossMeter

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)


def _nested(flat):
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def variables():
    return random_variables(ModelConfig(**TINY), seed=31)


def _jax_export(flat):
    tree = _nested(flat)
    return jexport.export_torch_state_dict(tree["params"], tree["batch_stats"], jcfg.ModelConfig(**TINY))


def test_jax_export_imports_to_variables_from_jax(variables):
    got = torch_import.convert_torch_state_dict(_jax_export(variables), ModelConfig(**TINY))
    ref = variables_from_jax(variables)
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert got[key].dtype == torch.float32 and torch.equal(got[key], value), key


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_port_export_equals_jax_export_and_imports_back(variables, qkv_bias):
    cfg = ModelConfig(**TINY, use_qkv_bias=qkv_bias)
    flat = variables if qkv_bias else random_variables(cfg, seed=32)
    tree = _nested(flat)
    ref = jexport.export_torch_state_dict(tree["params"], tree["batch_stats"],
                                          jcfg.ModelConfig(**TINY, use_qkv_bias=qkv_bias))
    got = torch_export.export_torch_state_dict(variables_from_jax(flat), cfg)
    assert set(got) == set(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        assert got[key].shape == value.shape and got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    params, stats = jimport.convert_torch_state_dict(got, jcfg.ModelConfig(**TINY, use_qkv_bias=qkv_bias))
    back = flatten_variables({"params": params, "batch_stats": stats})
    assert set(back) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_pth_files_round_trip_both_ways(variables, tmp_path):
    cfg, jax_cfg = ModelConfig(**TINY), jcfg.ModelConfig(**TINY)
    tree = _nested(variables)
    model = Fuser(Config(model=cfg), variables, device="cpu").model
    ours, theirs = tmp_path / "port.pth", tmp_path / "jax.pth"
    torch_export.save_torch_checkpoint(str(ours), model, cfg, epoch=7)
    jexport.save_torch_checkpoint(str(theirs), tree["params"], tree["batch_stats"], jax_cfg, epoch=9)
    ref = variables_from_jax(variables)
    for path, epoch in ((ours, 7), (theirs, 9)):
        state, got_epoch = torch_import.load_torch_checkpoint(str(path), cfg)
        assert got_epoch == epoch
        assert set(state) == set(ref) and all(torch.equal(state[k], v) for k, v in ref.items())
        params, stats, jax_epoch = jimport.load_torch_checkpoint(str(path), jax_cfg)
        assert jax_epoch == epoch
        back = flatten_variables({"params": params, "batch_stats": stats})
        for key, value in variables.items():
            np.testing.assert_array_equal(back[key], value, err_msg=key)
    bare = tmp_path / "bare.pth"  # a bare model_state, as inference checkpoints hold it
    torch.save(torch_export.export_torch_state_dict(model, cfg), bare)
    state, epoch = torch_import.load_torch_checkpoint(str(bare), cfg)
    assert epoch == 0 and all(torch.equal(state[k], v) for k, v in ref.items())


def test_fuser_from_a_pth_serves_the_variables_bit_for_bit(variables, tmp_path):
    cfg = Config(model=ModelConfig(**TINY))
    path = tmp_path / "w.pth"
    tree = _nested(variables)
    jexport.save_torch_checkpoint(str(path), tree["params"], tree["batch_stats"], jcfg.ModelConfig(**TINY))
    rng = np.random.default_rng(4)
    ir, vis = (rng.random((2, 30, 26, 1), dtype=np.float32) for _ in range(2))
    got = Fuser.from_checkpoint(cfg, str(path), device="cpu").fuse_y(ir, vis)
    ref = Fuser(cfg, variables, device="cpu").fuse_y(ir, vis)
    np.testing.assert_array_equal(got, ref)


def _jax_init_shapes(model_cfg):
    dummy = jnp.zeros((1, 28, 28, 1), jnp.float32)
    shapes = jax.eval_shape(jax.jit(JaxUNet(model_cfg).init), jax.random.PRNGKey(0), dummy, dummy)
    return {key: tuple(value.shape) for key, value in flatten_dict(shapes, sep="/").items()}


@pytest.mark.parametrize("size", ["tiny", "default"])
def test_init_variables_have_the_jax_init_shapes(size):
    fields = TINY if size == "tiny" else {}
    ref = _jax_init_shapes(jcfg.ModelConfig(**fields))
    got = {key: value.shape for key, value in init_variables(ModelConfig(**fields), 0).items()}
    assert got == ref


def _within(sample: np.ndarray, std: float, what: str) -> None:
    """Mean and standard deviation of ``sample`` within 6 standard errors of N(0, std^2)."""
    n = sample.size
    assert abs(sample.mean()) <= 6 * std / np.sqrt(n), (what, sample.mean(), std)
    assert abs(sample.std() / std - 1) <= 6 / np.sqrt(2 * n) + 1e-6, (what, sample.std(), std)


def _check_distributions(flat) -> None:
    stacked = 0
    for key, value in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        value = np.asarray(value)
        assert value.dtype == np.float32, key
        if leaf == "kernel":
            fan_in = int(np.prod(value.shape[:-1])) if value.ndim == 4 else value.shape[-2]
            _within(value, np.sqrt(2.0 / fan_in), key)
            if value.ndim == 3:  # (S, in, out): each stream's layer on its own
                stacked += 1
                for s in range(value.shape[0]):
                    _within(value[s], np.sqrt(2.0 / value.shape[1]), f"{key} stream {s}")
        elif leaf == "rel_pos_bias_table":
            _within(value, 1.0, key)
        elif leaf in ("scale", "var"):
            assert (value == 1.0).all(), key
        else:
            assert leaf in ("bias", "mean") and (value == 0.0).all(), key
    assert stacked == len([k for k in flat if k.endswith("/kernel")]) - 2  # all but the head's convs


def test_init_variables_follow_the_jax_distributions():
    flat = init_variables(ModelConfig(), seed=0)
    assert sum(v.size for k, v in flat.items() if k.startswith("params/")) == 33_145_973
    _check_distributions(flat)
    # the same rule holds for what JAX's init draws
    dummy = jnp.zeros((1, 28, 28, 1), jnp.float32)
    jax_init = jax.jit(JaxUNet(jcfg.ModelConfig(**TINY)).init)(jax.random.PRNGKey(0), dummy, dummy)
    _check_distributions(flatten_dict(jax.device_get(jax_init), sep="/"))
    again = init_variables(ModelConfig(**TINY), seed=0)
    same = init_variables(ModelConfig(**TINY), seed=0)
    other = init_variables(ModelConfig(**TINY), seed=1)
    assert all(np.array_equal(again[k], same[k]) for k in again)
    assert not np.array_equal(again["params/enc0_merge/linear/kernel"], other["params/enc0_merge/linear/kernel"])


OVERRIDES = ["optim.lr=1e-3", "optim.skip_nonfinite_updates=true", "data.crop_size=(28, 28)",
             "model.attention_jnp_max_tokens=None", "seed=7", "log.using_state_path=/x/y.pth",
             "model.remat=on", "optim.epochs=3", "data.crop_scale=(0.5, 1)",
             "log.tensorboard_log_dir=", "model.attention_drop_ratio=0.25"]


def test_config_from_cli_equals_jax():
    got = config_from_cli(OVERRIDES)
    ref = jcfg.config_from_cli(OVERRIDES)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.optim.lr == 1e-3 and got.optim.skip_nonfinite_updates is True
    assert got.data.crop_size == (28, 28) and got.model.attention_jnp_max_tokens is None
    assert got.seed == 7 and got.model.remat is True and got.data.crop_scale == (0.5, 1.0)
    base = config_from_cli(["optim.batch_size=4"])  # a base config, then more overrides
    assert config_from_cli(["optim.epochs=2"], base=base).optim.batch_size == 4


@pytest.mark.parametrize("arg", ["optim.nope=1", "nope=1", "optim.lr.x=1", "optim.lr=abc",
                                 "optim.drop_last=maybe", "optim.epochs=[1", "optim.lr",
                                 "data.crop_size=5", "model.attention_jnp_max_tokens=x"])
def test_config_from_cli_raises_as_jax_does(arg):
    with pytest.raises(ValueError) as ref:
        jcfg.config_from_cli([arg])
    with pytest.raises(ValueError) as got:
        config_from_cli([arg])
    assert str(got.value) == str(ref.value)


def test_loss_meter_equals_jax():
    rng = np.random.default_rng(8)
    got, ref = LossMeter(), JaxLossMeter()
    assert got.mean_and_clear() == ref.mean_and_clear() == {}
    for window in (1, 3, 4):
        for _ in range(window):
            terms = {"ssim_loss": float(rng.random()), "total_loss": np.float32(rng.random() * 40)}
            got.record(terms)
            ref.record(terms)
        assert len(got) == len(ref) == window
        assert got.mean_and_clear() == ref.mean_and_clear()
    assert got.history == ref.history and len(got) == 0
