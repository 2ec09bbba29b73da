"""The port's data-parallel training and process group (``parallel/mesh.py``,
``train.py``) against the JAX package.

- One data-parallel train step (``train.make_train_step(cfg, group)``) of the tiny model
  at 28x28 on a global batch of 4, split over two gloo processes on the CPU
  (``torch_dist_worker.py``), against both JAX steps with the same weights and batch:
  ``make_shard_map_train_step(..., return_grads=True)`` on a 2-device mesh, and the
  one-device gradient, terms and BatchNorm statistics of the global batch; at JAX's own
  tolerances (``tests/test_shard_map_dp.py``): gradients atol 1e-5 x their largest + 1e-6,
  rtol 1e-4 (the two gradients that are rounding noise skipped, as there), loss terms rtol
  1e-5, BatchNorm running statistics atol 1e-5, rtol 1e-4 (flax's biased variance). Both
  ranks take the same update, bit for bit.
- ``process_local_shard`` against JAX's on the ragged lengths 9, 11 and 13;
  ``maybe_initialize_distributed`` does nothing without torchrun's environment and raises
  on a group whose size is not ``WORLD_SIZE``; dropout, ``num_data`` other than 0 or the
  world size each raise.
- A ``Trainer`` over two processes (with ``parallel.use_shard_map`` off and on: the same
  step) writes one checkpoint from rank 0, which a one-process ``Trainer`` resumes bit for
  bit.

About 60 s in one process (the JAX steps' compiles ~30 s, each two-process run ~8 s).
"""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import optim as joptim
from swin_unet_image_fusion_tpu import train as jtrain
from swin_unet_image_fusion_tpu.losses import total_fusion_loss as jax_fusion_loss
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.parallel import mesh as jmesh
from swin_unet_image_fusion_tpu.parallel.shard_map_dp import make_shard_map_train_step as jax_step
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
from swin_unet_image_fusion_tpu_torch.config import DataConfig, OptimConfig, ParallelConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
from swin_unet_image_fusion_tpu_torch.parallel import mesh
from swin_unet_image_fusion_tpu_torch.testing import ArrayPairDataset
from swin_unet_image_fusion_tpu_torch.train import Trainer, make_train_step

import torch_dist_worker as worker
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = worker.TINY
LR = 1e-3
ARGS = dict(impl="torch", hw=[28, 28], batch=4, data_seed=31, weights_seed=32)
REFERENCES = ("shard_map", "global_batch")


def _zero_grad_param(key: str) -> bool:
    """The gradients that are rounding noise on both sides (JAX ``test_shard_map_dp.py``)."""
    return "/k/bias" in key or key == "params/final_head/conv1/bias"


@functools.lru_cache(maxsize=None)
def _jax_reference(reference):
    """JAX's averaged gradients, terms and BN statistics of the global batch: its shard_map
    step on a 2-device mesh, or the one-device gradient of the global batch's loss."""
    flat = random_variables(ModelConfig(**TINY), ARGS["weights_seed"])
    cfg = jcfg.Config(model=jcfg.ModelConfig(**TINY, attention_impl="jnp"), optim=jcfg.OptimConfig(lr=LR))
    variables = unflatten_dict(flat, sep="/")
    model = JaxUNet(cfg.model)
    state = jtrain.TrainState.create(apply_fn=model.apply, params=variables["params"],
                                     tx=joptim.make_optimizer(cfg.optim, 10),
                                     batch_stats=variables["batch_stats"])
    ir, vis = (jnp.asarray(a) for a in worker.global_batch(ARGS["batch"], ARGS["hw"], ARGS["data_seed"]))
    if reference == "shard_map":
        m = jmesh.data_mesh(2)
        data = jmesh.data_sharding(m)
        state = jax.device_put(state, jmesh.replicated_sharding(m))
        new_state, terms, grads = jax_step(cfg, m, return_grads=True)(
            state, jax.device_put(ir, data), jax.device_put(vis, data))
        stats = new_state.batch_stats
    else:
        def loss_fn(params):
            fusion, mutated = model.apply({"params": params, "batch_stats": state.batch_stats},
                                          ir, vis, train=True, mutable=["batch_stats"])
            total, terms = jax_fusion_loss(cfg.loss, jnp.clip(fusion, 0.0, 1.0), ir, vis)
            return total, (terms, mutated["batch_stats"])

        (_, (terms, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.params)
    prefixed = lambda tree, c: {f"{c}/{k}": np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}
    return ({k: float(v) for k, v in terms.items()}, prefixed(grads, "params"),
            prefixed(stats, "batch_stats"))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The step's outputs on both ranks of a two-process gloo group."""
    return worker.run("dp", 2, ARGS, str(tmp_path_factory.mktemp("dp")))


@pytest.mark.parametrize("reference", REFERENCES)
def test_two_rank_step_matches_jax_global_batch(dp_run, reference):
    ref_terms, ref_grads, ref_stats = _jax_reference(reference)
    got = dp_run[0]
    assert {k[len("grad/"):] for k in got if k.startswith("grad/")} == set(ref_grads)
    for key, ref in ref_grads.items():
        if _zero_grad_param(key):
            continue
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got[f"grad/{key}"], ref, atol=1e-5 * scale + 1e-6, rtol=1e-4,
                                   err_msg=key)
    for name, ref in ref_terms.items():
        np.testing.assert_allclose(float(got[f"term/{name}"]), ref, rtol=1e-5, err_msg=name)
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(got[f"stat/{name}"], ref, atol=1e-5, rtol=1e-4, err_msg=name)


def test_the_step_agrees_on_every_rank(dp_run):
    assert set(dp_run[1]) == set(dp_run[0])
    for key, value in dp_run[0].items():
        np.testing.assert_array_equal(dp_run[1][key], value, err_msg=f"rank 1 {key}")


@pytest.mark.parametrize("n", [9, 11, 13])
def test_process_local_shard_matches_jax_on_ragged_lengths(n):
    idx = np.arange(n)
    for count in (2, 3):
        shards = [mesh.process_local_shard(idx, process_index=i, process_count=count)
                  for i in range(count)]
        for i, shard in enumerate(shards):
            np.testing.assert_array_equal(
                shard, jmesh.process_local_shard(idx, process_index=i, process_count=count))
            assert len(shard) == n // count
        assert not set.intersection(*(set(s.tolist()) for s in shards))


def test_maybe_initialize_distributed_without_the_environment_does_nothing(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") == 0
    assert not dist.is_initialized()
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0, True)


def test_maybe_initialize_distributed_raises_on_a_world_size_mismatch(monkeypatch, tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", "1")
        with pytest.raises(RuntimeError, match="WORLD_SIZE=2"):
            mesh.maybe_initialize_distributed("cpu")
        monkeypatch.setenv("WORLD_SIZE", "1")
        assert mesh.maybe_initialize_distributed("cpu") == 0
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ratio", ["attention_drop_ratio", "linear_after_att_drop_ratio", "mlp_drop_ratio"])
def test_data_parallel_with_dropout_raises(ratio, tmp_path):
    cfg = Config(model=ModelConfig(**TINY, **{ratio: 0.1}))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(cfg, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_num_data_other_than_the_world_size_raises():
    assert mesh.data_group_size(0) == mesh.data_group_size(1) == 1
    with pytest.raises(ValueError, match="num_data=2"):
        mesh.data_group_size(2)
    data = DataConfig(crop_size=(28, 28))
    cfg = Config(model=ModelConfig(**TINY), data=data, parallel=ParallelConfig(num_data=4))
    with pytest.raises(ValueError, match="num_data=4"):
        Trainer(cfg, device="cpu", dataset=ArrayPairDataset(4, (32, 32), data, seed=1))


@pytest.mark.parametrize("shard_map", [False, True], ids=["default", "use_shard_map"])
def test_two_process_checkpoint_resumes_at_one_process(tmp_path, monkeypatch, shard_map):
    folder = str(tmp_path / "run")
    outs = worker.run("trainer", 2, dict(batch=5, pairs=12, folder=folder, shard_map=shard_map),
                      str(tmp_path))
    path = str(outs[0]["path"])
    assert all(str(o["path"]) == path for o in outs), "the ranks agree on the checkpoint's name"
    # batch 5 adjusted to 4 over two processes: 2 a rank; 9 training pairs, 4 a rank's shard
    assert [int(o["batch"]) for o in outs] == [2, 2] and [int(o["iters"]) for o in outs] == [2, 2]
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert not any(k.startswith("module.") for k in ckpt["model"])
    data = DataConfig(crop_size=(28, 28))
    cfg = Config(model=ModelConfig(**TINY), data=data, optim=OptimConfig(batch_size=4, epochs=2))
    monkeypatch.setattr(Trainer, "_make_writer", lambda self: None)
    trainer = Trainer(cfg, device="cpu", dataset=ArrayPairDataset(12, (32, 32), data, seed=5))
    trainer.load_checkpoint(path)
    assert (trainer.state.step, trainer.current_epoch) == (ckpt["step"], ckpt["epoch"] + 1) == (2, 2)
    for name, value in trainer.state.model.state_dict().items():
        assert torch.equal(value, ckpt["model"][name]), name
