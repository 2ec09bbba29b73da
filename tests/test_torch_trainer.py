"""The port's ``Trainer`` and ``start_main`` against the JAX package's, and on their own.

- Against JAX: a ``.pth`` written by the JAX ``save_torch_checkpoint`` from seeded
  variables, loaded by JAX's ``Trainer(cfg, use_mesh=False)`` under ``attention_impl="jnp"``
  and by the port's ``Trainer(cfg, device="cpu")`` (``"auto"``, the torch composition on the
  CPU); each trains one epoch of the tiny model over the same folder of PNG pairs (8
  pairs, crop 28x28, batch 2, terms fetched every step, no checkpoint within the run):
  the loss terms of every step agree to rtol 1e-4 and the logged learning rates to 1e-6.
- Resume: a fresh ``Trainer`` that loads a checkpoint holds the saving run's model, Adam
  state, ``step``, ``updates``, ``notfinite`` and next epoch bit for bit, and one step of
  each on the same batch gives the same bits; ``Fuser.from_checkpoint`` reads the same
  file's model.
- ``start_main(cfg, device="cpu")`` from a ``.pth`` and from its own checkpoint, with the
  TensorBoard event file, the validation grid and the checkpoints it writes.
- Outside a process group, ``num_data=2`` raises and ``use_shard_map`` takes the one-device step
  (data-parallel training itself: ``tests/test_torch_dp.py``).

About 60 s in one process, most of it the JAX trainer's compile.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from flax.traverse_util import unflatten_dict  # noqa: E402

from swin_unet_image_fusion_tpu import config as jcfg  # noqa: E402
from swin_unet_image_fusion_tpu import train as jtrain  # noqa: E402
from swin_unet_image_fusion_tpu.models.torch_export import save_torch_checkpoint  # noqa: E402
from swin_unet_image_fusion_tpu_torch import Fuser  # noqa: E402
from swin_unet_image_fusion_tpu_torch import config as tcfg  # noqa: E402
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables  # noqa: E402
from swin_unet_image_fusion_tpu_torch.testing import ArrayPairDataset  # noqa: E402
from swin_unet_image_fusion_tpu_torch.train import Trainer, start_main  # noqa: E402

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
PAIRS = 8


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    (root / "ir").mkdir()
    (root / "vis").mkdir()
    rng = np.random.default_rng(12)
    for i in range(PAIRS):
        cv2.imwrite(str(root / "ir" / f"{i}.png"), (rng.random((48, 56)) * 255).astype(np.uint8))
        cv2.imwrite(str(root / "vis" / f"{i}.png"), (rng.random((48, 56, 3)) * 255).astype(np.uint8))
    return str(root)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pth") / "start.pth")
    tree = unflatten_dict(random_variables(tcfg.ModelConfig(**TINY), seed=51), sep="/")
    save_torch_checkpoint(path, tree["params"], tree["batch_stats"], jcfg.ModelConfig(**TINY))
    return path


def _config(pkg, tmp, folder, impl, **log):
    log = {**dict(print_training_info_in_iters=1, vali_interval_in_iters=100,
                  save_model_interval_in_epochs=2, save_model_to_folder=os.path.join(tmp, "ckpt"),
                  save_vali_results_to_folder=os.path.join(tmp, "vali"),
                  tensorboard_log_dir=os.path.join(tmp, "tb")), **log}
    return pkg.Config(model=pkg.ModelConfig(**TINY, attention_impl=impl),
                      optim=pkg.OptimConfig(batch_size=2, epochs=1),
                      data=pkg.DataConfig(training_dataset_folder=folder, crop_size=(28, 28)),
                      log=pkg.LogConfig(**log))


def _record(trainer):
    """The (step, terms, lr) the trainer logs, in place of its TensorBoard scalars."""
    logged = []
    trainer._submit_scalars = lambda step, terms, lr: logged.append((step, terms, lr))
    return logged


def test_trainer_matches_the_jax_trainer_from_the_same_pth(folder, pth, tmp_path):
    ref = jtrain.Trainer(_config(jcfg, str(tmp_path / "jax"), folder, "jnp"), use_mesh=False)
    got = Trainer(_config(tcfg, str(tmp_path / "port"), folder, "auto"), device="cpu")
    runs = []
    for trainer in (ref, got):
        trainer.load_torch_checkpoint(pth)
        assert trainer.current_epoch == 1
        logged = _record(trainer)
        trainer.start_train()
        runs.append(logged)
    ref_log, got_log = runs
    assert [s for s, _, _ in got_log] == [s for s, _, _ in ref_log] == [1, 2, 3, 4]
    for (step, terms, lr), (_, ref_terms, ref_lr) in zip(got_log, ref_log):
        assert set(terms) == set(ref_terms)
        for name, value in terms.items():
            np.testing.assert_allclose(value, ref_terms[name], rtol=1e-4, err_msg=f"step {step} {name}")
        np.testing.assert_allclose(lr, ref_lr, rtol=1e-6, err_msg=f"step {step} lr")
    assert not os.path.exists(tmp_path / "port" / "ckpt")  # no checkpoint within the run


def _state_tensors(trainer):
    st = trainer.state
    opt = st.optimizer.state_dict()
    tensors = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    for index, per in opt["state"].items():
        tensors.update({f"adam.{index}.{k}": v for k, v in per.items()})
    return tensors, (st.step, st.updates, st.notfinite, opt["param_groups"])


def test_resumed_trainer_equals_the_saved_one_and_steps_the_same(tmp_path):
    cfg = _config(tcfg, str(tmp_path), "unused", "auto")
    data = tcfg.DataConfig(crop_size=(28, 28))

    def trainer():
        return Trainer(cfg, device="cpu", dataset=ArrayPairDataset(PAIRS, (40, 44), data, seed=3))

    saved = trainer()
    saved.train_one_epoch_with_vali()
    saved.state.notfinite = 2  # a count in flight is saved too
    path = saved.save_checkpoint()
    assert not path.endswith(".pth") and os.path.basename(path).endswith("_epoch1")
    served = Fuser.from_checkpoint(cfg, path, device="cpu").model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in saved.state.model.state_dict().items())
    resumed = trainer()
    resumed.load_checkpoint(path)
    assert resumed.current_epoch == 2
    tensors, counts = _state_tensors(saved)
    rtensors, rcounts = _state_tensors(resumed)
    assert rcounts == counts and counts[:3] == (4, 4, 2)
    assert set(rtensors) == set(tensors)
    for key, value in tensors.items():
        assert rtensors[key].dtype == value.dtype and torch.equal(rtensors[key], value), key

    batch = next(iter(saved.train_loader))
    ir, vis = torch.from_numpy(batch["ir"]), torch.from_numpy(batch["vis"])
    terms = [t.train_step(t.state, ir, vis) for t in (saved, resumed)]
    for name, value in terms[0].items():
        assert torch.equal(terms[1][name], value), name
    after, _ = _state_tensors(saved)
    rafter, _ = _state_tensors(resumed)
    for key, value in after.items():
        assert torch.equal(rafter[key], value), key


def test_start_main_from_a_pth_then_from_its_checkpoint(folder, pth, tmp_path):
    cfg = _config(tcfg, str(tmp_path), folder, "auto", vali_interval_in_iters=2,
                  save_model_interval_in_epochs=1, use_saved_state=True, using_state_path=pth)
    cfg = tcfg.config_from_cli(["optim.training_set_ratio=0.75"], base=cfg)
    first = start_main(cfg, device="cpu")  # 6 training pairs: 3 steps, 2 validation pairs
    assert (first.current_epoch, first.state.step) == (1, 3)
    checkpoints = os.listdir(tmp_path / "ckpt")
    assert len(checkpoints) == 1 and checkpoints[0].endswith("_epoch1")
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    grids = os.listdir(tmp_path / "vali")
    assert len(grids) == 1 and grids[0].endswith("_Epoch1_EpIters2_TotalIters2.png")

    resume = tcfg.config_from_cli(["optim.epochs=2", "log.vali_interval_in_iters=100",
                                   f"log.using_state_path={tmp_path / 'ckpt' / checkpoints[0]}"], base=cfg)
    second = start_main(resume, device="cpu")
    assert (second.current_epoch, second.state.step, second.state.updates) == (2, 6, 6)
    assert sorted(os.listdir(tmp_path / "ckpt"))[-1].endswith("_epoch2")


@pytest.mark.parametrize("parallel", [dict(num_data=2), dict(use_shard_map=True)])
def test_data_parallel_training_is_not_ported_and_raises(parallel, tmp_path):
    """Data-parallel training is ported (``tests/test_torch_dp.py`` holds it against JAX).
    Outside a process group ``num_data=2`` asks for a width that one process cannot give and
    raises; ``use_shard_map`` names the same data-parallel step, which outside a group is the
    one-device step, as the JAX ``Trainer``'s is on a one-device mesh."""
    cfg = _config(tcfg, str(tmp_path), "unused", "auto")
    cfg = tcfg.Config(model=cfg.model, optim=cfg.optim, data=cfg.data, log=cfg.log,
                      parallel=tcfg.ParallelConfig(**parallel))
    if parallel.get("num_data"):
        with pytest.raises(ValueError, match="num_data=2"):
            Trainer(cfg, device="cpu", dataset=ArrayPairDataset(PAIRS, (40, 44), cfg.data))
        return
    trainer = Trainer(cfg, device="cpu", dataset=ArrayPairDataset(PAIRS, (40, 44), cfg.data))
    assert (trainer.world, trainer.group) == (1, None)
