"""Worker of the port's multi-process CPU tests (``test_torch_dp.py``, ``test_torch_spatial.py``):
one rank of a gloo group on the CPU. It imports torch and the port only, runs on one torch
thread, joins its group through a ``FileStore`` and writes what it computed to an ``.npz``.

    python torch_dist_worker.py TASK RANK WORLD STORE_FILE OUT_NPZ ARGS_JSON

Tasks:

- ``dp``: one data-parallel train step of the tiny model (``train.make_train_step(cfg,
  group)``) on this rank's share of a seeded global batch: the averaged gradients, the loss
  terms and the BatchNorm running statistics;
- ``spatial``: ``SpatialFuser`` on seeded pairs of each shape under each route; this
  rank's band, the whole map from ``gather_rows`` and the stages' partitions;
- ``tiled``: ``TiledFuser`` over the group on a seeded pair;
- ``trainer``: a ``Trainer`` over seeded arrays for one epoch, then its checkpoint.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2, att_dims_per_head_ratio=1 / 2)


def global_batch(batch, hw, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((batch, *hw, 1), dtype=np.float32) for _ in range(2)]


def dp(rank, world, args):
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.config import OptimConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_to_jax
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(**TINY, attention_impl=args["impl"]), optim=OptimConfig(lr=1e-3))
    state = create_train_state(cfg, random_variables(cfg.model, args["weights_seed"]), 10, device="cpu")
    ir, vis = global_batch(args["batch"], args["hw"], args["data_seed"])
    share = args["batch"] // world
    mine = [torch.from_numpy(a[rank * share:(rank + 1) * share]) for a in (ir, vis)]
    terms = make_train_step(cfg, dist.group.WORLD)(state, *mine)
    # the averaged gradients the step applied (no clip in this configuration)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    out = {f"grad/{k}": v for k, v in variables_to_jax(grads).items()}
    out.update({f"term/{k}": v.item() for k, v in terms.items()})
    stats = variables_to_jax(dict(state.model.state_dict()))
    out.update({f"stat/{k}": v for k, v in stats.items() if k.startswith("batch_stats/")})
    return out


def spatial(rank, world, args):
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
    from swin_unet_image_fusion_tpu_torch.parallel.spatial import SpatialFuser

    out = {}
    for impl in args["impls"]:
        cfg = ModelConfig(**TINY, attention_impl=impl)
        fuser = SpatialFuser(cfg, random_variables(cfg, args["weights_seed"]), dist.group.WORLD,
                             device="cpu")
        for h, w in args["shapes"]:
            ir, vis = global_batch(1, (h, w), args["data_seed"])
            band = fuser.fuse(ir, vis)
            key = f"{impl}/{h}x{w}"
            out[f"{key}/band"] = band.numpy()
            out[f"{key}/rows"] = np.asarray(fuser.row_range(h))
            out[f"{key}/whole"] = fuser.gather_rows(band, h).numpy()
            out[f"{key}/banded"] = np.asarray([p[2] == "banded" for p in fuser.partitions])
    return out


def tiled(rank, world, args):
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
    from swin_unet_image_fusion_tpu_torch.parallel.tiled import TiledFuser

    cfg = ModelConfig(**TINY)
    ir, vis = global_batch(1, args["hw"], args["data_seed"])
    fuser = TiledFuser(cfg, random_variables(cfg, args["weights_seed"]), tile=args["tile"],
                       overlap=args["overlap"], max_batch=args["max_batch"], device="cpu",
                       group=dist.group.WORLD)
    return {"fused": fuser.fuse(ir[0], vis[0])}


def trainer(rank, world, args):
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.config import DataConfig, LogConfig, OptimConfig, ParallelConfig
    from swin_unet_image_fusion_tpu_torch.testing import ArrayPairDataset
    from swin_unet_image_fusion_tpu_torch.train import Trainer

    sys.modules["torch.utils.tensorboard"] = None  # no writer: its import alone takes ~20 s
    data = DataConfig(crop_size=(28, 28))
    cfg = Config(model=ModelConfig(**TINY), data=data,
                 optim=OptimConfig(batch_size=args["batch"], epochs=1, training_set_ratio=0.75, lr=1e-3),
                 log=LogConfig(print_training_info_in_iters=1, vali_interval_in_iters=2,
                               save_model_interval_in_epochs=1, save_model_to_folder=args["folder"],
                               save_vali_results_to_folder=args["folder"]),
                 parallel=ParallelConfig(use_shard_map=args["shard_map"]))
    t = Trainer(cfg, device="cpu", dataset=ArrayPairDataset(args["pairs"], (32, 32), data, seed=5))
    t.start_train()
    path = t.save_checkpoint()
    return {"path": np.asarray(path), "batch": np.asarray(t.train_loader.batch_size),
            "iters": np.asarray(t.iters_per_epoch)}


def run(task, world, args, folder, timeout=120):
    """Run ``task`` on ``world`` worker processes over a ``FileStore`` in ``folder``; returns
    each rank's outputs. A worker that fails, or a group that does not finish within
    ``timeout`` seconds, fails the caller (every worker is killed first)."""
    store = os.path.join(folder, f"store_{task}")
    outs = [os.path.join(folder, f"{task}_{r}.npz") for r in range(world)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    os.environ.get("PYTHONPATH", "")) if p))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), task, str(r), str(world),
                               store, outs[r], json.dumps(args)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "WORKER_OK" in log, f"{task} rank {r} failed:\n{log}"
    return [dict(np.load(o)) for o in outs]


def main():
    task, rank, world, store, out_path, args = sys.argv[1:7]
    rank, world, args = int(rank), int(world), json.loads(args)
    dist.init_process_group("gloo", store=dist.FileStore(store, int(world)), rank=rank,
                            world_size=world)
    try:
        out = {"dp": dp, "spatial": spatial, "tiled": tiled, "trainer": trainer}[task](rank, world, args)
        np.savez(out_path, **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"WORKER_OK {task} rank={rank}")


if __name__ == "__main__":
    main()
