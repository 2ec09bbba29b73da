"""Training: the step and the trainer (port of the JAX ``train.py``: ``make_train_step``,
``make_eval_step``, ``create_train_state``, ``Trainer`` and ``start_main``).

A step is: forward with ``train=True`` (the head's BatchNorm on batch statistics,
its running statistics updated in place), the output clamped to [0, 1] *before* the
loss (the clamp's zero gradient outside the range is part of the reference's training
dynamics), ``total_fusion_loss``, backward, the opt-in guards, the learning rate of the
per-iteration cosine warm-restart schedule, and Adam's update. Under a kernel
configuration the backward runs the backward kernels (``ops/fused_block.py``,
``ops/window_attention.py``, ``ops/window_pack.py``). A step returns the loss terms as
0-d device tensors and never waits for the device.

TF32 stays off for the whole step, backward included (fp32 parity with the JAX
package's ``Precision.HIGHEST``): cuBLAS matmuls and cuDNN convolutions. So does cuBLAS's
reduced-precision reduction of bf16 GEMMs, which would let a split-K GEMM of a
``compute_dtype="bfloat16"`` step reduce its partial sums in bf16 where JAX accumulates in
fp32: the model's forward turns it off while it runs, and the step's scope keeps it off
through the loss and the backward. The caller's settings are restored after the step.

At ``compute_dtype="bfloat16"`` the forward runs in bf16 and returns fp32 at the head (JAX
``models/unet.py:269``); the clamp, the loss, the gradients of the fp32 parameters, the
BatchNorm statistics and Adam's state are fp32, as in the JAX step.

With a nonzero dropout ratio a step draws its per-block dropout seeds from a CPU
``torch.Generator`` seeded from (``cfg.seed``, step): the counterpart of the JAX step's
``fold_in(PRNGKey(cfg.seed), step)``, with other bits and the same determinism (the same
state, batch and step number give the same step). A step with every ratio 0 draws
nothing.

``skip_nonfinite_updates`` is optax's ``apply_if_finite(tx, max_consecutive_errors=100)``
(:func:`~.optim.apply_if_finite`): the state counts the consecutive non-finite steps
(``notfinite``), a finite step resets it, and after more than 100 every further non-finite
update is applied (clip, rate and Adam, ``updates`` advancing) until a finite step comes.
The guard reads one flag from the device per step; without it the step reads nothing.

With a process group the step is data-parallel (:func:`make_train_step`'s ``group``): each
rank runs its share of the global batch, and every rank takes the update the global batch
gives on one device. Dropout does not run data-parallel (:func:`check_data_parallel`).

:class:`Trainer` is the whole training workload on one device, or on one device a process
under ``torchrun --nproc_per_node=N -m swin_unet_image_fusion_tpu_torch.train`` (the JAX
``Trainer``'s multi-host wiring): the dataset
(``data/dataset.py``) split and batched with the JAX package's seeds and prefetched to the
device, a state drawn by :func:`~.models.from_jax.init_variables`, the epoch loop with its
print and validation cadence, loss meters, optional TensorBoard scalars and validation
grids, and checkpoints as one ``torch.save`` file (model, Adam, counts, epoch) named
``{MM.DD.HH.MM}_epoch{N}`` as the JAX package names its Orbax directory. A reference
``.pth`` loads its weights through ``models/torch_import.py``. :func:`start_main` is the
command line: ``python -m swin_unet_image_fusion_tpu_torch.train section.key=value ...``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import Config, config_from_cli
from .data.dataset import BatchLoader, FusionPairDataset, device_prefetch, split_train_val
from .losses import total_fusion_loss
from .models import torch_import
from .models.from_jax import flatten_variables, init_variables, variables_from_jax
from .models.unet import SwinFusionUNet, fp32_accumulation
from .optim import apply_if_finite, clip_by_global_norm_, cosine_warm_restarts_schedule, make_optimizer
from .parallel.mesh import (average_, data_group_size, maybe_initialize_distributed,
                            mean_over_ranks, process_local_shard, world_size)
from .utils.device import require_device
from .utils.meters import LossMeter
from .utils.term import cyan, yellow


@dataclass
class TrainState:
    """The model (in ``train()`` mode), its Adam optimiser and the step counts."""

    model: SwinFusionUNet
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0  # steps taken
    updates: int = 0  # updates applied: the schedule's count (a skipped step adds none)
    notfinite: int = 0  # consecutive non-finite steps under skip_nonfinite_updates


def create_train_state(cfg: Config, variables: Optional[Mapping], iters_per_epoch: int, *,
                       device: torch.device | str = "cuda") -> TrainState:
    """A train state on ``device`` ("cuda" unless the caller passes "cpu") from flax
    variables, nested or flat (as :func:`~.models.from_jax.variables_from_jax` takes), or,
    with ``variables=None``, from :func:`~.models.from_jax.init_variables` of ``cfg.seed``."""
    device = require_device(device, "create_train_state")
    if variables is None:
        variables = init_variables(cfg.model, cfg.seed)
    model = SwinFusionUNet(cfg.model)
    model.load_state_dict(variables_from_jax(flatten_variables(variables)))
    model.to(device).train()
    o = cfg.optim
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), o),
                      schedule=cosine_warm_restarts_schedule(o.lr, o.minimum_lr, o.scheduler_t0,
                                                             iters_per_epoch))


@contextlib.contextmanager
def fp32_mode():
    """TF32 off in cuBLAS matmuls and cuDNN convolutions, and cuBLAS's bf16 GEMMs
    accumulating in fp32 (:func:`~.models.unet.fp32_accumulation`), restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False), fp32_accumulation():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def dropout_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s dropout seeds under ``cfg.seed`` = ``seed``:
    seeded with 32 bits of numpy's ``SeedSequence((seed, step))`` (the CPU generator
    keeps only 32 bits of its seed)."""
    return torch.Generator().manual_seed(int(np.random.SeedSequence((seed & 0xFFFFFFFF, step)).generate_state(1)[0]))


def check_data_parallel(cfg: Config) -> None:
    """Raise for what data-parallel training does not run: dropout. The kernels' hash masks
    are keyed on a token's place in the rank's own batch, so two ranks would draw the same
    masks where the JAX step draws masks over the global batch (ROADMAP.md, Queue 1)."""
    m = cfg.model
    if m.attention_drop_ratio or m.linear_after_att_drop_ratio or m.mlp_drop_ratio:
        raise NotImplementedError("data-parallel training with a nonzero dropout ratio is not "
                                  "ported: the hash masks are keyed on the rank's local batch, "
                                  "not the global one (ROADMAP.md, Queue 1)")


def make_train_step(cfg: Config, group=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, ir, vis, seeds=None) -> terms``: one update of ``state`` in place on
    an (B, H, W, 1) pair. The gradients of the step stay in each parameter's ``.grad``.
    With dropout, ``seeds`` (a sequence of per-block seeds) replaces the step's generator
    (:func:`dropout_generator`).

    With a process ``group`` (``torch.distributed``), the data-parallel step, the
    counterpart of both JAX steps (jitted over a batch-sharded global array, and
    ``parallel/shard_map_dp.py``'s ``psum``s): each rank passes its share of the global
    batch and runs its forward and backward with BatchNorm's moments averaged over the
    group (``models/layers.py::BatchNorm``), then every gradient, the loss terms and the
    BatchNorm running statistics are averaged over the group in one flattened all-reduce
    (``parallel/mesh.py::average_``) before the guard, clip and Adam: every rank takes the
    update the global batch gives on one device. The all-reduce follows the whole
    backward, as JAX's ``psum``s follow its ``grad``."""
    loss_cfg, optim_cfg = cfg.loss, cfg.optim
    if group is not None:
        check_data_parallel(cfg)

    def step(state: TrainState, ir: torch.Tensor, vis: torch.Tensor,
             seeds: Optional[Iterable[int]] = None) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if model.has_dropout and seeds is None:
            seeds = dropout_generator(cfg.seed, state.step)
        with fp32_mode():
            opt.zero_grad(set_to_none=True)
            if group is not None:
                model.final_head.bn.group = group
            fusion = torch.clamp(model(ir, vis, train=True, seeds=seeds), 0.0, 1.0)
            total, terms = total_fusion_loss(loss_cfg, fusion, ir, vis)
            total.backward()
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            if group is not None:
                names = sorted(terms)
                values = torch.stack([terms[n].detach().float() for n in names])
                bn = model.final_head.bn
                average_([*grads, values, bn.mean, bn.var], group)
                terms = {n: values[i] for i, n in enumerate(names)}
            apply = True
            if optim_cfg.skip_nonfinite_updates:
                apply, state.notfinite = apply_if_finite(grads, state.notfinite)
            if apply:
                if optim_cfg.grad_clip_norm > 0.0:
                    clip_by_global_norm_(grads, optim_cfg.grad_clip_norm)
                for param_group in opt.param_groups:
                    param_group["lr"] = state.schedule(state.updates)
                opt.step()
                state.updates += 1
        state.step += 1
        return {name: value.detach() for name, value in terms.items()}

    return step


def make_eval_step(cfg: Config) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                            Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """``step(state, ir, vis) -> (fusion, terms)``: the eval forward (running BatchNorm
    statistics), clamped, and its loss terms."""

    @torch.no_grad()
    def step(state: TrainState, ir: torch.Tensor, vis: torch.Tensor):
        with fp32_mode():
            fusion = torch.clamp(state.model(ir, vis, train=False), 0.0, 1.0)
            _, terms = total_fusion_loss(cfg.loss, fusion, ir, vis)
        return fusion, terms

    return step


def get_time_str() -> str:
    """The checkpoint and validation grid timestamp, ``MM.DD.HH.MM``."""
    return datetime.now().strftime("%m.%d.%H.%M")


class Trainer:
    """The whole training workload (the JAX ``Trainer``, the reference's ``MyTraining``):
    ``start_train`` runs epochs ``current_epoch .. cfg.optim.epochs``, each a pass over the
    shuffled training split with validation every ``vali_interval_in_iters`` steps, and
    saves a checkpoint every ``save_model_interval_in_epochs`` epochs.

    Under torchrun it first joins the process group (``parallel/mesh.py``), one GPU a
    process (``cuda:LOCAL_RANK``), and trains data-parallel over it (``parallel.num_data``
    0 or the world size; ``parallel.use_shard_map`` takes the same step): the batch size
    is made a multiple of the world size, each process loads its shard of the index lists
    (``process_local_shard``) in batches of ``batch_size // world`` with the loader seeds
    ``seed + rank`` and ``seed + 1 + rank``, the logged terms are averaged over the ranks,
    TensorBoard, messages and validation grids come from rank 0, which alone writes the
    checkpoints (which any world size resumes) under a name
    that rank 0 broadcasts, and every rank waits for the write.

    ``dataset`` defaults to a :class:`~.data.dataset.FusionPairDataset` of
    ``cfg.data.training_dataset_folder`` (decoding needs cv2). The loss terms of a step are
    fetched two steps later (``_pending_logs``), so that the loop never waits on the step it
    has just enqueued; the meters and the TensorBoard scalars get them then."""

    def __init__(self, cfg: Config, *, device: torch.device | str = "cuda",
                 dataset: Optional[FusionPairDataset] = None):
        self.device = require_device(device, "Trainer")
        # under torchrun: join the process group first; each process drives its own GPU
        self.rank = maybe_initialize_distributed(self.device)
        if self.device.type == "cuda" and self.device.index is None and world_size() > 1:
            self.device = torch.device("cuda", torch.cuda.current_device())
        world = data_group_size(cfg.parallel.num_data)
        self.world = world
        self.group = dist.group.WORLD if world > 1 else None
        if self.group is not None:
            check_data_parallel(cfg)
        self.is_main_process = self.rank == 0
        self.cfg = cfg
        batch_size = cfg.optim.batch_size
        if world > 1 and batch_size % world:
            adjusted = max(world, (batch_size // world) * world)
            self._print(yellow(f"batch_size {batch_size} does not divide the {world}-process "
                               f"data group; using {adjusted}"))
            batch_size = adjusted
        self.batch_size = batch_size
        if dataset is None:
            dataset = FusionPairDataset(is_test=False, dataset_folder=cfg.data.training_dataset_folder,
                                        cfg=cfg.data, seed=cfg.seed)
        self.dataset = dataset
        tr_idx, val_idx = split_train_val(len(dataset), cfg.optim.training_set_ratio, seed=cfg.seed)
        # each process loads its shard of the index lists and its share of the global batch
        local_batch = batch_size // world
        if world > 1:
            tr_idx, val_idx = process_local_shard(tr_idx), process_local_shard(val_idx)
        self.train_loader = BatchLoader(dataset, tr_idx, local_batch, shuffle=True,
                                        drop_last=cfg.optim.drop_last, seed=cfg.seed + self.rank)
        self.val_loader = BatchLoader(dataset, val_idx, local_batch, shuffle=True,
                                      drop_last=cfg.optim.drop_last, seed=cfg.seed + 1 + self.rank)
        self.iters_per_epoch = max(len(self.train_loader), 1)
        self.state = create_train_state(cfg, None, self.iters_per_epoch, device=self.device)
        self.schedule = self.state.schedule
        self.train_step = make_train_step(cfg, self.group)
        self.eval_step = make_eval_step(cfg)
        self.train_meter = LossMeter()
        self.val_meter = LossMeter()
        self.current_epoch = 1
        self.iter_in_epoch = 1
        self.writer = self._make_writer() if self.is_main_process else None
        self._pending_logs = []  # (step, the step's loss terms on the device)

    def _print(self, message: str) -> None:
        """Print on the main process only: the ranks' terms are averaged, the same on each."""
        if self.is_main_process:
            print(message)

    # ----------------------------------------------------------------- logging
    def _make_writer(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(yellow(f"TensorBoard unavailable ({e}); scalar logging disabled"))
            return None
        return SummaryWriter(log_dir=self.cfg.log.tensorboard_log_dir or None,
                             flush_secs=self.cfg.log.tensorboard_flush_interval_secs)

    @property
    def total_iters(self) -> int:
        return (self.current_epoch - 1) * self.iters_per_epoch + self.iter_in_epoch

    def _submit_scalars(self, step: int, terms: Dict[str, float], lr: float) -> None:
        if self.writer is None:
            return
        for key, value in terms.items():
            self.writer.add_scalar(f"training/{key}", value, global_step=step)
        self.writer.add_scalar("training/lr", lr, global_step=step)

    def _drain_logs(self, force: bool = False) -> None:
        """Fetch the queued steps' terms, all with ``force``, else all but the last two."""
        while self._pending_logs and (force or len(self._pending_logs) > 2):
            step, terms = self._pending_logs.pop(0)
            host_terms = {k: float(v) for k, v in terms.items()}
            self.train_meter.record(host_terms)
            self._submit_scalars(step, host_terms, float(self.schedule(step)))

    # ------------------------------------------------------------------ loops
    def start_train(self) -> None:
        cfg = self.cfg
        self._print(cyan(f"Starting at epoch = {self.current_epoch}, "
                         f"lr = {float(self.schedule(self.total_iters - 1)):.3e}, "
                         f"iters per epoch = {self.iters_per_epoch}, device = {self.device}, "
                         f"processes = {self.world}"))
        epochs = range(self.current_epoch, cfg.optim.epochs + 1)
        try:
            from tqdm import tqdm
            epochs = tqdm(epochs, initial=1, disable=not self.is_main_process)
        except ImportError:
            pass
        for epoch in epochs:
            self.current_epoch = epoch
            self.train_one_epoch_with_vali()
            if epoch % cfg.log.save_model_interval_in_epochs == 0:
                self.save_checkpoint()
        if self.writer is not None:
            self.writer.close()

    def train_one_epoch_with_vali(self) -> None:
        cfg = self.cfg
        self.dataset.set_epoch(self.current_epoch)  # fresh crops each epoch, the same for a seed
        batches = device_prefetch(iter(self.train_loader), depth=cfg.data.prefetch_depth,
                                  device=self.device)
        for i, batch in enumerate(batches, start=1):
            self.iter_in_epoch = i
            step = self.total_iters
            terms = self.train_step(self.state, batch["ir"], batch["vis"])
            self._pending_logs.append((step, terms))
            self._drain_logs()
            if step == 1 or step % cfg.log.print_training_info_in_iters == 0:
                self._drain_logs(force=True)
                means = self.train_meter.mean_and_clear()
                self._print(f"Training: epoch={self.current_epoch} iter={i} total={step} loss={means}")
            if step % cfg.log.vali_interval_in_iters == 0:
                self._print(cyan("Starting validation ..."))
                self.validate()
                means = self.val_meter.mean_and_clear()
                self._print(cyan(f"Vali: epoch={self.current_epoch} total={step} loss={means}"))
        self._drain_logs(force=True)

    def validate(self) -> None:
        if len(self.val_loader) == 0:
            self._print(yellow("validation skipped: val split has no full batch "
                               f"({len(self.val_loader.indices)} images, batch {self.batch_size}) — "
                               "lower training_set_ratio or batch_size to validate"))
            return
        for i, batch in enumerate(device_prefetch(iter(self.val_loader), device=self.device), start=1):
            fusion, terms = self.eval_step(self.state, batch["ir"], batch["vis"])
            if self.group is not None:
                terms = mean_over_ranks(terms, self.group)
            self.val_meter.record({k: float(v) for k, v in terms.items()})
            if i == 1 and self.is_main_process:
                self.save_vali_grid(*(t.cpu().numpy() for t in (batch["ir"], batch["vis"], fusion)))

    # ------------------------------------------------------------- artifacts
    def save_vali_grid(self, ir: np.ndarray, vis: np.ndarray, fusion: np.ndarray) -> None:
        """A PNG grid of (ir | vis | fused) rows, one per pair of the batch, under
        ``save_vali_results_to_folder``; nothing without matplotlib."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            from matplotlib import pyplot as plt
            from mpl_toolkits.axes_grid1 import ImageGrid
        except ImportError:
            return
        os.makedirs(self.cfg.log.save_vali_results_to_folder, exist_ok=True)
        bsz = ir.shape[0]
        fig = plt.figure()
        grid = ImageGrid(fig, 111, nrows_ncols=(bsz, 3), axes_pad=0, share_all=True)
        for i in range(bsz):
            for j, img in enumerate((ir[i], vis[i], fusion[i])):
                ax = grid[i * 3 + j]
                ax.imshow(img.squeeze(-1), cmap="gray")
                ax.set_axis_off()
        fig.subplots_adjust(left=0, right=1, bottom=0, top=1, hspace=0, wspace=0)
        name = (f"{get_time_str()}_Epoch{self.current_epoch}_"
                f"EpIters{self.iter_in_epoch}_TotalIters{self.total_iters}.png")
        path = os.path.join(self.cfg.log.save_vali_results_to_folder, name)
        fig.savefig(path, bbox_inches="tight", pad_inches=0, dpi=1024)
        plt.close(fig)
        print(cyan(f"Validation results saved to '{path}'"))

    # ----------------------------------------------------------- checkpointing
    def _synced_time_str(self) -> str:
        """The timestamp of rank 0, broadcast: a minute boundary must not split the name."""
        if self.group is None:
            return get_time_str()
        stamp = [get_time_str()]
        dist.broadcast_object_list(stamp, src=0, group=self.group)
        return stamp[0]

    def save_checkpoint(self) -> str:
        """One ``torch.save`` file ``{MM.DD.HH.MM}_epoch{N}`` under
        ``save_model_to_folder``: the model's state dict, Adam's, ``step``, ``updates``,
        ``notfinite`` and ``epoch``. Returns its path. Across ranks every rank calls it:
        they agree on the name, rank 0 writes the file (the model as on one device, so
        that it resumes at any world size), and all wait for the write."""
        name = f"{self._synced_time_str()}_epoch{self.current_epoch}"
        path = os.path.abspath(os.path.join(self.cfg.log.save_model_to_folder, name))
        if self.is_main_process:
            os.makedirs(self.cfg.log.save_model_to_folder, exist_ok=True)
            st = self.state
            torch.save({"model": st.model.state_dict(), "optimizer": st.optimizer.state_dict(),
                        "step": st.step, "updates": st.updates, "notfinite": st.notfinite,
                        "epoch": self.current_epoch}, path)
            print(yellow(f"State saved to '{path}'"))
        if self.group is not None:
            dist.barrier(group=self.group)
        return path

    def load_checkpoint(self, path: str) -> None:
        """Resume from :meth:`save_checkpoint`'s file: everything it holds, and training
        continues at its epoch + 1. The loaders' shuffle generators are not saved."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        st = self.state
        st.model.load_state_dict(ckpt["model"])
        st.optimizer.load_state_dict(ckpt["optimizer"])
        st.step, st.updates, st.notfinite = (int(ckpt[k]) for k in ("step", "updates", "notfinite"))
        self.current_epoch = int(ckpt["epoch"]) + 1
        self._print(cyan(f"State loaded from '{path}', resuming at epoch {self.current_epoch}"))

    def load_torch_checkpoint(self, path: str) -> None:
        """Start from a reference ``.pth``: its weights and BatchNorm statistics, a fresh
        Adam, and its epoch + 1."""
        state_dict, epoch = torch_import.load_torch_checkpoint(path, self.cfg.model)
        self.state.model.load_state_dict(state_dict)
        self.state.optimizer = make_optimizer(self.state.model.parameters(), self.cfg.optim)
        self.current_epoch = epoch + 1
        self._print(cyan(f"Torch state imported from '{path}'"))


def start_main(cfg: Optional[Config] = None, *, device: torch.device | str = "cuda") -> Trainer:
    """The training entry point: ``cfg`` (by default from the command line's
    ``section.key=value`` overrides, :func:`~.config.config_from_cli`), resumed from
    ``log.using_state_path`` when ``log.use_saved_state`` is set (a ``.pth`` as a reference
    checkpoint, anything else as :meth:`Trainer.save_checkpoint`'s file), then trained.
    Returns the trainer."""
    cfg = cfg or config_from_cli()
    trainer = Trainer(cfg, device=device)
    path = cfg.log.using_state_path
    if cfg.log.use_saved_state and path:
        if path.endswith(".pth"):
            trainer.load_torch_checkpoint(path)
        else:
            trainer.load_checkpoint(path)
    trainer.start_train()
    return trainer


if __name__ == "__main__":
    start_main()
    if dist.is_initialized():
        dist.destroy_process_group()
