"""The process group of the multi-device paths (port of the JAX ``parallel/mesh.py``).

JAX lays its devices out as a mesh that one program drives; PyTorch runs one process per
GPU, and the group of those processes is the data "mesh": ``parallel.num_data`` is 0 (all
of it) or its size. :func:`maybe_initialize_distributed` joins that group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``),
with NCCL for a CUDA device and gloo for the CPU; without that environment it does
nothing, as JAX's does on one host. :func:`process_local_shard` is the JAX helper, copied.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(device: torch.device | str = "cuda") -> int:
    """Join the process group that torchrun's environment describes, once per process,
    and return this process's rank (0 without that environment, where it does nothing).

    The backend is NCCL for a CUDA ``device`` (the process is bound to
    ``cuda:LOCAL_RANK`` first) and gloo for the CPU. A group already joined is kept; a join
    that fails raises, and so does a group whose size is not ``WORLD_SIZE``: a process that
    went on alone would train on its shard of the data and write the shared checkpoints."""
    if not all(k in os.environ for k in _ENV):
        return rank()
    device = torch.device(device)
    world = int(os.environ["WORLD_SIZE"])
    if not dist.is_initialized():
        backend = "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            backend = "nccl"
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=world)
    if dist.get_world_size() != world:
        raise RuntimeError(f"torch.distributed came up with world size {dist.get_world_size()} "
                           f"but WORLD_SIZE={world}")
    return dist.get_rank()


def world_size(group: Group = None) -> int:
    """The size of ``group`` (the default group when None), 1 outside a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group: Group = None) -> int:
    """This process's rank in ``group`` (the default group when None), 0 outside one."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def data_group_size(num_data: int) -> int:
    """The data-parallel width that ``parallel.num_data`` asks for: 0 means every process,
    and any other value must be the world size (one process drives one GPU)."""
    world = world_size()
    if num_data not in (0, world):
        raise ValueError(f"parallel.num_data={num_data}, but the process group holds {world} "
                         "processes: one process drives one GPU, so num_data is 0 or the world size")
    return world


def process_local_shard(indices, *, process_index: int | None = None, process_count: int | None = None):
    """Split a dataset index list across hosts (each host feeds its local devices).

    Every host's shard is trimmed to the common length ``len(indices) // pc``:
    strided slicing alone gives hosts lengths that differ by one when
    ``len(indices) % pc != 0``, and since each host iterates its own loader in the
    collective train/eval loops, a ragged shard would make hosts run different
    numbers of collective steps (global-array assembly + DP reduce) and deadlock the
    slice at epoch end.
    """
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    common = len(indices) // pc
    return indices[pi::pc][:common]


class AllReduceMean(torch.autograd.Function):
    """The mean of a tensor over the ranks of a group; its backward is the mean of the
    incoming gradients over the same ranks (each rank's input feeds every rank's output)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def average_(tensors: List[torch.Tensor], group: Group) -> None:
    """Average the fp32 ``tensors`` over the ranks of ``group`` in place: one concatenation,
    one all-reduce, one multi-tensor copy back (a copy a tensor cost a train step +15% on a
    card)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])


def mean_over_ranks(terms: Dict[str, torch.Tensor], group: Group) -> Dict[str, torch.Tensor]:
    """Each 0-d term averaged over the ranks of ``group``, in one all-reduce; the terms as
    they are outside a process group."""
    if not dist.is_initialized():
        return terms
    names = sorted(terms)
    stacked = torch.stack([terms[n].detach().float() for n in names])
    average_([stacked], group)
    return {n: stacked[i] for i, n in enumerate(names)}
