"""SwinFusionUNet: the 5-stage dual-stream Swin U-Net for IR/visible fusion (PyTorch
port of the JAX ``models/unet.py``, NHWC path).

- both streams ride a stacked leading axis (S=2) with stacked per-stream weights;
- per-stage pads and crops come from the static :func:`make_plan`;
- skips are additive and LIFO, recorded after every encoder stage but the last;
- decoder stage k's MLP hidden width is ``in_dims_list[k] * ratio`` while its blocks
  run at ``out_dims_list[k]`` (a quirk of the original model, kept);
- stages whose attention map has at most ``attention_jnp_max_tokens`` tokens run the
  torch composition instead of the kernel, unless ``"cuda_pack"`` packs them: the JAX
  package's static routing on shapes (:meth:`SwinFusionUNet.stage_impls`);
- ``compute_dtype="bfloat16"`` casts the stacked input to bf16 at entry, so every
  activation between layers and the additive skips are bf16, as in the JAX trunk; each
  layer keeps its own rounding points (``models/layers.py``) and the output is cast back
  to fp32 (JAX ``models/unet.py:138, 269``). Parameters stay fp32 and train in fp32: their
  gradients flow back through each layer's cast, and the kernels' bf16 backward forms
  return fp32 weight gradients. The forward turns cuBLAS's reduced-precision reduction of
  bf16 GEMMs off for its duration (:func:`fp32_accumulation`), so the bf16 layers
  accumulate in fp32 as the JAX composition does, whatever the caller's setting; the train
  step holds it off through the backward too;
- dropout (``attention_drop_ratio``, ``linear_after_att_drop_ratio``, ``mlp_drop_ratio``)
  acts in the training forward only, which then takes a seed source: every block draws
  one seed in [0, 2^24) per call, in the order the blocks run (``models/layers.py``);
- ``remat=True`` rematerialises each stage's block pair in training (JAX ``nn.remat`` of
  ``SelfAndCrossBlockPair``, ``models/unet.py:61-66``): the pair runs under
  ``torch.utils.checkpoint`` and its activations are recomputed in the backward. The
  pair's four block seeds are drawn before it runs, so that the recompute replays them;
  the kernels' launch counters see each pair's forward twice.

Inputs ir/vis are (B, H, W, 1); the fused output is (B, H, W, 1).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import COMPUTE_DTYPES, ModelConfig
from ..ops.patch import crop_bottom_right, pad_reflect_bottom_right
from ..ops.shape_plan import make_plan
from ..ops.window_pack import pack_beneficial
from .layers import (
    DropoutSeeds,
    FinalHead,
    PatchMergeLayer,
    PatchUnmergeLayer,
    SelfAndCrossBlockPair,
)

STREAMS = 2  # dual path: (x=ir, y=vis_Y)


@contextlib.contextmanager
def fp32_accumulation():
    """cuBLAS GEMMs on bf16 operands accumulate in fp32: PyTorch's default lets a split-K
    bf16 GEMM reduce its partial sums in bf16, which the JAX composition never does. The
    caller's setting is restored on exit."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


class SwinFusionUNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}; expected one of "
                             f"{COMPUTE_DTYPES}")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        n = cfg.num_stages
        drop_ratios = (cfg.attention_drop_ratio, cfg.linear_after_att_drop_ratio,
                       cfg.mlp_drop_ratio)
        for k in range(n):
            dims = cfg.out_dims_list[k]
            self.add_module(f"enc{k}_merge", PatchMergeLayer(
                STREAMS, cfg.in_dims_list[k], dims, cfg.merging_size, cfg.mlp_activation))
            for role, hidden in (("enc", dims), ("dec", cfg.in_dims_list[k])):
                self.add_module(f"{role}{k}_blocks", SelfAndCrossBlockPair(
                    STREAMS, dims, cfg.att_num_heads, cfg.dims_per_head(dims),
                    cfg.window_size, hidden * cfg.mlp_hidden_dims_ratio,
                    cfg.mlp_activation, cfg.use_qkv_bias, drop_ratios,
                ))
            self.add_module(f"dec{k}_unmerge", PatchUnmergeLayer(
                STREAMS, dims, cfg.in_dims_list[k], cfg.merging_size, cfg.mlp_activation))
        self.final_head = FinalHead(cfg.final_conv_layer_kernel_size, cfg.mlp_activation)

    def stage_impls(self, h: int, w: int, device: torch.device | str) -> tuple:
        """The route each stage runs for an (h, w) input on ``device``: "torch", "cuda"
        (K3), "cuda_pack" (a packed stage: K1 and K2) or "cuda_block" (K4). As the JAX
        model routes: under "cuda_pack" a stage that ``pack_beneficial`` rejects runs
        "cuda"; a stage that is not packed and whose map has at most
        ``attention_jnp_max_tokens`` tokens runs "torch"."""
        cfg = self.cfg
        impl = cfg.resolved_attention_impl(device)
        plan = make_plan(h, w, cfg.num_stages, cfg.merging_size, cfg.window_size)
        gate = cfg.attention_jnp_max_tokens
        routes = []
        for k, p in enumerate(plan):
            route = impl
            if impl == "cuda_pack" and not pack_beneficial(cfg.out_dims_list[k], p.att_hw[1]):
                route = "cuda"
            if (route in ("cuda", "cuda_block") and gate is not None
                    and p.att_hw[0] * p.att_hw[1] <= gate):
                route = "torch"
            routes.append(route)
        return tuple(routes)

    @property
    def has_dropout(self) -> bool:
        cfg = self.cfg
        return bool(cfg.attention_drop_ratio or cfg.linear_after_att_drop_ratio
                    or cfg.mlp_drop_ratio)

    def forward(self, ir: torch.Tensor, vis: torch.Tensor, train: bool = False,
                seeds: Union[torch.Generator, Iterable[int], None] = None) -> torch.Tensor:
        """The fused map (B, H, W, 1). ``train=True`` runs the head's BatchNorm on the
        batch's statistics and updates its running ones (the JAX ``train=True``) and,
        with a nonzero dropout ratio, dropout with the per-block seeds of ``seeds``: a
        CPU ``torch.Generator`` or a sequence of seeds in block order. Without ``train``
        there is no dropout and ``seeds`` is not read. With ``remat`` a training forward
        recomputes each stage's block pair in the backward (module docstring)."""
        cfg = self.cfg
        source = None
        if train:
            if self.has_dropout:
                if seeds is None:
                    raise ValueError("a training forward with dropout needs a seed source: "
                                     "a CPU torch.Generator or a sequence of block seeds")
                source = DropoutSeeds(seeds)
        with fp32_accumulation():
            return self._forward(ir, vis, train, source)

    def _forward(self, ir: torch.Tensor, vis: torch.Tensor, train: bool,
                 seeds: DropoutSeeds | None = None) -> torch.Tensor:
        cfg = self.cfg
        n = cfg.num_stages
        _, h, w, _ = ir.shape
        plan = make_plan(h, w, n, cfg.merging_size, cfg.window_size)
        impls = self.stage_impls(h, w, ir.device)

        x = torch.stack([ir, vis], dim=0).to(self.compute_dtype)  # (S, B, H, W, 1)
        skips = []
        for k in range(n):
            p = plan[k]
            x = pad_reflect_bottom_right(x, p.pad_merge)
            x = getattr(self, f"enc{k}_merge")(x)
            x = pad_reflect_bottom_right(x, p.pad_win)
            x = self._blocks(f"enc{k}_blocks", x, impls[k], train, seeds)
            if k < n - 1:
                skips.append(x)

        for j in range(n):
            k = n - 1 - j  # mirrored encoder stage
            p = plan[k]
            if j > 0:
                x = x + skips.pop()
            x = self._blocks(f"dec{k}_blocks", x, impls[k], train, seeds)
            x = crop_bottom_right(x, p.pad_win)
            x = getattr(self, f"dec{k}_unmerge")(x)
            x = crop_bottom_right(x, p.pad_merge)

        xy = torch.cat([x[0], x[1]], dim=-1)  # (B, H, W, 2): [x_stream, y_stream]
        return self.final_head(xy, train).float()

    def _blocks(self, name: str, x: torch.Tensor, impl: str, train: bool,
                seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """Block pair ``name`` on ``x``; under ``remat`` in training, checkpointed with its
        block seeds drawn first, and with fp32 accumulation entered inside, so that the
        backward's recompute runs what the forward ran."""
        pair = getattr(self, name)
        if not (train and self.cfg.remat):
            return pair(x, impl, seeds)
        drawn = None if seeds is None else [seeds() for _ in pair.ORDER]

        def run(x: torch.Tensor) -> torch.Tensor:
            with fp32_accumulation():
                return pair(x, impl, None if drawn is None else DropoutSeeds(drawn))

        return checkpoint(run, x, use_reentrant=False)
