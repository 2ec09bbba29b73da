"""Dual-stream building blocks (PyTorch port of the JAX ``models/layers.py``, NHWC).

Both modality streams ride a leading stacked axis S (normally 2) of one tensor
``(S, B, H, W, C)``, and every per-stream layer holds its weights stacked on the same
axis, so one batched matmul computes both streams with independent weights. Parameter
names and shapes mirror the flax tree, so ``models/from_jax.py`` loads a flattened
flax variable dict 1:1.

Dropout (training) draws one seed per block call from a :class:`DropoutSeeds` source, in
the JAX package's call order, and every site of the block takes its masks from that seed
with the TPU kernels' counter-based hash (``ops/hash_dropout.py``): in-kernel under
``cuda_pack`` and ``cuda_block`` (all four sites) and under ``cuda`` (the attention
weights); elsewhere in the composition, which keys each token on K4's geometry
(``ops/dropout_layout.py``, ``"k4"``): the attention weights by the query's window of the
zero-padded partition and both tokens' slots in it (the composition's cyclically shifted
windows hold the same tokens on every pair its mask leaves unmasked), the projection's
output and the MLP's hidden and output by the token's window and slot, offset
``slot * cols + c``; on a card each such mask is one launch of ``ops/dropout_mask.py``'s
kernel, on the CPU its plain version. The JAX package draws the composition's masks from flax's threefry
bits instead, which PyTorch cannot reproduce; the hash keeps a dropout step the same on
the CPU and on a card for the same seeds. ``FinalHead``'s BatchNorm uses its running
statistics, or with ``train=True`` the batch's and updates the running ones, as flax
does.
Parameters start as placeholders (zeros, LayerNorm and BatchNorm scales and variances
one); real weights come from ``load_state_dict``.

Numerics: LayerNorm over the trailing channel axis in fp32 with biased variance and
eps 1e-5; under the shift mask scores are **set** to -1e10; the relative-position bias
table is 2-D and shared across heads.

Compute dtype: each layer computes in the dtype of the activation it is given (the model
casts its input once), with the JAX package's rounding points under bf16: dense layers
take bf16 operands (input and kernel) and round their product and the bias add to bf16;
LayerNorm and BatchNorm work in fp32 (LayerNorm casts back to its input's dtype); the
attention scores, their scale and bias and the softmax stay fp32, and the weights are
rounded to bf16 before AV; the head's convs round input, kernel, product and bias add.
PyTorch would promote bf16 with an fp32 parameter to fp32 without a word, so every
parameter is cast where it meets an activation. Under autograd (bf16 training) the
backward follows JAX's rounding where PyTorch's would differ: the ELU derivative is taken
in bf16 op by op (:func:`elu`), and a bf16 input of the training BatchNorm is cast
twice, so that its two gradient paths meet in bf16 as in flax.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.patch import depth_to_space, pad_reflect, space_to_depth
from ..ops.window import (
    apply_shift_mask,
    cyclic_shift,
    device_constant,
    gather_relative_position_bias,
    shift_attention_mask,
    window_partition,
    window_unpartition,
)
from ..ops import dropout_layout as dl
from ..ops import dropout_mask as dm
from ..ops import hash_dropout as hd
from ..ops.fused_block import fused_block
from ..ops.window_attention import window_attention
from ..ops.window_pack import pack_windows, repartition_windows, unpack_windows

SEED_LIMIT = 1 << 24  # a block's seed lies in [0, 2^24), as the JAX layers draw it


class DropoutSeeds:
    """The source of the per-block dropout seeds of one forward: a CPU ``torch.Generator``
    (each seed ``randint(0, 2^24)`` from it) or a sequence of seeds taken in order, as the
    JAX layers draw theirs (``layers.py:310-315``, ``495-499``, ``606-610``). Seeds are
    host ints, so drawing one never waits on the device."""

    def __init__(self, source: Union[torch.Generator, Iterable[int]]):
        self.generator = source if isinstance(source, torch.Generator) else None
        self._seeds = None if self.generator is not None else iter(source)
        self.drawn = 0

    def __call__(self) -> int:
        if self.generator is not None:
            seed = int(torch.randint(0, SEED_LIMIT, (1,), generator=self.generator))
        else:
            try:
                seed = int(next(self._seeds))
            except StopIteration:
                raise ValueError(f"the dropout seed sequence ran out after {self.drawn} "
                                 "blocks") from None
        self.drawn += 1
        return seed


# A block's dropout in the composition: its seed and the keying of its geometry.
Drop = Optional[Tuple[int, dl.Keying]]


def token_dropout(a: torch.Tensor, drop: Drop, site: int, rate: float) -> torch.Tensor:
    """Hash dropout of a token site on (S, B, H, W, cols) in image order (identity
    without dropout or at rate 0)."""
    if drop is None or not rate:
        return a
    seed, key = drop
    return dm.token_dropout(a, seed, site, rate, key)


class _Bf16Elu(torch.autograd.Function):
    """ELU of a bf16 tensor with the JAX package's derivative: ``jax.nn.elu``'s gradient
    at x <= 0 is g * (expm1(x) + 1) taken in bf16, each operation rounded (autograd's
    ELU derivative takes it in fp32 and rounds once). The forward is F.elu's."""

    @staticmethod
    def forward(ctx, x):
        out = F.elu(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        slope = (out.float() + 1.0).to(out.dtype)  # expm1(x) + 1 in bf16
        return torch.where(x > 0, g, (g.float() * slope.float()).to(g.dtype))


def elu(x: torch.Tensor) -> torch.Tensor:
    """ELU, with the JAX package's bf16 derivative rounding on a bf16 tensor that
    autograd records."""
    if x.dtype == torch.bfloat16 and torch.is_grad_enabled() and x.requires_grad:
        return _Bf16Elu.apply(x)
    return F.elu(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in the tanh form, ``jax.nn.gelu``'s default (not the erf form of ``F.gelu``'s)."""
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "elu":
        return elu
    if name == "gelu":
        return gelu
    if name == "relu":
        return F.relu
    raise ValueError(f"unknown activation: {name}")


class StackedDense(nn.Module):
    """Per-stream dense layer: kernel (S, in, out), bias (S, out) (JAX ``StackedDense``)."""

    def __init__(self, streams: int, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(streams, in_features, features))
        self.bias = nn.Parameter(torch.zeros(streams, features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, i, o = self.kernel.shape
        y = (x.reshape(s, -1, i) @ self.kernel.to(x.dtype)).reshape(*x.shape[:-1], o)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape((s,) + (1,) * (x.ndim - 2) + (o,))
        return y

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel, bias) with a zero bias when the layer has none."""
        bias = self.bias if self.bias is not None else self.kernel.new_zeros(self.kernel.shape[::2])
        return self.kernel, bias


class StackedLayerNorm(nn.Module):
    """Per-stream LayerNorm over the trailing channel axis, biased variance (JAX
    ``StackedLayerNorm``): statistics and the affine step in fp32, the output in the
    input's dtype."""

    def __init__(self, streams: int, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(streams, features))
        self.bias = nn.Parameter(torch.zeros(streams, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        xn = (xf - mean) * torch.rsqrt(var + self.epsilon)
        shape = (self.scale.shape[0],) + (1,) * (x.ndim - 2) + (self.scale.shape[1],)
        return (xn * self.scale.reshape(shape) + self.bias.reshape(shape)).to(x.dtype)


class DualWindowAttention(nn.Module):
    """Swin W-MSA / SW-MSA on both streams at once (JAX ``DualWindowAttention``).

    Input/output (S, B, H, W, C) with H, W multiples of the window. ``cross=True`` takes
    k/v from the other stream (stream flip after each stream's own LN1), with stream
    s's weights. ``impl="torch"`` is the composition of the JAX jnp path; ``impl="cuda"``
    calls the K3 kernel's wrapper (its plain version on a CPU tensor), whose dropout of
    the attention weights is in the kernel; the projection's dropout is the
    composition's on either path.
    """

    def __init__(self, streams: int, dims: int, num_heads: int, dims_per_head: int,
                 window_size: Tuple[int, int], shift: bool, cross: bool,
                 use_qkv_bias: bool = True, attention_drop_ratio: float = 0.0,
                 proj_drop_ratio: float = 0.0):
        super().__init__()
        self.attention_drop_ratio = attention_drop_ratio
        self.proj_drop_ratio = proj_drop_ratio
        self.num_heads = num_heads
        self.dims_per_head = dims_per_head
        self.window_size = tuple(window_size)
        self.shift = shift
        self.cross = cross
        inner = num_heads * dims_per_head
        wh, ww = self.window_size
        self.q = StackedDense(streams, dims, inner, use_qkv_bias)
        self.k = StackedDense(streams, dims, inner, use_qkv_bias)
        self.v = StackedDense(streams, dims, inner, use_qkv_bias)
        self.proj = StackedDense(streams, inner, dims, True)
        self.rel_pos_bias_table = nn.Parameter(torch.zeros(streams, 2 * wh - 1, 2 * ww - 1))

    def forward(self, x: torch.Tensor, impl: str = "torch", drop: Drop = None) -> torch.Tensor:
        """``drop``: the block's (seed, keying) in training, None for no dropout."""
        if impl == "cuda":
            out = self._kernel_forward(x, None if drop is None else drop[0])
            return token_dropout(out, drop, hd.SITE_PROJ, self.proj_drop_ratio)
        if impl != "torch":
            raise ValueError(f"unknown attention impl {impl!r}; expected 'torch' or 'cuda'")
        s, b, h, w, _ = x.shape
        if self.shift:
            x = cyclic_shift(x, self.window_size, reverse=False)
        xw = window_partition(x, self.window_size)  # (S, Bw, T, C)
        mask = None
        if self.shift:
            mask = device_constant(shift_attention_mask, ((h, w), self.window_size), x.device)
        out = window_unpartition(self.windows(xw, mask, drop), self.window_size, (h, w))
        if self.shift:
            out = cyclic_shift(out, self.window_size, reverse=True)
        return token_dropout(out, drop, hd.SITE_PROJ, self.proj_drop_ratio)

    def windows(self, xw: torch.Tensor, mask: Optional[torch.Tensor], drop: Drop = None) -> torch.Tensor:
        """The composition's attention on partitioned windows ``xw`` (S, B * nWin, T, C), the
        seams of a shifted partition masked by ``mask`` (nWin, T, T) (None: no mask), and
        the projection; no projection dropout. The banded spatial path calls it on a band's
        windows (``parallel/spatial.py``)."""
        s, bw, t, _ = xw.shape
        heads, d = self.num_heads, self.dims_per_head
        kvw = xw.flip(0) if self.cross else xw

        def split_heads(a):  # (S, Bw, T, inner) -> (S, Bw, heads, T, d)
            return a.reshape(s, bw, t, heads, d).transpose(2, 3)

        q = split_heads(self.q(xw))
        k = split_heads(self.k(kvw))
        v = split_heads(self.v(kvw))
        # scores in fp32 (exact products of the bf16 q and k under bf16)
        scores = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
        bias = gather_relative_position_bias(self.rel_pos_bias_table, self.window_size)
        scores = scores + bias[:, None, None]
        if mask is not None:
            scores = apply_shift_mask(scores, mask)
        weights = torch.softmax(scores, dim=-1)
        if drop is not None and self.attention_drop_ratio:
            seed, key = drop
            weights = dm.attention_dropout(weights, seed, self.attention_drop_ratio, key)
        out = weights.to(v.dtype) @ v
        return self.proj(out.transpose(2, 3).reshape(s, bw, t, heads * d))

    def _kernel_forward(self, x: torch.Tensor, seed: Optional[int] = None) -> torch.Tensor:
        wq, bq = self.q.weights()
        wk, bk = self.k.weights()
        wv, bv = self.v.weights()
        wp, bp = self.proj.weights()
        bias = gather_relative_position_bias(self.rel_pos_bias_table, self.window_size)
        return window_attention(
            x.contiguous(), wq, bq, wk, bk, wv, bv, wp, bp, bias.contiguous(),
            window=self.window_size, num_heads=self.num_heads,
            dims_per_head=self.dims_per_head, shift=self.shift, cross=self.cross,
            attn_drop_rate=self.attention_drop_ratio if seed is not None else 0.0,
            drop_seed=seed,
        )


class DualMLP(nn.Module):
    """Per-stream 2-layer MLP (JAX ``DualMLP``), dropout on the hidden after the
    activation and on the output."""

    def __init__(self, streams: int, dims: int, hidden_dims: int, activation: str = "elu",
                 drop_ratio: float = 0.0):
        super().__init__()
        self.act = activation_fn(activation)
        self.drop_ratio = drop_ratio
        self.fc1 = StackedDense(streams, dims, hidden_dims)
        self.fc2 = StackedDense(streams, hidden_dims, dims)

    def forward(self, x: torch.Tensor, drop: Drop = None) -> torch.Tensor:
        """x (S, B, H, W, C); ``drop``: the block's (seed, keying) in training."""
        hidden = token_dropout(self.act(self.fc1(x)), drop, hd.SITE_MLP_HIDDEN, self.drop_ratio)
        return token_dropout(self.fc2(hidden), drop, hd.SITE_MLP_OUT, self.drop_ratio)


class BasicBlock(nn.Module):
    """Pre-norm block: LN -> window attention -> +res, LN -> MLP -> +res (JAX
    ``BasicBlock``). ``impl="cuda_block"`` runs the whole block as one fused kernel on
    the image (the JAX ``pallas_block``); :meth:`fused` also takes window-packed tokens.
    With ``seeds`` and a nonzero dropout ratio the block draws one seed per call and
    trains with dropout (module docstring)."""

    def __init__(self, streams: int, dims: int, num_heads: int, dims_per_head: int,
                 window_size: Tuple[int, int], shift: bool, cross: bool,
                 mlp_hidden_dims: int, activation: str = "elu", use_qkv_bias: bool = True,
                 attention_drop_ratio: float = 0.0, proj_drop_ratio: float = 0.0,
                 mlp_drop_ratio: float = 0.0):
        super().__init__()
        self.activation = activation
        self.norm1 = StackedLayerNorm(streams, dims)
        self.attn = DualWindowAttention(streams, dims, num_heads, dims_per_head,
                                        window_size, shift, cross, use_qkv_bias,
                                        attention_drop_ratio, proj_drop_ratio)
        self.norm2 = StackedLayerNorm(streams, dims)
        self.mlp = DualMLP(streams, dims, mlp_hidden_dims, activation, mlp_drop_ratio)

    @property
    def drop_rates(self) -> Tuple[float, float, float]:
        """(attention, proj, MLP) dropout ratios."""
        return self.attn.attention_drop_ratio, self.attn.proj_drop_ratio, self.mlp.drop_ratio

    def draw_seed(self, seeds: Optional[DropoutSeeds]) -> Optional[int]:
        """This call's dropout seed: one from ``seeds`` when a ratio is nonzero, else None."""
        return seeds() if seeds is not None and any(self.drop_rates) else None

    def forward(self, x: torch.Tensor, impl: str = "torch",
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        seed = self.draw_seed(seeds)
        if impl == "cuda_block":
            return self.fused(x, "image", seed=seed)
        drop = None
        if seed is not None:
            attn = self.attn
            drop = (seed, dl.keying("k4", x.shape[2:4], attn.window_size, attn.shift,
                                    attn.num_heads, attn.dims_per_head, x.device))
        x = x + self.attn(self.norm1(x), impl, drop)
        return x + self.mlp(self.norm2(x), drop)

    def windows(self, xw: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The composition's block (no dropout) on window-packed tokens ``xw`` (S, B, nWin,
        T, C) in this block's geometry, the seams masked by ``mask`` (nWin, T, T) where the
        block shifts (None where it does not)."""
        s, b, n_win, t, c = xw.shape
        attn = self.attn.windows(self.norm1(xw).reshape(s, b * n_win, t, c), mask)
        xw = xw + attn.reshape(xw.shape)
        return xw + self.mlp(self.norm2(xw))

    def fused_weights(self) -> Tuple[torch.Tensor, ...]:
        """The fused kernels' 17 weight arguments: LN1, q/k/v/proj kernels and biases, the
        gathered relative-position bias, LN2, fc1 and fc2."""
        attn = self.attn
        weights = [t for layer in (attn.q, attn.k, attn.v, attn.proj) for t in layer.weights()]
        bias = gather_relative_position_bias(attn.rel_pos_bias_table, attn.window_size)
        return (self.norm1.scale, self.norm1.bias, *weights, bias.contiguous(), self.norm2.scale,
                self.norm2.bias, *self.mlp.fc1.weights(), *self.mlp.fc2.weights())

    def fused(self, x: torch.Tensor, layout: str, hw: Tuple[int, int] | None = None,
              seed: Optional[int] = None) -> torch.Tensor:
        """The block through the fused kernel's wrapper (its plain version on a CPU
        tensor): ``layout="image"`` for (S, B, H, W, C), ``"windows"`` for the
        ``pack_windows`` tokens of an ``hw`` map in this block's geometry; with a
        ``seed``, the block's dropout in the kernel."""
        attn = self.attn
        return fused_block(
            x.contiguous(), *self.fused_weights(), window=attn.window_size, num_heads=attn.num_heads,
            dims_per_head=attn.dims_per_head, shift=attn.shift, cross=attn.cross,
            layout=layout, hw=hw, activation=self.activation,
            drop_rates=self.drop_rates if seed is not None else (0.0, 0.0, 0.0), drop_seed=seed,
        )


class SelfAndCrossBlockPair(nn.Module):
    """The per-stage unit: self normal, self shift, cross normal, cross shift (JAX
    ``SelfAndCrossBlockPair``).

    ``impl="cuda_pack"`` packs the stage's tokens by window once, runs the four blocks
    as fused kernels on them with the re-partition kernel between the normal and the
    shifted geometry, and unpacks once (the JAX non-``strips_io`` packed branch). Which
    stages pack is the model's decision (``SwinFusionUNet.stage_impls``)."""

    ORDER = (("self_normal", False, False), ("self_shift", True, False),
             ("cross_normal", False, True), ("cross_shift", True, True))

    def __init__(self, streams: int, dims: int, num_heads: int, dims_per_head: int,
                 window_size: Tuple[int, int], mlp_hidden_dims: int,
                 activation: str = "elu", use_qkv_bias: bool = True,
                 drop_ratios: Tuple[float, float, float] = (0.0, 0.0, 0.0)):
        super().__init__()
        for name, shift, cross in self.ORDER:
            self.add_module(name, BasicBlock(
                streams, dims, num_heads, dims_per_head, window_size, shift, cross,
                mlp_hidden_dims, activation, use_qkv_bias, *drop_ratios,
            ))

    def forward(self, x: torch.Tensor, impl: str = "torch",
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """``seeds``: the dropout seed source in training (one seed per block, in order)."""
        if impl == "cuda_pack":
            return self._packed_forward(x, seeds)
        for name, _, _ in self.ORDER:
            x = getattr(self, name)(x, impl, seeds)
        return x

    def _packed_forward(self, x: torch.Tensor, seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        hw = (x.shape[2], x.shape[3])
        window = self.self_normal.attn.window_size
        xw = pack_windows(x, window, shift=False)
        was_shift = False
        for name, shift, _ in self.ORDER:
            if shift != was_shift:
                xw = repartition_windows(xw, hw, window, was_shift, shift)
                was_shift = shift
            block = getattr(self, name)
            xw = block.fused(xw, "windows", hw, seed=block.draw_seed(seeds))
        return unpack_windows(xw, hw, window, shift=was_shift)


class PatchMergeLayer(nn.Module):
    """Encoder downsample: space-to-depth -> 1x1 linear -> LN -> act (JAX ``PatchMergeLayer``)."""

    def __init__(self, streams: int, in_dims: int, out_dims: int,
                 merging_size: Tuple[int, int], activation: str = "elu"):
        super().__init__()
        self.merging_size = tuple(merging_size)
        self.act = activation_fn(activation)
        self.linear = StackedDense(streams, in_dims * merging_size[0] * merging_size[1], out_dims)
        self.norm = StackedLayerNorm(streams, out_dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = space_to_depth(x, self.merging_size)
        return self.act(self.norm(self.linear(x)))


class PatchUnmergeLayer(nn.Module):
    """Decoder upsample ("anti patch merging"): 1x1 linear to out*ph*pw -> LN ->
    depth-to-space -> act (JAX ``PatchUnmergeLayer``)."""

    def __init__(self, streams: int, in_dims: int, out_dims: int,
                 merging_size: Tuple[int, int], activation: str = "elu"):
        super().__init__()
        self.merging_size = tuple(merging_size)
        self.act = activation_fn(activation)
        cc = out_dims * merging_size[0] * merging_size[1]
        self.linear = StackedDense(streams, in_dims, cc)
        self.norm = StackedLayerNorm(streams, cc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.linear(x))
        return self.act(depth_to_space(x, self.merging_size))


BN_MOMENTUM = 0.9  # flax's (torch's 0.1 weighs the other side)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis of NCHW input in flax's semantics, with flax's
    names (``scale``, ``bias``; running ``mean``, ``var``) and arithmetic
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    ``train=False`` normalises with the running statistics. ``train=True`` normalises
    with the batch's over (B, H, W), the biased "fast" variance ``E[x^2] - E[x]^2``
    clipped at 0 (flax ``_compute_stats``, not torch's unbiased running variance), and
    updates the running statistics in place: ``new = BN_MOMENTUM * old + (1 -
    BN_MOMENTUM) * batch``.

    Across ranks (data-parallel training) the batch is the global one: with a process
    group of more than one rank in ``group`` (set by the data-parallel step,
    ``train.py::make_train_step``), ``[E[x], E[x^2]]`` is averaged over the ranks before
    the variance is formed, as flax's ``pmean`` of the moments under ``axis_name``; the
    average's backward averages the incoming gradients over the same ranks
    (``parallel/mesh.py::AllReduceMean``). Ranks hold equal batches, so this is the
    global batch's mean and biased variance. It is not ``nn.SyncBatchNorm``, which keeps
    torch's unbiased running variance."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.group = None
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def sync_group(self):
        """The process group the batch statistics are averaged over, None for this rank's
        batch alone (no group, or a group of one rank)."""
        import torch.distributed as dist

        if self.group is None or not dist.is_initialized():
            return None
        return self.group if dist.get_world_size(self.group) > 1 else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            # flax upcasts a bf16 input once for the statistics and once more where it
            # normalises it, so the two paths' gradients meet in x's dtype: two casts
            # here too (one and the same tensor for an fp32 input)
            stats = x.float()
            mean = stats.mean(dim=(0, 2, 3))
            mean2 = (stats * stats).mean(dim=(0, 2, 3))
            group = self.sync_group()
            if group is not None:
                from ..parallel.mesh import AllReduceMean

                mean, mean2 = AllReduceMean.apply(torch.stack([mean, mean2]), group)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
                self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        else:
            mean, var = self.mean, self.var
        x = x.float()  # flax's BatchNorm(dtype=float32)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class FinalHead(nn.Module):
    """(B, H, W, 2) -> reflect conv3x3 -> BatchNorm -> act -> reflect conv3x3 ->
    (B, H, W, 1) (JAX ``FinalHead``). The convs compute in the input's dtype, as flax's
    ``nn.Conv(dtype=...)``: input and kernel cast, the product rounded, then the bias
    added; BatchNorm and its activation are fp32."""

    def __init__(self, kernel_size: int = 3, activation: str = "elu"):
        super().__init__()
        self.pad = kernel_size // 2
        self.act = activation_fn(activation)
        self.conv1 = nn.Conv2d(2, 2, kernel_size)
        self.bn = BatchNorm(2)
        self.conv2 = nn.Conv2d(2, 1, kernel_size)
        for conv in (self.conv1, self.conv2):
            nn.init.zeros_(conv.weight)
            nn.init.zeros_(conv.bias)

    def _reflect_conv(self, x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
        """The reflect pad in x's dtype, then the conv in ``dtype`` (flax pads, then its
        ``nn.Conv`` casts: the pad's backward sums in x's dtype)."""
        x = pad_reflect(pad_reflect(x, 2, self.pad, self.pad), 3, self.pad, self.pad).to(dtype)
        return F.conv2d(x, conv.weight.to(dtype)) + conv.bias.to(dtype)[:, None, None]

    def forward(self, xy: torch.Tensor, train: bool = False) -> torch.Tensor:
        # The JAX head runs its convs at Precision.HIGHEST; cuDNN's default TF32 would
        # keep only ~3 decimal digits, so TF32 is off for these convs. Their backward
        # runs later, outside this block: the train step keeps TF32 off for it.
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = self._reflect_conv(xy.permute(0, 3, 1, 2), self.conv1, xy.dtype)
            x = self.act(self.bn(x, train))
            x = self._reflect_conv(x, self.conv2, xy.dtype)
        return x.permute(0, 2, 3, 1)
