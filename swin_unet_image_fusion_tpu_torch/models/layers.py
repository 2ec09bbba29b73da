"""Dual-stream building blocks (PyTorch port of the JAX ``models/layers.py``, NHWC).

Both modality streams ride a leading stacked axis S (normally 2) of one tensor
``(S, B, H, W, C)``, and every per-stream layer holds its weights stacked on the same
axis, so one batched matmul computes both streams with independent weights. Parameter
names and shapes mirror the flax tree, so ``models/from_jax.py`` loads a flattened
flax variable dict 1:1.

Dropout is not ported (every ratio of the default configuration is 0; the model raises
on a nonzero one in training). ``FinalHead``'s BatchNorm uses its running statistics,
or with ``train=True`` the batch's and updates the running ones, as flax does.
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
parameter is cast where it meets an activation.
"""

from __future__ import annotations

from typing import Callable, Tuple

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
from ..ops.fused_block import fused_block
from ..ops.window_attention import window_attention
from ..ops.window_pack import pack_windows, repartition_windows, unpack_windows


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "elu":
        return F.elu
    if name == "gelu":
        return F.gelu
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
    calls the K3 kernel's wrapper (its plain version on a CPU tensor).
    """

    def __init__(self, streams: int, dims: int, num_heads: int, dims_per_head: int,
                 window_size: Tuple[int, int], shift: bool, cross: bool,
                 use_qkv_bias: bool = True):
        super().__init__()
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

    def forward(self, x: torch.Tensor, impl: str = "torch") -> torch.Tensor:
        if impl == "cuda":
            return self._kernel_forward(x)
        if impl != "torch":
            raise ValueError(f"unknown attention impl {impl!r}; expected 'torch' or 'cuda'")
        s, b, h, w, _ = x.shape
        wh, ww = self.window_size
        t = wh * ww
        heads, d = self.num_heads, self.dims_per_head

        if self.shift:
            x = cyclic_shift(x, self.window_size, reverse=False)
        xw = window_partition(x, self.window_size)  # (S, Bw, T, C)
        kvw = xw.flip(0) if self.cross else xw
        bw = xw.shape[1]

        def split_heads(a):  # (S, Bw, T, inner) -> (S, Bw, heads, T, d)
            return a.reshape(s, bw, t, heads, d).transpose(2, 3)

        q = split_heads(self.q(xw))
        k = split_heads(self.k(kvw))
        v = split_heads(self.v(kvw))
        # scores in fp32 (exact products of the bf16 q and k under bf16)
        scores = (q.float() @ k.float().transpose(-1, -2)) * d**-0.5
        bias = gather_relative_position_bias(self.rel_pos_bias_table, self.window_size)
        scores = scores + bias[:, None, None]
        if self.shift:
            mask = device_constant(shift_attention_mask, ((h, w), self.window_size), x.device)
            scores = apply_shift_mask(scores, mask)
        out = torch.softmax(scores, dim=-1).to(v.dtype) @ v
        out = self.proj(out.transpose(2, 3).reshape(s, bw, t, heads * d))
        out = window_unpartition(out, self.window_size, (h, w))
        if self.shift:
            out = cyclic_shift(out, self.window_size, reverse=True)
        return out

    def _kernel_forward(self, x: torch.Tensor) -> torch.Tensor:
        wq, bq = self.q.weights()
        wk, bk = self.k.weights()
        wv, bv = self.v.weights()
        wp, bp = self.proj.weights()
        bias = gather_relative_position_bias(self.rel_pos_bias_table, self.window_size)
        return window_attention(
            x.contiguous(), wq, bq, wk, bk, wv, bv, wp, bp, bias.contiguous(),
            window=self.window_size, num_heads=self.num_heads,
            dims_per_head=self.dims_per_head, shift=self.shift, cross=self.cross,
        )


class DualMLP(nn.Module):
    """Per-stream 2-layer MLP (JAX ``DualMLP``)."""

    def __init__(self, streams: int, dims: int, hidden_dims: int, activation: str = "elu"):
        super().__init__()
        self.act = activation_fn(activation)
        self.fc1 = StackedDense(streams, dims, hidden_dims)
        self.fc2 = StackedDense(streams, hidden_dims, dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class BasicBlock(nn.Module):
    """Pre-norm block: LN -> window attention -> +res, LN -> MLP -> +res (JAX
    ``BasicBlock``). ``impl="cuda_block"`` runs the whole block as one fused kernel on
    the image (the JAX ``pallas_block``); :meth:`fused` also takes window-packed tokens."""

    def __init__(self, streams: int, dims: int, num_heads: int, dims_per_head: int,
                 window_size: Tuple[int, int], shift: bool, cross: bool,
                 mlp_hidden_dims: int, activation: str = "elu", use_qkv_bias: bool = True):
        super().__init__()
        self.activation = activation
        self.norm1 = StackedLayerNorm(streams, dims)
        self.attn = DualWindowAttention(streams, dims, num_heads, dims_per_head,
                                        window_size, shift, cross, use_qkv_bias)
        self.norm2 = StackedLayerNorm(streams, dims)
        self.mlp = DualMLP(streams, dims, mlp_hidden_dims, activation)

    def forward(self, x: torch.Tensor, impl: str = "torch") -> torch.Tensor:
        if impl == "cuda_block":
            return self.fused(x, "image")
        x = x + self.attn(self.norm1(x), impl)
        return x + self.mlp(self.norm2(x))

    def fused(self, x: torch.Tensor, layout: str, hw: Tuple[int, int] | None = None) -> torch.Tensor:
        """The block through the fused kernel's wrapper (its plain version on a CPU
        tensor): ``layout="image"`` for (S, B, H, W, C), ``"windows"`` for the
        ``pack_windows`` tokens of an ``hw`` map in this block's geometry."""
        attn = self.attn
        weights = [t for layer in (attn.q, attn.k, attn.v, attn.proj) for t in layer.weights()]
        bias = gather_relative_position_bias(attn.rel_pos_bias_table, attn.window_size)
        return fused_block(
            x.contiguous(), self.norm1.scale, self.norm1.bias, *weights, bias.contiguous(),
            self.norm2.scale, self.norm2.bias, *self.mlp.fc1.weights(), *self.mlp.fc2.weights(),
            window=attn.window_size, num_heads=attn.num_heads,
            dims_per_head=attn.dims_per_head, shift=attn.shift, cross=attn.cross,
            layout=layout, hw=hw, activation=self.activation,
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
                 activation: str = "elu", use_qkv_bias: bool = True):
        super().__init__()
        for name, shift, cross in self.ORDER:
            self.add_module(name, BasicBlock(
                streams, dims, num_heads, dims_per_head, window_size, shift, cross,
                mlp_hidden_dims, activation, use_qkv_bias,
            ))

    def forward(self, x: torch.Tensor, impl: str = "torch") -> torch.Tensor:
        if impl == "cuda_pack":
            return self._packed_forward(x)
        for name, _, _ in self.ORDER:
            x = getattr(self, name)(x, impl)
        return x

    def _packed_forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = (x.shape[2], x.shape[3])
        window = self.self_normal.attn.window_size
        xw = pack_windows(x, window, shift=False)
        was_shift = False
        for name, shift, _ in self.ORDER:
            if shift != was_shift:
                xw = repartition_windows(xw, hw, window, was_shift, shift)
                was_shift = shift
            xw = getattr(self, name).fused(xw, "windows", hw)
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
    BN_MOMENTUM) * batch``."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()  # flax's BatchNorm(dtype=float32)
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
                self.var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)
        else:
            mean, var = self.mean, self.var
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

    def _reflect_conv(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        x = pad_reflect(pad_reflect(x, 2, self.pad, self.pad), 3, self.pad, self.pad)
        return F.conv2d(x, conv.weight.to(x.dtype)) + conv.bias.to(x.dtype)[:, None, None]

    def forward(self, xy: torch.Tensor, train: bool = False) -> torch.Tensor:
        # The JAX head runs its convs at Precision.HIGHEST; cuDNN's default TF32 would
        # keep only ~3 decimal digits, so TF32 is off for these convs. Their backward
        # runs later, outside this block: the train step keeps TF32 off for it.
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = self._reflect_conv(xy.permute(0, 3, 1, 2), self.conv1)
            x = self.act(self.bn(x, train))
            x = self._reflect_conv(x.to(xy.dtype), self.conv2)
        return x.permute(0, 2, 3, 1)
