"""Fused pre-norm Swin block (K1 and K4): the CUDA kernels' wrapper, their plain PyTorch
version and the launch counter.

Counterpart of the JAX ``ops/pallas_block.py::pallas_fused_block`` (K4, tokens in the
image) and of the block half of ``ops/pallas_pack.py::pallas_packed_block_strips`` (K1,
tokens packed by window). Both compute one whole ``BasicBlock`` on both streams:

- LN1 in fp32 with the biased variance and eps 1e-5;
- window attention as ``ops/window_attention.py`` computes it (scale folded into q, the
  gathered relative-position bias, the wrap-seam mask *setting* scores to -1e10, the
  clamped fast softmax); under cross, k/v come from the other stream normalised with
  *that* stream's LN1;
- proj + bias, + x; LN2; fc1 + b1; the MLP's activation; fc2 + b2; + y.

The activation is ELU (the default model's), ReLU or GELU (``ACTIVATIONS``), a runtime code
of every route's kernels (``csrc/activation.cuh``). GELU has two forms, as in the TPU
kernels: their forward bodies compute ``jax.nn.gelu``, the tanh form, and their backward
bodies recompute the hidden and its derivative in the erf form (``_act_and_grad``,
``pallas_block.py:194-208``, ``pallas_pack.py:725-737``): w2's gradient reads the erf hidden
z Phi(z) and g_pre is g_h (Phi(z) + z phi(z)). The plain version and the kernels follow both
(:class:`_GeluProduct`); the composition (``models/layers.py``) differentiates the tanh form,
as the JAX jnp block does. ReLU's derivative is (z > 0) in both.

x and the output are fp32 or bf16 (the weights fp32), and the two TPU kernels round
differently in bf16, so the rounding goes with the layout and not with the dtype alone:

- K4 (``"image"``, ``pallas_block.py::_block_fwd_body``) takes bf16 operands: x is upcast
  on load; LN1(x) and LN1(kv), the weights, p and v before AV, AV, LN2(y) and the MLP
  hidden are rounded to bf16 as they enter a product, whose sums stay fp32; the scores,
  the softmax, q/k/v and **y = x + proj are never rounded**; ``y + m`` is rounded once on
  the store;
- K1 (``"windows"``, ``pallas_pack.py::_packed_block_fwd_body``) computes the fp32 block
  inside, weights included: bf16 is only its input and output.

``layout`` says where the tokens live: ``"image"`` is ``(S, B, H, W, C)`` with the
shifted partition as index arithmetic (K4); ``"windows"`` is ``(S, B, nWin, T, C)`` as
``ops/window_pack.py::pack_windows`` lays out an ``hw`` map in this block's own geometry
(K1). ``fused_block`` runs the plain version for a CPU tensor and launches kernels for a
CUDA tensor; there is no fallback between the two. A call without dropout, K4 (what
``cuda_block`` serves) and K1 (what ``cuda_pack`` serves) alike, runs
``csrc/fused_block_fwd.cu`` as :func:`block_fwd_plan` lays it out: where two blocks fit an
SM (C <= 48 in the default model) one launch, a block per window and stream computing the
whole block in shared memory with the MLP in steps of the hidden; elsewhere six launches
(LN1, attention in head groups, projection + x, LN2, fc1, fc2 + y). K4's bf16 products
run on the tensor cores (``mma.sync``), fp32 ones (K1 in both dtypes) on FMA; the layout
changes only which rows a window's tokens are. A dropout call runs the same launches in their
dropout form, the masks in the epilogues (below); a shape that the forward does not take
raises before any launch. ``_launch_five`` keeps the five launches of ``csrc/fused_block.cu``
(a q/k/v GEMM with LN1 in its prologue, the attention core, proj, fc1 with LN2 in its
prologue, fc2) callable, for timing in turns; no forward falls back to them.

On a card, a call that autograd records (grad mode on and an input that requires grad)
goes through ``_FusedBlockFunction``: its backward (K1 bwd and K4 bwd) recomputes the block
from x and the weights, as the JAX custom VJPs do, and returns g_x and every weight's
gradient. :func:`block_bwd_plan` routes it, with and without dropout alike: where a window's
blocks fit in shared memory (C <= 48 in the default model) the fused route of
``csrc/fused_block_bwd.cu`` (seven launches: the transposed weights, the recomputed forward a
block per group of windows, the MLP's backward over 49-token tiles, the attention's backward
over windows, the LN1 backward, the weight gradients, one reduction); at C = 96, 192 and 384
(stages 2-4, d = 12, 24 and 48) the split route of ``csrc/fused_block_bwd_split.cu`` (eleven
launches: the transposed weights, the forward recomputed on the forward's split route, the
MLP's backward over 49-token tiles, K3's split backward block on the stored LN1(x) and g_y, at
d = 48 with the tiled core of ``csrc/window_bwd.cuh``, the g_ln product with the LN1 backward,
the weight gradients, one reduction); elsewhere (shapes of no stage of the default model) the
"five" route, ``swin_fused_block_bwd`` of ``csrc/fused_block.cu`` (twenty launches, the
forward recomputed with its five). A dropout call runs each route's dropout form: the same
launches, the masks in their epilogues and operand loads (below). ``_launch_bwd_five`` keeps
the twenty launches callable at any shape, for timing in turns.
``fused_block_bwd_plain`` is the plain backward (autograd of the plain version); it differs
from the kernels only where a score exceeds the softmax clamp of 80, whose derivative the
kernels, like the TPU's, do not take. For a bf16 x, K1 and K4 alike, both compute what the
JAX backward bodies do (``pallas_block.py:278-293, 439-449``, ``pallas_pack.py:792-794``):
the fp32 backward of the fp32 block at the upcast x and g (not autograd of K4's bf16
rounding points), the weight gradients fp32 and g_x in bf16, rounded once in self mode;
under cross the residual and q side and the k/v side (JAX's gx and gkv outputs) are rounded
apart and added in bf16.

Dropout (training): ``drop_rates`` = (attention, proj, MLP) with a ``drop_seed`` in
[0, 2^24) applies the reference's four sites with the TPU kernels' hash masks
(``pallas_block.py:87-187``, ``pallas_pack.py:581-686``): p before AV, proj + bp before
the residual, the MLP hidden after the activation and fc2 + b2 before the residual, the MLP rate
at both MLP sites. The masks are keyed on the TPU kernel's own geometry
(``ops/dropout_layout.py``): K4's padded windows for the image layout, K1's window pairs
for the windows layout. On a card a dropout call launches the dropout form of the
kernels (fp32 or bf16; the masks do not depend on the dtype), counted in
``DROP_LAUNCHES`` and ``DROP_BWD_LAUNCHES`` (``BF16_DROP_LAUNCHES`` and
``BF16_DROP_BWD_LAUNCHES`` in bf16); without dropout a bf16 call counts in
``BF16_LAUNCHES`` and ``BF16_BWD_LAUNCHES``. The forward's dropout form is
``csrc/fused_block_fwd_drop.cu``'s (the kDrop forms of the same kernels), one launch or six as
:func:`block_fwd_plan` lays them out: the attention's keep bits hashed where the fp32 core uses them, or for K4's bf16 core once per
window and head into shared memory (two 32-bit words a query row; p masked before its
rounding), the token sites masked in the epilogues of proj, fc1 (before the hidden's rounding)
and fc2; it stores no keep bits. The backward's dropout
form of the fused and split routes recomputes
the forward's attention and proj masks (the attention's keep bits once per window and head, two
32-bit words per query row, stored for the attention's backward), keeps the hidden
undropped for act' (under GELU it stores z), and backpropagates g_m = drop(g) into the MLP
(g_pre = drop(g_m w2^T) act'(z), the hidden (GELU: the erf hidden) dropped in place for w2's
gradient) and g_proj = drop(g_y) into the
attention (whose core masks g_P and weights g_v by the dropped P), while the residual paths
take the undropped g and g_y; a site of rate 0 is the identity.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from . import dropout_layout as dl
from . import hash_dropout as hd
from . import window_attention as twa
from .window import device_constant
from .window_attention import (
    ACT_DTYPES,
    DEFAULT_SMS,
    FUSED_SMEM_MAX,
    FWD_PITCHES,
    FWD_WINDOW,
    GROUP_COLS,
    MAX_STREAMS,
    PROJ_COLS,
    SMEM_LIMIT_BYTES,
    SMEM_TWO_PER_SM,
    _STAGES,
    _align16,
    _b_bytes,
    _ring_a_bytes,
    _round_up,
    _sm_count,
    _wgrad_chunks,
    attention_smem,
    fast_softmax,
    keep_words_bytes,
    operand_rounding,
    proj_smem,
    recorded,
    split_input_grad,
    wrap_region_mask,
)
from .window_pack import pack_windows, unpack_windows

LN_EPS = 1e-5
# the LayerNorm backward kernel's limit (csrc/window_core_bwd.cuh), and the forward's split
# route's (csrc/fused_block_fwd.cuh's kMaxC)
MAX_CHANNELS = 384
LAYOUTS = ("image", "windows")
# the MLP activations the kernels take, in the order of their codes (activation_code)
ACTIVATIONS = ("elu", "relu", "gelu")
WEIGHT_NAMES = ("ln1_scale", "ln1_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp",
                "bias", "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")

# Calls that launched each form of the forward kernels (fp32, bf16, each with dropout),
# and backward calls that launched each form of the backward kernels (one per call on a
# card), since the last reset; the plain versions never count.
LAUNCHES = 0
BF16_LAUNCHES = 0
DROP_LAUNCHES = 0
BF16_DROP_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0
DROP_BWD_LAUNCHES = 0
BF16_DROP_BWD_LAUNCHES = 0
# Of those, the calls under each activation but ELU (any dtype, with or without dropout),
# forward and backward.
ACTIVATION_LAUNCHES = {"relu": 0, "gelu": 0}
ACTIVATION_BWD_LAUNCHES = {"relu": 0, "gelu": 0}


def rounds_operands(dtype: torch.dtype, layout: str) -> bool:
    """Whether the block rounds its products' operands to bf16: K4 in bf16 does, K1
    computes in fp32 inside whatever its I/O dtype."""
    return dtype == torch.bfloat16 and layout == "image"


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Per-stream LayerNorm of (S, ..., C) with (S, C) weights."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    shape = (scale.shape[0],) + (1,) * (x.ndim - 2) + (scale.shape[1],)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * scale.reshape(shape) + bias.reshape(shape)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-stream dense layer: (S, ..., K) @ (S, K, N) + (S, N)."""
    s, k, n = w.shape
    y = (x.reshape(s, -1, k) @ w).reshape(*x.shape[:-1], n)
    return y + b.reshape((s,) + (1,) * (x.ndim - 2) + (n,))


def block_keying(layout: str, hw, window, shift: bool, num_heads: int, dims_per_head: int,
                 device) -> dl.Keying:
    """The dropout keying of the TPU kernel a layout stands for: K4's for ``"image"``,
    K1's for ``"windows"`` (``ops/dropout_layout.py``)."""
    kind = "k4" if layout == "image" else "k1"
    return dl.keying(kind, hw, window, shift, num_heads, dims_per_head, device)


def activation_code(activation: str) -> int:
    """The kernels' code of an MLP activation (``csrc/activation.cuh``'s ``kActElu``,
    ``kActRelu``, ``kActGelu``); raises on any other name."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; the fused block takes {ACTIVATIONS}")
    return ACTIVATIONS.index(activation)


class _GeluProduct(torch.autograd.Function):
    """``rnd(site(gelu(z))) @ rnd(w2)`` per stream, with the TPU kernels' gelu: the forward
    in the tanh form (``jax.nn.gelu``, as the forward bodies compute it), the backward as
    their ``_act_and_grad`` recomputes it in the erf form (``pallas_block.py:194-208``,
    ``pallas_pack.py:725-737``): w2's gradient reads the erf hidden and g_pre is
    g_h (Phi(z) + z phi(z)). ``site`` is the hidden's dropout (the identity without);
    ``rnd`` K4's bf16 rounding, the identity wherever a backward runs (fp32 inside)."""

    @staticmethod
    def forward(ctx, z, w2, site, rnd):
        ctx.save_for_backward(z, w2)
        ctx.site = site
        hidden = rnd(site(F.gelu(z, approximate="tanh")))
        s, k, n = w2.shape
        return (hidden.reshape(s, -1, k) @ rnd(w2)).reshape(*z.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        z, w2 = ctx.saved_tensors
        with torch.enable_grad():
            z, w2 = z.detach().requires_grad_(), w2.detach().requires_grad_()
            s, k, n = w2.shape
            out = (ctx.site(F.gelu(z)).reshape(s, -1, k) @ w2).reshape(*z.shape[:-1], n)
            gz, gw2 = torch.autograd.grad(out, (z, w2), g)
        return gz, gw2, None, None


def _mlp_out(z, w2, b2, activation, rnd, site):
    """fc2(site(act(z))) + b2 of the pre-activation ``z``, the operands rounded by ``rnd``;
    ``site`` is the hidden's dropout. Under gelu the kernels' two forms
    (:class:`_GeluProduct`); elu and relu as autograd takes them (relu' = (z > 0), as
    ``_act_and_grad``'s)."""
    if activation == "gelu":
        s, n = b2.shape
        return _GeluProduct.apply(z, w2, site, rnd) + b2.reshape((s,) + (1,) * (z.ndim - 2) + (n,))
    act = F.elu if activation == "elu" else F.relu
    return _dense(rnd(site(act(z))), rnd(w2), b2)


def _block_windows_plain(xw, ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wp, bp, bias,
                         ln2_scale, ln2_bias, w1, b1, w2, b2, *, hw, window, num_heads,
                         dims_per_head, shift, cross, rnd, drop=None, kvw=None, mask=None,
                         activation="elu"):
    """The block on fp32 window-packed tokens; ``rnd`` is applied to every operand of a
    product that K4 rounds to bf16 (the identity for fp32 and for K1). ``drop``: None,
    or (rates, seed, keying) of the call's dropout. ``kvw``: the tokens k/v are made from
    (stream-flipped under cross), ``xw`` by default. ``mask``: the (nWin, T, T) wrap-seam
    mask of a shifted call, ``wrap_region_mask`` of ``hw`` by default (a band of a larger
    map passes its windows' slice of the map's). ``activation``: the MLP's, elu, relu or
    gelu (:func:`_mlp_out`)."""
    s, b, n_win, t, c = xw.shape
    d = dims_per_head
    ln = rnd(_layer_norm(xw, ln1_scale, ln1_bias))
    kv = ln if kvw is None else rnd(_layer_norm(kvw, ln1_scale, ln1_bias))
    kv = kv.flip(0) if cross else kv

    def heads(a):  # (S, B, nWin, T, inner) -> (S, B, nWin, heads, T, d)
        return a.reshape(s, b, n_win, t, num_heads, d).transpose(3, 4)

    q = heads(_dense(ln, rnd(wq), bq) * d**-0.5)
    k = heads(_dense(kv, rnd(wk), bk))
    v = heads(_dense(kv, rnd(wv), bv))
    scores = q @ k.transpose(-1, -2) + bias[:, None, None, None]
    if shift:
        if mask is None:
            mask = device_constant(wrap_region_mask, (tuple(hw), tuple(window)), xw.device)
        scores = scores.masked_fill(mask[:, None], -1e10)
    p = fast_softmax(scores)
    if drop is None:
        av = rnd(rnd(p) @ rnd(v))
        av = av.transpose(3, 4).reshape(s, b, n_win, t, num_heads * d)
        y = xw + _dense(av, rnd(wp), bp)
        z = _dense(rnd(_layer_norm(y, ln2_scale, ln2_bias)), rnd(w1), b1)
        return y + _mlp_out(z, w2, b2, activation, rnd, lambda a: a)
    (rate_a, rate_p, rate_m), seed, key = drop
    table = dl.windows_table(key)

    def site(a, site_id, rate):  # a: (S, B, nWin, T, cols) token site
        if not rate:
            return a
        keep = dl.token_keep(seed, site_id, rate, key, s, b, a.shape[-1], table)
        return hd.apply_mask(a, keep.reshape(a.shape), rate)

    if rate_a:
        keep = dl.attention_keep(seed, rate_a, key, table, s, b, num_heads)
        p = hd.apply_mask(p, keep, rate_a)
    av = rnd(rnd(p) @ rnd(v))
    av = av.transpose(3, 4).reshape(s, b, n_win, t, num_heads * d)
    y = xw + site(_dense(av, rnd(wp), bp), hd.SITE_PROJ, rate_p)
    z = _dense(rnd(_layer_norm(y, ln2_scale, ln2_bias)), rnd(w1), b1)
    m = _mlp_out(z, w2, b2, activation, rnd, lambda a: site(a, hd.SITE_MLP_HIDDEN, rate_m))
    return y + site(m, hd.SITE_MLP_OUT, rate_m)


def _check(x: torch.Tensor, layout: str, hw, window) -> Tuple[int, int]:
    """The block's map (H, W) for ``x`` in ``layout``; raises on a shape it does not take."""
    if x.dtype not in ACT_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")
    if layout == "image":
        if x.ndim != 5:
            raise ValueError(f"image-layout x must be (S, B, H, W, C), got {tuple(x.shape)}")
        hw = tuple(x.shape[2:4])
    elif hw is None:
        raise ValueError("the windows layout needs the map size hw")
    h, w = hw
    if h % window[0] or w % window[1]:
        raise ValueError(f"map {h}x{w} is not a multiple of the window {window}")
    if layout == "windows":
        n_win = (h // window[0]) * (w // window[1])
        if x.ndim != 5 or tuple(x.shape[2:4]) != (n_win, window[0] * window[1]):
            raise ValueError(f"windows of a {h}x{w} map are (S, B, {n_win}, "
                             f"{window[0] * window[1]}, C), got {tuple(x.shape)}")
    return h, w


def fused_block_plain(x, ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wp, bp, bias,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, *, window: Tuple[int, int],
                      num_heads: int, dims_per_head: int, shift: bool, cross: bool,
                      layout: str, hw: Optional[Tuple[int, int]] = None,
                      activation: str = "elu", drop_rates: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                      drop_seed: Optional[int] = None,
                      kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels, same inputs and semantics.

    x: (S, B, H, W, C) for ``layout="image"``, (S, B, nWin, T, C) of an ``hw`` map for
    ``layout="windows"``, fp32 or bf16; ln*_scale/ln*_bias: (S, C); wq/wk/wv: (S, C,
    inner); bq/bk/bv: (S, inner); wp: (S, inner, C); bp: (S, C); bias: (S, T, T)
    gathered relative-position bias; w1: (S, C, hidden); b1: (S, hidden); w2: (S,
    hidden, C); b2: (S, C), all fp32. Returns the same shape and dtype as x, computed in
    fp32 with K4's or K1's bf16 rounding points (module docstring) when x is bf16, and
    with the hash dropout of ``drop_rates`` and ``drop_seed`` (module docstring).
    ``kv``: a tensor like x that k/v are made from (stream-flipped under cross), x itself
    by default; the plain backward passes a copy of x to keep the k/v side of x's
    gradient apart. ``activation``: the MLP's, one of ``ACTIVATIONS``; under gelu autograd
    takes the TPU kernels' backward (module docstring).
    """
    activation_code(activation)
    hw = _check(x, layout, hw, window)
    dl.check_seed(drop_rates, drop_seed)
    weights = (ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wp, bp, bias,
               ln2_scale, ln2_bias, w1, b1, w2, b2)
    drop = None
    if any(drop_rates):
        key = block_keying(layout, hw, window, shift, num_heads, dims_per_head, x.device)
        drop = (tuple(drop_rates), drop_seed, key)
    kw = dict(hw=hw, window=window, num_heads=num_heads, dims_per_head=dims_per_head,
              shift=shift, cross=cross, rnd=operand_rounding(rounds_operands(x.dtype, layout)),
              drop=drop, activation=activation)
    if layout == "windows":
        kvw = None if kv is None else kv.float()
        return _block_windows_plain(x.float(), *weights, kvw=kvw, **kw).to(x.dtype)
    xw = pack_windows(x.float(), window, shift)
    kvw = None if kv is None else pack_windows(kv.float(), window, shift)
    return unpack_windows(_block_windows_plain(xw, *weights, kvw=kvw, **kw).to(x.dtype), hw,
                          window, shift)


_P = ctypes.c_void_p
_I = ctypes.c_int


def fused_block_bwd_plain(g, x, *weights, **kw) -> Tuple[torch.Tensor, ...]:
    """Plain backward: (g_x, the 17 weight gradients) of :func:`fused_block_plain` for the
    output gradient ``g``. Keyword arguments as the forward's. fp32: autograd of the plain
    version. bf16: the fp32 backward of the fp32 block at the upcast x and g, g_x in bf16
    (``window_attention.split_input_grad``), the weight gradients fp32."""
    with torch.enable_grad():
        if x.dtype == torch.float32:
            inputs = [a.detach().requires_grad_() for a in (x, *weights)]
            return torch.autograd.grad(fused_block_plain(*inputs, **kw), inputs, g)
        leaves = [a.detach().requires_grad_() for a in weights]
        return split_input_grad(
            x, lambda xq, xkv: (fused_block_plain(xq, *leaves, kv=xkv, **kw), leaves),
            g, kw["cross"])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("fused_block")
    drop = ctypes.POINTER(dl.DropArgs)
    lib.swin_fused_block_fwd.argtypes = [_P] * 25 + [drop] + [_I] * 14 + [ctypes.c_float, _I, _P]
    lib.swin_fused_block_fwd.restype = _I
    lib.swin_fused_block_bwd_workspace.argtypes = [_I] * 10 + [drop] + [_I] * 2
    lib.swin_fused_block_bwd_workspace.restype = ctypes.c_size_t
    lib.swin_fused_block_bwd.argtypes = [_P] * 3 + [drop] + [_I] * 14 + [ctypes.c_float, _I, _P]
    lib.swin_fused_block_bwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_library(drop: bool = False) -> ctypes.CDLL:
    """``csrc/fused_block_fwd.cu`` (the forms without dropout) or, with ``drop``,
    ``csrc/fused_block_fwd_drop.cu`` (the dropout forms): one C interface, a library each, so
    that the two build at once."""
    lib = _build.load("fused_block_fwd_drop" if drop else "fused_block_fwd")
    lib.swin_k4_fwd.argtypes = [_P] * 23 + [ctypes.POINTER(dl.DropArgs)] + [_I] * 16 + [ctypes.c_float, _I, _P]
    lib.swin_k4_fwd.restype = _I
    lib.swin_k4_fwd_smem.argtypes = [_I] * 11
    lib.swin_k4_fwd_smem.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("fused_block_bwd")
    drop = ctypes.POINTER(dl.DropArgs)
    lib.swin_block_bwd.argtypes = [_P] * 3 + [ctypes.c_size_t, drop] + [_I] * 16 + [ctypes.c_float, _I, _P]
    lib.swin_block_bwd.restype = _I
    lib.swin_block_bwd_workspace.argtypes = [_I] * 13
    lib.swin_block_bwd_workspace.restype = ctypes.c_size_t
    lib.swin_block_bwd_smem.argtypes = [_I] * 8
    lib.swin_block_bwd_smem.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _split_library() -> ctypes.CDLL:
    lib = _build.load("fused_block_bwd_split")
    drop = ctypes.POINTER(dl.DropArgs)
    lib.swin_block_bwd_split.argtypes = [_P] * 3 + [ctypes.c_size_t, drop] + [_I] * 18 + [ctypes.c_float, _I, _P]
    lib.swin_block_bwd_split.restype = _I
    lib.swin_block_bwd_split_workspace.argtypes = [_I] * 14
    lib.swin_block_bwd_split_workspace.restype = ctypes.c_size_t
    lib.swin_block_bwd_split_smem.argtypes = [_I] * 10
    lib.swin_block_bwd_split_smem.restype = ctypes.c_size_t
    return lib


# ---- the forward without dropout, K4 and K1 (csrc/fused_block_fwd.cu): its launch plan ----
# Block geometry as csrc/window_fwd.cuh's (256 threads; fp32 GEMM rows padded to 56, A
# operands channel-major with rows pitched 60 floats; bf16 rows to 64, operands [64][K + 8]
# halves; channels in chunks of 16; rings three deep, the row kernels' six deep).
FUSED_PITCH_MAX = 16  # the one-launch route's q/k row pitches
# the one-launch route's blocks are built for three an SM where three fit (228 KB an SM, 1 KB
# of it reserved per block)
SMEM_THREE_PER_SM = 233_472 // 3 - 1024
_T, _WARPS, _P_STRIDE, _COL_TABLE = 49, 8, 72, 192
KERNEL_KINDS = ("fused", "attention", "rows", "fc1", "ln")  # as the source's Kind


def max_cols(bf16: bool) -> int:
    """Columns one GEMM of a block takes at most: 36 fp32 8x4 tiles of 7 row groups on 256
    threads, or three 8-column mma tiles per warp."""
    return 3 * _WARPS * 8 if bf16 else 36 * 4


def _pad_cols(bf16: bool, n: int) -> int:
    return _round_up(n, 8 if bf16 else 4)


def operand_bytes(bf16: bool, k: int) -> int:
    """A GEMM operand of k channels resident in shared memory: fp32 channel-major [k][60],
    bf16 [64][k + 8] halves, k rounded up to 16."""
    k = _round_up(k, 16)
    return 64 * (k + 8) * 2 if bf16 else k * 60 * 4


def block_smem(kind: str, bf16: bool, cross: bool, c: int, inner: int, hg: int, d: int,
               pitch: int, hc: int, drop: bool = False) -> int:
    """Shared-memory bytes of one block of ``kind`` (``k4_layout`` in the source). fused: the
    weight ring (bf16: or the core's P, whichever is larger), x/y rows, LN1(x) (then AV,
    then LN2(y)) and under cross LN1(kv), q/k/v (or the raw kv rows before them, the hidden
    chunk of hc columns after), the bias table, the row, region, column and bias tables and
    the LN statistics of x and kv. attention: K3's split attention block
    (``window_attention.attention_smem``) on LN1(x). rows (proj and fc2): the six-deep A
    and weight rings of 48 columns, the row tables. fc1: the A ring over the LN2 pass's
    scratch and the weight ring of hc columns, three deep, and the row table. ln (the LN1
    and LN2 passes): none (their statistics are static shared memory). ``drop`` (the dropout
    form): fused, in bf16 the keep words of every head in the ring after the core's P (the ring
    grows where they do not fit; the fp32 core hashes each weight's bit where it uses it);
    attention, the tokens' unit hashes and slots and room for its heads' keep words after the
    layout; rows and fc1 hash over their ring once the GEMM is done."""
    p_bytes = _WARPS * 32 * _P_STRIDE * 2 if bf16 else 0
    qk = _align16(hg * _T * pitch * 4)
    vb = _align16(hg * _round_up(d, 8) * _P_STRIDE * 2 if bf16 else hg * _T * pitch * 4)
    bias_tables = _align16(_T * _T * 4) + _align16((2 * 64 + 2 * _COL_TABLE) * 4)
    stats = 2 * 64 * 8  # LN statistics (mean, rstd) of x and kv
    if kind == "ln":
        return 0  # static shared memory only
    if kind == "fused":
        nb = max(3 * inner, c, _pad_cols(bf16, hc))
        words = hg * _T * _KEEP_WORDS * 4 if drop and bf16 else 0  # the bf16 core's keep words
        total = _align16(max(_b_bytes(bf16, nb, _STAGES), p_bytes + words)) + _align16(_T * c * 4)
        total += _align16(operand_bytes(bf16, max(c, inner)))
        total += _align16(operand_bytes(bf16, c)) if cross else 0
        total += max(2 * qk + vb, _align16(_T * c * 4) if cross else 0,
                     _align16(operand_bytes(bf16, hc)))
        return total + bias_tables + stats
    if kind == "attention":  # K3's split attention block
        extra = _align16(2 * 64 * 4) + keep_words_bytes(hg) if drop else 0
        return attention_smem(bf16, False, cross, c, inner, hg, d, pitch) + extra
    if kind == "rows":
        return proj_smem(bf16)
    if kind == "fc1":
        return _align16(_ring_a_bytes(bf16, 1, _STAGES) + _b_bytes(bf16, _pad_cols(bf16, hc), _STAGES)) + 64 * 4
    raise ValueError(f"unknown kernel kind {kind!r}; expected one of {KERNEL_KINDS}")


@dataclass(frozen=True)
class BlockFwdPlan:
    """How the forward runs at one shape, with or without dropout (the same launches): ``route``
    "fused" (one launch, a
    block per window and stream computes the whole block, the MLP in steps of
    ``hidden_chunk`` hidden columns) or "split" (six launches: LN1, attention with
    ``heads_per_block`` heads a block, projection, LN2, fc1 with ``hidden_chunk`` columns a
    block, fc2); ``smem``: (kernel kind, dynamic shared-memory bytes of one block) of each
    launch in order; ``blocks_per_sm``: the one-launch block's build, 3 where three fit an
    SM, else 2 (0 on the split route)."""

    route: str
    launches: int
    heads_per_block: int
    hidden_chunk: int
    pitch: int
    smem: Tuple[Tuple[str, int], ...]
    blocks_per_sm: int = 0


@functools.lru_cache(maxsize=None)
def block_fwd_plan(c: int, heads: int, d: int, hidden: int, window: Tuple[int, int], cross: bool,
                   bf16: bool, drop: bool = False) -> BlockFwdPlan:
    """The launch plan of the forward (K4 and K1, either layout; ``drop``: its dropout form,
    whose blocks add the masks' hashes and keep words to their shared memory), or
    ValueError where its kernels do not take the shape: 7x7 windows, d <= 48, C and heads*d
    multiples of 8, the hidden a multiple of 4. ``bf16``: bf16 *operands*
    (:func:`rounds_operands`: K4 in bf16); fp32 and K1 in either dtype take the fp32 plan.
    One launch where every head's q/k/v fit one GEMM (3 heads*d <= 144 fp32 operands, 192
    bf16), d <= 16, and two such blocks fit an SM, the MLP in steps of as many hidden
    columns as one GEMM takes; else six launches (LN1 first, LN2 before fc1), the attention
    in the largest group of heads with at most 48 columns per q/k/v part (a multiple of 8),
    C <= 384."""
    inner = heads * d
    if tuple(window) != FWD_WINDOW:
        raise ValueError(f"the fused block's forward takes {FWD_WINDOW} windows, got {tuple(window)}")
    pitch = next((p for p in FWD_PITCHES if d <= p), None)
    if pitch is None:
        raise ValueError(f"the fused block's forward takes at most {FWD_PITCHES[-1]} dims per "
                         f"head, got {d}")
    if c % 8 or inner % 8 or hidden % 4 or hidden < 4:
        raise ValueError(f"the fused block's forward takes C and heads*d multiples of 8 and a "
                         f"hidden multiple of 4, got C={c}, heads*d={inner}, hidden={hidden}")
    cols = max_cols(bf16)
    if pitch <= FUSED_PITCH_MAX and 3 * inner <= cols and c <= cols:
        hc = min(hidden, cols)
        smem = block_smem("fused", bf16, cross, c, inner, heads, d, pitch, hc, drop)
        if smem <= FUSED_SMEM_MAX:
            return BlockFwdPlan("fused", 1, heads, hc, pitch, (("fused", smem),),
                                3 if smem <= SMEM_THREE_PER_SM else 2)
    if c > MAX_CHANNELS:
        raise ValueError(f"the fused block's forward takes C <= {MAX_CHANNELS} where one "
                         f"launch does not fit, got {c}")
    for hg in range(heads, 0, -1):
        n = hg * d
        if heads % hg or n > GROUP_COLS or n % 8 or 3 * n > cols:
            continue
        rows = block_smem("rows", bf16, cross, c, inner, hg, d, pitch, cols)
        smem = (("ln", 0), ("attention", block_smem("attention", bf16, cross, c, inner, hg, d, pitch, cols, drop)),
                ("rows", rows), ("ln", 0), ("fc1", block_smem("fc1", bf16, cross, c, inner, hg, d, pitch, cols)),
                ("rows", rows))
        if max(b for _, b in smem) > SMEM_LIMIT_BYTES:
            break
        return BlockFwdPlan("split", 6, hg, cols, pitch, smem)
    raise ValueError(f"the fused block's forward has no head grouping for {heads} heads of {d} dims")


# ---- the backward without dropout, K1 and K4 (csrc/fused_block_bwd.cu): its launch plan ----
BWD_KERNELS = ("forward", "mlp", "attention")  # the fused route's three block kernels
# the split route's kernels with dynamic shared memory, in the source's kind order: the
# recomputed attention, its projection rows and fc1, the MLP backward, K3's backward block,
# the g_ln product with the LN1 backward, the stepped MLP backward's LN2 epilogue, the grouped
# g_ln product's LN1 epilogue
SPLIT_KERNELS = ("attention", "rows", "fc1", "mlp", "attention_bwd", "gln", "ln2", "ln1")
SPLIT_PITCHES = (12, 24, 48)  # the split route's q/k row pitches: d = 12, 24 and 48, stages 2-4
BWD_PITCH_MAX = 8  # the fused route's q/k row pitches (4 or 8)
_BWD_RING = 2  # weight-ring slots of the block kernels
_LN1_ROWS = 128
_KEEP_WORDS = 2  # the dropout form's attention keep words per (head, query row): keys 0-31, 32-48


def keep_words_floats(s: int, b: int, h: int, w: int, heads: int) -> int:
    """The dropout form's keep words of every (image, window, head) of a call, in 4-byte units."""
    return s * b * (h // 7) * (w // 7) * heads * _T * _KEEP_WORDS


def bwd_smem(kernel: str, c: int, inner: int, heads: int, pitch: int, hc: int, cross: bool,
             drop: bool = False) -> int:
    """Shared-memory bytes of one block of a kernel of the fused route (``bwd_layout`` in the
    source). forward: the weight ring (2 slots x 16 channels x the widest product's columns),
    x/y and under cross the kv rows [49][C], LN1(x) (then LN2(y)) and AV resident [C][60],
    q/k/v [heads][49][pitch] (before them LN1(kv) under cross, after them the MLP step's
    hidden), the masked bias table, and the row, token, column and bias tables with the LN
    statistics. mlp: the ring, y and a row buffer (g_lny, g_o) [49][C], g (then g_y) resident,
    the MLP step's g_pre, the LN2 statistics and gradient sums. attention: the ring of the g_ln
    products, q/k/v/g_o, g_q | g_k | g_v resident, the core's row sums, a row buffer, the bias
    table and the row tables. ``drop`` (the dropout form) adds after the tables: forward, the
    tokens' unit hashes at two sites and their slots, then every head's keep words; mlp, the
    unit hashes at three sites and the slots; attention, the keep words unless they fit over
    the row buffer, which is dead during the core (2 heads <= C)."""
    qkv = _align16(heads * _T * pitch * 4)
    rows_c = _align16(_T * c * 4)
    bias = _align16(_T * _T * 4)
    step = _align16(operand_bytes(False, _round_up(hc, 4)))
    if kernel == "forward":
        total = _align16(_b_bytes(False, max(3 * inner, c, _round_up(hc, 4)), _BWD_RING))
        total += rows_c * (2 if cross else 1) + _align16(operand_bytes(False, c))
        total += _align16(operand_bytes(False, inner))
        total += max(3 * qkv, step, _align16(operand_bytes(False, c)) if cross else 0)
        total += bias + _align16((3 * 64 + 2 * _COL_TABLE) * 4 + 3 * 64 * 8)
        return total + (_align16(3 * 64 * 4) + keep_words_bytes(heads) if drop else 0)
    if kernel == "mlp":
        total = _align16(_b_bytes(False, max(inner, c, _round_up(hc, 4)), _BWD_RING)) + 2 * rows_c
        total += _align16(operand_bytes(False, c)) + step + _align16(64 * 8 + 2 * c * 4)
        return total + (_align16(4 * 64 * 4) if drop else 0)
    if kernel == "attention":
        words = keep_words_bytes(heads) if drop and keep_words_bytes(heads) > rows_c else 0
        return (_align16(_b_bytes(False, c, _BWD_RING)) + 4 * qkv + _align16(operand_bytes(False, 3 * inner))
                + _align16(heads * _T * 8) + rows_c + bias + _align16(3 * 64 * 4) + words)
    raise ValueError(f"unknown kernel {kernel!r}; expected one of {BWD_KERNELS}")


def split_smem(kernel: str, c: int, inner: int, d: int, hc: int, hg_fwd: int, hg_bwd: int,
               cross: bool, drop: bool = False) -> int:
    """Shared-memory bytes of one block of a kernel of the split route (``split_smem`` in the
    source): the recompute's attention, projection rows and fc1 as the forward's split route
    lays them out in fp32 (:func:`block_smem`); the MLP backward (``split_mlp_layout``) the
    weight ring (2 x 16 x the wider of the g_lny products' column groups,
    ``window_attention.gx_width``, and the hidden step), the g_lny sums [49][C], g and the
    step's g_pre resident, the LN2 statistics and gradient sums; K3's backward block as
    ``window_attention.bwd_smem`` lays it out; the g_ln product (``gln_layout``) its A ring (2 x
    16 x 60 floats) and weight ring (2 x 16 x the column group), LN1(x)'s gradient [49][C] (two
    sides under cross), the row table, LN1 statistics and gradient sums; the LN2 epilogue
    (``split_ln2_layout``) g_lny [49][C], the LN2 statistics and sums; the LN1 epilogue
    (``split_ln1_layout``) g_ln [49][C] (two sides under cross), the LN1 statistics and sums.
    ``drop`` (the dropout form) adds the recomputed attention's token hashes and slots and its
    heads' keep words, the MLP backward's unit hashes at three sites and slots, the LN2
    epilogue's at the proj site and slots, and K3's block's keep words."""
    pitch = next(p for p in FWD_PITCHES if d <= p)
    if kernel in ("attention", "rows", "fc1"):
        return block_smem(kernel, False, cross, c, inner, hg_fwd, d, pitch, max_cols(False), drop)
    if kernel == "mlp":
        ring = _align16(_b_bytes(False, max(twa.gx_width(c), _round_up(hc, 4)), _BWD_RING))
        step = _align16(operand_bytes(False, _round_up(hc, 4)))
        total = ring + _align16(_T * c * 4) + _align16(operand_bytes(False, c)) + step + _align16(64 * 8 + 2 * c * 4)
        return total + (_align16(4 * 64 * 4) if drop else 0)
    if kernel == "attention_bwd":
        return twa.bwd_smem(False, cross, c, inner, hg_bwd, d, pitch, drop)
    if kernel == "gln":
        ring = _ring_a_bytes(False, 1, _BWD_RING) + _b_bytes(False, twa.gx_width(c), _BWD_RING)
        return _align16(ring) + (2 if cross else 1) * _align16(_T * c * 4) + _align16(64 * 4 + 64 * 8 + 2 * c * 4)
    if kernel == "ln2":
        return _align16(_T * c * 4) + _align16(64 * 8 + 2 * c * 4) + (_align16(2 * 64 * 4) if drop else 0)
    if kernel == "ln1":
        return (2 if cross else 1) * _align16(_T * c * 4) + _align16(64 * 8 + 2 * c * 4)
    raise ValueError(f"unknown kernel {kernel!r}; expected one of {SPLIT_KERNELS}")


def _core_bwd_smem(d: int, window) -> int:
    """Dynamic shared memory of ``csrc/window_core_bwd.cuh``'s core backward (the five
    route's largest block) without dropout."""
    t = window[0] * window[1]
    return (4 * t * d + 3 * t * t) * 4 + 2 * t * 4


@dataclass(frozen=True)
class BlockBwdPlan:
    """How the backward without dropout runs at one shape, in both dtypes (fp32 inside):
    ``route`` "fused" (``csrc/fused_block_bwd.cu``, seven launches: the transposed weights;
    the recomputed forward, the MLP's backward and the attention's backward, each a block per
    group of windows (49-token tiles for the MLP) and stream with ``blocks_per_sm`` blocks an
    SM, the MLP in steps of ``hidden_chunk`` columns; the LN1 backward; the weight gradients;
    one reduction), "split" (``csrc/fused_block_bwd_split.cu``, eleven launches: the
    transposed weights; the forward recomputed on the forward's split route, with
    ``heads_per_block[0]`` heads an attention block; the MLP's backward over 49-token tiles,
    ``blocks_per_sm[0]`` blocks an SM; K3's split backward block on LN1(x) and g_y,
    ``heads_per_block[1]`` heads a block in ``groups`` groups, ``blocks_per_sm[1]`` blocks an
    SM; the g_ln product with the LN1 backward in its epilogue, ``blocks_per_sm[2]`` blocks an
    SM; the weight gradients, one reduction; ``split_steps``: at pitch 48 the MLP backward's
    hidden steps and the g_ln product's column groups, each a block of a 49-token tile (the
    LN2 and LN1 epilogues then one launch more each), else (1, 1)) or "five" (``csrc/fused_block.cu``'s
    backward, twenty launches); ``smem``: (kernel, dynamic shared-memory bytes) of the route's kernels (the five route's
    largest)."""

    route: str
    launches: int
    pitch: int
    hidden_chunk: int
    smem: Tuple[Tuple[str, int], ...]
    blocks_per_sm: Tuple[int, ...] = ()
    heads_per_block: Tuple[int, ...] = ()
    groups: int = 1
    split_steps: Tuple[int, int] = (1, 1)

    def blocks(self, s: int, b: int, h: int, w: int, sms: int = DEFAULT_SMS) -> Tuple[int, ...]:
        """Blocks of each kernel whose blocks walk a list of items, one wave of the card: on
        the fused route per stream of each block kernel, at most one per window (per 49-token
        tile for the MLP's); on the split route per stream of the MLP backward and of the g_ln
        product, at most one per 49-token tile, and per (stream, group of heads) of K3's block,
        at most one per window (``window_attention.BwdPlan.blocks``)."""
        windows = b * (h // 7) * (w // 7)
        if self.route == "split":
            mlp, k3, gln = self.blocks_per_sm
            tiles = b * h * w // _T
            return (max(1, min(tiles, sms * mlp // s)), max(1, min(windows, sms * k3 // (s * self.groups))),
                    max(1, min(tiles, sms * gln // s)))
        return tuple(max(1, min(windows, sms * n // s)) for n in self.blocks_per_sm)


@functools.lru_cache(maxsize=None)
def block_bwd_plan(c: int, heads: int, d: int, hidden: int, window: Tuple[int, int],
                   cross: bool, drop: bool = False) -> BlockBwdPlan:
    """The launch plan of the backward (K1 and K4, either layout, fp32 and bf16 alike; ``drop``:
    the dropout form, whose blocks add the masks' hashes and keep words to their shared
    memory), or ValueError where no backward takes the shape. The fused route where one
    window's blocks fit a block's shared memory: 7x7 windows, d <= 8, C and heads*d
    multiples of 8, 3 heads*d <= 144 and C <= 144 (one product's columns), the hidden a
    multiple of 4, stepped through in chunks of at most 144 columns. Else the split route
    where d rounds up to a row pitch of 12, 24 or 48 (stages 2-4 of the default model), C <=
    384, the forward's fp32 plan and K3's backward plan both take their split routes (heads in
    groups of at most 48 columns a q/k/v part) and every kernel fits a block's shared memory
    (at C = 384 the MLP backward's 224 KB, one block an SM). Else the five-launch backward,
    which takes C <= 384 (its LayerNorm kernel) and no shape of the default model."""
    inner = heads * d
    pitch = next((p for p in FWD_PITCHES if d <= p), None)
    cols = max_cols(False)
    if (tuple(window) == FWD_WINDOW and pitch is not None and pitch <= BWD_PITCH_MAX and c % 8 == 0
            and inner % 8 == 0 and hidden % 4 == 0 and 3 * inner <= cols and c <= cols):
        hc = min(hidden, cols)
        smem = tuple((kernel, bwd_smem(kernel, c, inner, heads, pitch, hc, cross, drop)) for kernel in BWD_KERNELS)
        if max(b for _, b in smem) <= SMEM_LIMIT_BYTES:
            return BlockBwdPlan("fused", 7, pitch, hc, smem,
                                tuple(2 if b <= SMEM_TWO_PER_SM else 1 for _, b in smem))
    split = _split_plan(c, heads, d, hidden, tuple(window), cross, drop)
    if split is not None:
        return split
    if c > MAX_CHANNELS:
        raise ValueError(f"the fused block's backward (its LayerNorm kernel) takes C <= "
                         f"{MAX_CHANNELS}, got {c}")
    smem = _core_bwd_smem(d, window)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"the fused block's backward at d={d} needs {smem} bytes of shared "
                         f"memory, more than the {SMEM_LIMIT_BYTES} a block has")
    return BlockBwdPlan("five", 20, 0, 0, (("core_bwd", smem),))


def _split_plan(c: int, heads: int, d: int, hidden: int, window: Tuple[int, int],
                cross: bool, drop: bool = False) -> Optional[BlockBwdPlan]:
    """The split route's plan at a shape it takes, else None (``split_supported`` in the
    source)."""
    inner = heads * d
    pitch = next((p for p in FWD_PITCHES if d <= p), None)
    if (window != FWD_WINDOW or pitch not in SPLIT_PITCHES or c % 8 or inner % 8 or hidden % 4
            or c > MAX_CHANNELS):
        return None
    try:
        fwd = block_fwd_plan(c, heads, d, hidden, window, cross, False)
        k3 = twa.bwd_plan(c, heads, d, window, cross, False)
    except ValueError:
        return None
    if fwd.route != "split" or k3.route != "split":
        return None
    hc = min(hidden, max_cols(False))
    hg = (fwd.heads_per_block, k3.heads_per_block)
    smem = tuple((kernel, split_smem(kernel, c, inner, d, hc, *hg, cross, drop)) for kernel in SPLIT_KERNELS)
    wgrad = max(twa._wg_smem(ka, nb) for ka, nb in ((c, inner), (inner, c), (c, hidden), (hidden, c)))
    if max(max(b for _, b in smem), wgrad) > SMEM_LIMIT_BYTES:
        return None
    two = {kernel: 2 if b <= SMEM_TWO_PER_SM else 1 for kernel, b in smem}
    # stepped and grouped only at pitch 48 (C = 384, stage 4, split_mlp_steps and split_gln_groups
    # in the source): its MLP backward holds one block an SM, and stages 2-3 keep their bits (a
    # moved epilogue need not fuse its multiply-adds as before)
    steps = (-(-hidden // hc), -(-c // twa.gx_width(c))) if pitch == SPLIT_PITCHES[-1] else (1, 1)
    return BlockBwdPlan("split", 11, pitch, hc, smem, (two["mlp"], k3.blocks_per_sm, two["gln"]),
                        hg, heads // k3.heads_per_block, steps)


def split_workspace_floats(s: int, b: int, h: int, w: int, c: int, heads: int, d: int, hidden: int,
                           plan: BlockBwdPlan, blocks: Tuple[int, int, int], drop: bool = False) -> int:
    """Floats of workspace of one split-route call (``carve_split`` in the source, every piece
    rounded up to 32 floats): the transposed weights; LN1(x) and its statistics, AV, y,
    LN2(y), the hidden, g_pre, g_y, g_q, g_k and g_v of every token; the partial sums of the
    bias table (per K3 block), LN2 (per MLP block) and LN1 (per g_ln block) and the
    weight-gradient launch's chunks (about sixteen working blocks an SM: each
    job's own tile groups, ``wg_working_blocks`` in the source); ``drop`` (the dropout form):
    then g_m and g_proj of every token and the keep words of every (image, window, head); at
    pitch 48 (``plan.split_steps``) each hidden step's g_lny and g_ln's two sides of every
    token."""
    inner, m = heads * d, b * h * w
    sm = s * m
    mlp_blocks, k3_blocks, gln_blocks = blocks
    pieces = [s * 3 * inner * c, s * c * inner, s * hidden * c, s * c * hidden,
              sm * c, sm * 2, sm * inner, sm * c, sm * c, sm * hidden, sm * hidden, sm * c,
              sm * inner, sm * inner, sm * inner]
    pieces += [s * plan.groups * k3_blocks * _T * _T, s * mlp_blocks * 2 * c, s * gln_blocks * 2 * c]
    shapes = ((c, inner), (c, inner), (c, inner), (inner, c), (c, hidden), (hidden, c))
    working = s * sum(twa._wg_groups(ka, nb) for ka, nb in shapes)
    pieces.append(s * _wgrad_chunks(m, max(1, working // 2)) * sum((ka + 1) * nb for ka, nb in shapes))
    if drop:
        pieces += [sm * c, sm * c, keep_words_floats(s, b, h, w, heads)]
    steps, groups = plan.split_steps
    pieces += ([steps * sm * c] if steps > 1 else []) + ([2 * sm * c] if groups > 1 else [])
    return sum(_round_up(p, 32) for p in pieces)


def bwd_workspace_floats(s: int, b: int, h: int, w: int, c: int, heads: int, d: int, hidden: int,
                         blocks: Tuple[int, int, int], cross: bool, drop: bool = False) -> int:
    """Floats of workspace of one fused-route call (``carve`` in the source, every piece
    rounded up to 32 floats): the transposed weights; LN1(x) and its statistics, q, k, v,
    AV, y, g_y, g_o, LN2(y), the hidden, g_pre, g_q, g_k, g_v and g_ln (two sides under
    cross) of every token; the partial sums of the bias-table (per attention block), LN2 (per
    MLP block) and LN1 gradients and of the weight-gradient launch's chunks; ``drop`` (the
    dropout form): then g_m and g_proj of every token and the keep words of every (image,
    window, head)."""
    inner, m = heads * d, b * h * w
    sm = s * m
    _, mlp_blocks, attn_blocks = blocks
    pieces = [s * 3 * inner * c, s * c * inner, s * hidden * c, s * c * hidden,
              sm * c, sm * 2, sm * inner, sm * inner, sm * inner, sm * inner, sm * c, sm * c, sm * inner, sm * c,
              sm * hidden, sm * hidden, sm * inner, sm * inner, sm * inner, sm * c] + ([sm * c] if cross else [])
    pieces += [s * attn_blocks * _T * _T, s * mlp_blocks * 2 * c, s * -(-m // _LN1_ROWS) * 2 * c]
    per_chunk = 3 * (c + 1) * inner + (inner + 1) * c + (c + 1) * hidden + (hidden + 1) * c
    pieces.append(s * _wgrad_chunks(m, 6 * s) * per_chunk)
    if drop:
        pieces += [sm * c, sm * c, keep_words_floats(s, b, h, w, heads)]
    return sum(_round_up(p, 32) for p in pieces)


def _dims(x, weights, kw):
    """(S, B, H, W, C, heads, d, hidden, wh, ww) of a checked call."""
    h, w = _check(x, kw["layout"], kw["hw"], kw["window"])
    return (x.shape[0], x.shape[1], h, w, x.shape[-1], kw["num_heads"], kw["dims_per_head"],
            weights[-4].shape[-1], *kw["window"])


def _act(kw) -> int:
    """The kernels' activation code of a call (ELU where ``kw`` names none)."""
    return activation_code(kw.get("activation", "elu"))


def _drop_args(x, kw):
    """The kernels' dropout arguments of a call (None without dropout); kept alive by the
    caller until the launch returns."""
    rates = kw.get("drop_rates", (0.0, 0.0, 0.0))
    if not any(rates):
        return None
    h, w = _check(x, kw["layout"], kw["hw"], kw["window"])
    key = block_keying(kw["layout"], (h, w), kw["window"], kw["shift"], kw["num_heads"],
                       kw["dims_per_head"], x.device)
    return dl.drop_args(key, (rates[0], rates[1], rates[2], rates[2]), kw["drop_seed"])


def _launch_fwd(x, weights, kw) -> torch.Tensor:
    """The fp32 kernels for an fp32 x, their bf16 form (K4's or K1's rounding, by layout)
    for a bf16 x: never an upcast. K4 and K1, with and without dropout, launch the forward
    of ``csrc/fused_block_fwd.cu`` (:func:`block_fwd_plan`; a dropout call its dropout form, in
    ``csrc/fused_block_fwd_drop.cu``):
    one launch, or six with the split route's scratch (LN1(x), AV window-major and the MLP
    hidden in the operands' dtype: bf16 where K4 rounds them, fp32 for fp32 and for K1, which
    never rounds them; y in fp32)."""
    global LAUNCHES, BF16_LAUNCHES, DROP_LAUNCHES, BF16_DROP_LAUNCHES
    out = run_fwd(x, weights, kw, int(kw["shift"]))
    drop = any(kw.get("drop_rates", (0.0, 0.0, 0.0)))
    if drop and x.dtype == torch.bfloat16:
        BF16_DROP_LAUNCHES += 1
    elif drop:
        DROP_LAUNCHES += 1
    elif x.dtype == torch.bfloat16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    if kw.get("activation", "elu") != "elu":
        ACTIVATION_LAUNCHES[kw["activation"]] += 1
    return out


def run_fwd(x, weights, kw, shift: int) -> torch.Tensor:
    """:func:`_launch_fwd`'s launches without its count; ``shift`` is the source's code (0
    normal, 1 shifted, 2 the shifted windows of a band below the map's first window row,
    ``ops/window_pack_spmd.py``)."""
    s, b, h, w, c, heads, d, hidden, wh, ww = _dims(x, weights, kw)
    bf16 = x.dtype == torch.bfloat16
    ops = rounds_operands(x.dtype, kw["layout"])
    drop = _drop_args(x, kw)
    plan = block_fwd_plan(c, heads, d, hidden, (wh, ww), bool(kw["cross"]), ops, drop is not None)
    lib = _fwd_library(drop is not None)
    out = torch.empty_like(x)
    scratch = [None] * 4
    if plan.route == "split":
        tokens = s * b * h * w
        mid = torch.bfloat16 if ops else torch.float32
        scratch = [x.new_empty(tokens * c, dtype=mid), x.new_empty(tokens * heads * d, dtype=mid),
                   x.new_empty(tokens * c, dtype=torch.float32), x.new_empty(tokens * hidden, dtype=mid)]
    rc = _build.launch_on(
        x.device, lib.swin_k4_fwd,
        x.data_ptr(), *(a.data_ptr() for a in weights), out.data_ptr(),
        *(None if a is None else a.data_ptr() for a in scratch), dl.drop_pointer(drop),
        s, b, h, w, c, heads, d, hidden, plan.heads_per_block, plan.hidden_chunk,
        int(plan.route == "fused"), shift, int(kw["cross"]),
        int(kw["layout"] == "windows"), int(bf16), int(ops), float(d**-0.5), _act(kw),
    )
    _build.check_launch(lib, rc, "fused block")
    return out


def _launch_five(x, weights, kw) -> torch.Tensor:
    """The five launches of ``csrc/fused_block.cu`` (``swin_fused_block_fwd``, the form that
    the five route's backward recomputes), K1 and K4 with and without dropout: the old form,
    which the card checks time the redesigned forward against. No forward of the model runs
    it; counts nothing."""
    s, b, h, w, c, heads, d, hidden, wh, ww = _dims(x, weights, kw)
    drop = _drop_args(x, kw)
    inner = heads * d
    bf16 = x.dtype == torch.bfloat16
    # AV and the MLP hidden are bf16 where the kernel rounds them (K4 in bf16)
    mid = torch.bfloat16 if rounds_operands(x.dtype, kw["layout"]) else torch.float32
    lib = _library()
    out = torch.empty_like(x)
    tokens = b * h * w  # per stream
    # q (scaled), k, v and AV of every token, the MLP hidden, and y = x + proj in fp32
    # when the output is bf16 (fp32 writes y into `out`): written and read once
    f32 = torch.float32
    scratch = [x.new_empty(s, tokens, inner, dtype=f32) for _ in range(3)]
    scratch += [x.new_empty(s, tokens, inner, dtype=mid), x.new_empty(s, tokens, hidden, dtype=mid),
                x.new_empty(s, tokens, c, dtype=f32) if bf16 else out]
    rc = _build.launch_on(
        x.device, lib.swin_fused_block_fwd,
        x.data_ptr(), *(a.data_ptr() for a in weights), out.data_ptr(),
        *(a.data_ptr() for a in scratch), dl.drop_pointer(drop),
        s, b, h, w, c, heads, d, hidden, wh, ww, int(kw["shift"]), int(kw["cross"]),
        int(kw["layout"] == "windows"), int(bf16), float(d**-0.5), _act(kw),
    )
    _build.check_launch(lib, rc, "fused block")
    return out


def _launch_bwd(g, x, weights, kw) -> Tuple[torch.Tensor, ...]:
    """The fp32 backward kernels for an fp32 x, their bf16 form (fp32 inside, g_x in bf16,
    the weight gradients fp32; K1 and K4 alike) for a bf16 x, with or without dropout.
    :func:`block_bwd_plan` routes the call ("fused": ``csrc/fused_block_bwd.cu``, "split":
    ``csrc/fused_block_bwd_split.cu``, each in its dropout form for a dropout call); the
    "five" route (no stage of the default model) runs ``csrc/fused_block.cu``'s backward. A
    call whose route fails to build or launch raises: no route falls back to another."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES, DROP_BWD_LAUNCHES, BF16_DROP_BWD_LAUNCHES
    s, b, h, w, c, heads, d, hidden, wh, ww = _dims(x, weights, kw)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"the output gradient must be {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    bf16 = x.dtype == torch.bfloat16
    drop = _drop_args(x, kw) is not None
    plan = block_bwd_plan(c, heads, d, hidden, (wh, ww), bool(kw["cross"]), drop)
    if plan.route == "fused":
        grads = _launch_bwd_fused(g, x, weights, kw, plan)
    elif plan.route == "split":
        grads = _launch_bwd_split(g, x, weights, kw, plan)
    else:
        grads = _launch_bwd_five(g, x, weights, kw)
    if drop and bf16:
        BF16_DROP_BWD_LAUNCHES += 1
    elif drop:
        DROP_BWD_LAUNCHES += 1
    elif bf16:
        BF16_BWD_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    if kw.get("activation", "elu") != "elu":
        ACTIVATION_BWD_LAUNCHES[kw["activation"]] += 1
    return grads


def _launch_bwd_fused(g, x, weights, kw, plan: BlockBwdPlan) -> Tuple[torch.Tensor, ...]:
    """``csrc/fused_block_bwd.cu``'s seven launches (the dropout form for a dropout call): x, g
    and g_x in x's dtype, the weight gradients fp32, the workspace
    (:func:`bwd_workspace_floats`) fp32."""
    s, b, h, w, c, heads, d, hidden, wh, ww = _dims(x, weights, kw)
    cross = bool(kw["cross"])
    drop = _drop_args(x, kw)
    blocks = plan.blocks(s, b, h, w, _sm_count(x.device))
    lib = _bwd_library()
    grads = [torch.empty_like(a) for a in (x, *weights)]
    floats = bwd_workspace_floats(s, b, h, w, c, heads, d, hidden, blocks, cross, drop is not None)
    workspace = x.new_empty(floats, dtype=torch.float32)
    ins = (_P * (len(weights) + 2))(*(a.data_ptr() for a in (x, *weights, g)))
    outs = (_P * len(grads))(*(a.data_ptr() for a in grads))
    rc = _build.launch_on(
        x.device, lib.swin_block_bwd,
        ins, outs, workspace.data_ptr(), floats, dl.drop_pointer(drop), s, b, h, w, c, heads, d, hidden,
        plan.hidden_chunk, *blocks, int(kw["shift"]), int(cross), int(kw["layout"] == "windows"),
        int(x.dtype == torch.bfloat16), float(d**-0.5), _act(kw),
    )
    _build.check_launch(lib, rc, "fused block backward")
    return tuple(grads)


def _launch_bwd_split(g, x, weights, kw, plan: BlockBwdPlan) -> Tuple[torch.Tensor, ...]:
    """``csrc/fused_block_bwd_split.cu``, eleven launches (the dropout form for a dropout
    call; one more each at pitch 48, where ``plan.split_steps`` steps the MLP backward and
    groups the g_ln product): x, g and g_x in x's dtype, the weight gradients fp32, the workspace
    (:func:`split_workspace_floats`) fp32."""
    s, b, h, w, c, heads, d, hidden, wh, ww = _dims(x, weights, kw)
    cross = bool(kw["cross"])
    drop = _drop_args(x, kw)
    blocks = plan.blocks(s, b, h, w, _sm_count(x.device))
    lib = _split_library()
    grads = [torch.empty_like(a) for a in (x, *weights)]
    floats = split_workspace_floats(s, b, h, w, c, heads, d, hidden, plan, blocks, drop is not None)
    workspace = x.new_empty(floats, dtype=torch.float32)
    ins = (_P * (len(weights) + 2))(*(a.data_ptr() for a in (x, *weights, g)))
    outs = (_P * len(grads))(*(a.data_ptr() for a in grads))
    rc = _build.launch_on(
        x.device, lib.swin_block_bwd_split,
        ins, outs, workspace.data_ptr(), floats, dl.drop_pointer(drop), s, b, h, w, c, heads, d, hidden,
        plan.hidden_chunk,
        *plan.heads_per_block, *blocks, int(kw["shift"]), int(cross), int(kw["layout"] == "windows"),
        int(x.dtype == torch.bfloat16), float(d**-0.5), _act(kw),
    )
    _build.check_launch(lib, rc, "fused block backward")
    return tuple(grads)


def _launch_bwd_five(g, x, weights, kw) -> Tuple[torch.Tensor, ...]:
    """``csrc/fused_block.cu``'s backward (the five route, with and without dropout; callable
    at any shape for timing in turns): it recomputes with the five launches and runs
    twenty in all (with dropout, its ``dropout_rows_kernel`` launches too). Counts nothing
    (:func:`_launch_bwd` does)."""
    dims = _dims(x, weights, kw)
    d = kw["dims_per_head"]
    g = g.contiguous()
    bf16 = x.dtype == torch.bfloat16
    drop = _drop_args(x, kw)
    lib = _library()
    grads = [torch.empty_like(a) for a in (x, *weights)]
    workspace = x.new_empty(lib.swin_fused_block_bwd_workspace(
        *dims, dl.drop_pointer(drop), int(bf16), int(kw["cross"])), dtype=torch.float32)
    ins = (_P * (len(weights) + 2))(*(a.data_ptr() for a in (x, *weights, g)))
    outs = (_P * len(grads))(*(a.data_ptr() for a in grads))
    rc = _build.launch_on(
        x.device, lib.swin_fused_block_bwd,
        ins, outs, workspace.data_ptr(), dl.drop_pointer(drop), *dims, int(kw["shift"]),
        int(kw["cross"]), int(kw["layout"] == "windows"), int(bf16), float(d**-0.5), _act(kw),
    )
    _build.check_launch(lib, rc, "fused block backward")
    return tuple(grads)


class _FusedBlockFunction(torch.autograd.Function):
    """The kernels' forward and backward on a card, the plain versions on the CPU (a bf16
    call, whose plain backward is not autograd of its plain forward); saves only x and the
    weights (and, in ``kw``, the dropout's rates and seed, so that the backward recomputes
    the forward's masks)."""

    @staticmethod
    def forward(ctx, kw, x, *weights):
        ctx.kw = kw
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cpu":
            return fused_block_plain(x, *weights, **kw)
        return _launch_fwd(x, weights, kw)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        if x.device.type == "cpu":
            return (None, *fused_block_bwd_plain(g, x, *weights, **ctx.kw))
        return (None, *_launch_bwd(g, x, weights, ctx.kw))


def fused_block(x, ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wp, bp, bias,
                ln2_scale, ln2_bias, w1, b1, w2, b2, *, window: Tuple[int, int],
                num_heads: int, dims_per_head: int, shift: bool, cross: bool,
                layout: str, hw: Optional[Tuple[int, int]] = None,
                activation: str = "elu", drop_rates: Tuple[float, float, float] = (0.0, 0.0, 0.0),
                drop_seed: Optional[int] = None) -> torch.Tensor:
    """One fused Swin block: the plain version on the CPU (with its plain backward when
    autograd records a bf16 call), the CUDA kernels on a card.

    Arguments as :func:`fused_block_plain`. On a CUDA tensor every argument must be a
    contiguous tensor on that device, x float32 or bfloat16 and every weight float32;
    anything else raises. A bf16 x runs the bf16 form of the kernels, dropout their dropout
    form. When autograd records the call, its backward is the backward kernel of x's dtype.
    """
    kw = dict(window=window, num_heads=num_heads, dims_per_head=dims_per_head,
              shift=shift, cross=cross, layout=layout, hw=hw, activation=activation,
              drop_rates=tuple(float(r) for r in drop_rates), drop_seed=drop_seed)
    weights = (ln1_scale, ln1_bias, wq, bq, wk, bk, wv, bv, wp, bp, bias,
               ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16 and recorded(x, *weights):
            return _FusedBlockFunction.apply(kw, x, *weights)
        return fused_block_plain(x, *weights, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block runs on cpu or cuda tensors, not {x.device}")
    activation_code(activation)
    _check(x, layout, hw, window)
    s, c = x.shape[0], x.shape[-1]
    wh, ww = window
    t = wh * ww
    inner = num_heads * dims_per_head
    hidden = w1.shape[-1]
    expected = {
        "ln1_scale": (s, c), "ln1_bias": (s, c),
        "wq": (s, c, inner), "bq": (s, inner), "wk": (s, c, inner), "bk": (s, inner),
        "wv": (s, c, inner), "bv": (s, inner), "wp": (s, inner, c), "bp": (s, c),
        "bias": (s, t, t), "ln2_scale": (s, c), "ln2_bias": (s, c),
        "w1": (s, c, hidden), "b1": (s, hidden), "w2": (s, hidden, c), "b2": (s, c),
    }
    for name, a in zip(("x", *WEIGHT_NAMES), (x, *weights)):
        dtypes = ACT_DTYPES if name == "x" else (torch.float32,)
        if a.device != x.device or a.dtype not in dtypes or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {' or '.join(map(str, dtypes))} "
                             f"tensor on {x.device}, got {a.dtype} on {a.device}, "
                             f"contiguous={a.is_contiguous()}")
        if name in expected and tuple(a.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {expected[name]}")
    if not 1 <= s <= MAX_STREAMS or (cross and s < 2):
        raise ValueError(f"the kernel takes 1 to {MAX_STREAMS} streams (2 for cross), got {s}")
    dl.check_seed(drop_rates, drop_seed)
    block_fwd_plan(c, num_heads, dims_per_head, hidden, tuple(window), bool(cross),
                   rounds_operands(x.dtype, layout), any(drop_rates))
    if recorded(x, *weights):
        block_bwd_plan(c, num_heads, dims_per_head, hidden, tuple(window), bool(cross), any(drop_rates))
        return _FusedBlockFunction.apply(kw, x, *weights)
    return _launch_fwd(x, weights, kw)
