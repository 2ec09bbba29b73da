"""Window attention (K3): the CUDA kernels' wrapper, their plain PyTorch version and
the launch counter.

Counterpart of the JAX ``ops/pallas_attention.py::pallas_window_attention`` forward
(kernel ``_attention_fwd_kernel``). Semantics, kept by both versions here:

- per-head q/k/v projections; the scale ``d**-0.5`` is folded into q before the dot;
- scores plus the shared (T, T) relative-position bias, then the shift mask **sets**
  scores to -1e10;
- the TPU kernel's fast softmax: a one-sided clamp at 80, ``exp`` without the max
  subtraction, then a multiply by ``1 / (sum + 1e-30)``;
- the shifted partition is the map rolled by ``(top, left) = (wh - wh//2, ww - ww//2)``
  with same-region masks on the wrap seams (``_wrap_region_mask``), rolled back after;
- cross attention takes k/v from the stream-flipped input, with stream s's weights.

x and the output are fp32 or bf16; the weights are always fp32. In bf16 both versions
round where the TPU body ``_attention_fwd_body`` rounds: the weights to bf16 as they are
loaded, so q/k/v are bf16 products accumulated in fp32 (+ the fp32 biases); the scores
and the fast softmax stay fp32; p and v are rounded to bf16 before AV, AV is rounded
before the projection, whose fp32 sum plus ``bp`` is rounded once on the store.

``window_attention`` runs the plain version for a CPU tensor and launches kernels for a
CUDA tensor. Every call, with and without dropout, runs ``csrc/window_attention_fwd.cu`` as
:func:`fwd_plan` lays it out: one block per window and stream computes q/k/v, scores,
mask, softmax and AV in shared memory and, where every head fits a block that two can
share an SM (the stages with C <= 64 of the default model), the output projection too:
one launch; elsewhere a block takes a group of heads and writes AV, and a second launch
projects. On the tensor cores in bf16 (``mma.sync``), on fp32 FMA in fp32. A dropout call
runs the attention block's dropout form on the same route. That is the 7x7 build, whose T = 49
is a compile-time constant; any other window of at most 64 tokens runs the same kernels'
any-window build, ``csrc/window_attention_fwd_any.cu`` (and the backward's
``window_attention_bwd_any.cu``): T, wh and ww at run time, 64 rows a block
(:func:`window_class`). A larger window raises. ``_launch_three`` keeps the three launches of
``csrc/window_attention.cu`` (a batched GEMM for q/k/v, one block per (window, stream, head)
for scores, mask, softmax and AV, a batched GEMM for the output projection) callable, for
timing in turns; no call of the model runs them. There is no fallback between the versions.

On a card, a call that autograd records (grad mode on and an input that requires grad)
goes through ``_WindowAttentionFunction``, whose backward (K3 bwd) recomputes q/k/v and AV
from x and the weights, as the JAX custom VJP does, and returns g_x and every weight's
gradient. With and without dropout it runs ``csrc/window_attention_bwd.cu`` as
:func:`bwd_plan` lays it out: a block per (group of windows, stream, group of heads)
recomputes each window in shared memory and backpropagates it; where every head fits a block
(the stages with d <= 8 of the default model) the block also forms g_x ("fused"), elsewhere a
second kernel does ("split"); one weight-gradient launch and one reduction follow. A dropout
call runs the block's dropout form: it hashes its window's attention keep bits once per head
(two 32-bit words a query row), recomputes AV from the dropped weights and masks g_P with the
same bits. ``_launch_bwd_three`` keeps ``swin_window_attention_bwd`` of
``csrc/window_attention.cu`` (the three-launch recompute and the old core backward) callable,
for timing in turns; no call falls back to it.
``window_attention_bwd_plain`` is the plain backward (autograd of the plain version); it
differs from the kernels only where a score exceeds the softmax clamp of 80, whose
derivative the kernels, like the TPU's, do not take. For a bf16 x both are what the JAX
backward body computes (``_attention_bwd_body`` l.388-390, 495-498): the fp32 backward
at the upcast x and g (not autograd of the bf16 forward's rounding points), the weight
gradients fp32 and g_x in bf16, rounded once in self mode; under cross the q side and the
k/v side (which JAX writes as two bf16 outputs, gx and gkv) are rounded apart and added in
bf16.

Dropout (training): ``attn_drop_rate`` > 0 with a ``drop_seed`` in [0, 2^24) masks the
normalised attention weights before AV with the hash masks of the TPU kernel
(``_attention_fwd_kernel`` l.278-290, 322-323), keyed on its wrap windows
(``ops/dropout_layout.py``, ``"k3"``), in both versions and in the backward. The
projection's dropout is the caller's, on the output, as in the JAX package. On a card a
dropout call launches the kernels' dropout form (fp32 or bf16; the masks do not depend on
the dtype): the forward's block hashes each weight's keep bit in its fp32 core, or two keep
words a query row once per head for its bf16 core, and stores none; the backward hashes its
own. Dropout calls are counted in ``DROP_LAUNCHES`` and ``DROP_BWD_LAUNCHES``
(``BF16_DROP_LAUNCHES`` and ``BF16_DROP_BWD_LAUNCHES`` in bf16) instead of ``LAUNCHES`` and
``BWD_LAUNCHES`` (``BF16_LAUNCHES`` and ``BF16_BWD_LAUNCHES``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from . import dropout_layout as dl
from . import hash_dropout as hd
from .window import apply_shift_mask, device_constant, window_partition, window_unpartition

SOFTMAX_CLAMP = 80.0
SMEM_LIMIT_BYTES = 232_448  # what one block may use on Hopper
SMEM_TWO_PER_SM = 233_472 // 2 - 1024  # where two blocks of a kernel share an SM
DEFAULT_SMS = 132  # SMs of an H100 SXM: a plan's block count where no card is given
MAX_STREAMS = 2  # the kernel's batched projections hold 3 * streams operands

ACT_DTYPES = (torch.float32, torch.bfloat16)  # of x and the output; weights are fp32

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


def round_to_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bf16 value (ties to even), kept in its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def operand_rounding(bf16: bool):
    """What an operand of a bf16 product goes through: rounding to bf16, or nothing."""
    return round_to_bf16 if bf16 else _identity


def wrap_offsets(window: Tuple[int, int]) -> Tuple[int, int]:
    """(top, left) roll of the shifted partition."""
    return window[0] - window[0] // 2, window[1] - window[1] // 2


@functools.lru_cache(maxsize=None)
def wrap_region_mask(hw: Tuple[int, int], window: Tuple[int, int]) -> np.ndarray:
    """(nWin, T, T) bool mask of the rolled map's wrap seams: tokens attend only within
    their own (row-region, column-region), where a region is "rolled row < top" and
    "rolled column < left" (JAX ``pallas_attention.py::_wrap_region_mask``)."""
    h, w = hw
    wh, ww = window
    top, left = wrap_offsets(window)
    rows = (np.arange(h) < top).reshape(h // wh, wh)
    cols = (np.arange(w) < left).reshape(w // ww, ww)
    rreg = np.repeat(rows, ww, axis=1)  # (nh, T)
    creg = np.tile(cols, (1, wh))  # (nw, T)
    rdiff = rreg[:, None, :, None] != rreg[:, None, None, :]  # (nh, 1, T, T)
    cdiff = creg[None, :, :, None] != creg[None, :, None, :]  # (1, nw, T, T)
    t = wh * ww
    return (rdiff | cdiff).reshape(-1, t, t)


def fast_softmax(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis without max subtraction, overflow-clamped at 80."""
    e = torch.exp(torch.clamp(s, max=SOFTMAX_CLAMP))
    return e * (1.0 / (e.sum(dim=-1, keepdim=True) + 1e-30))


def _check_geometry(x: torch.Tensor, window: Tuple[int, int]) -> None:
    if x.dtype not in ACT_DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim != 5:
        raise ValueError(f"x must be (S, B, H, W, C), got shape {tuple(x.shape)}")
    h, w = x.shape[2], x.shape[3]
    if h % window[0] or w % window[1]:
        raise ValueError(f"map {h}x{w} is not a multiple of the window {window}")


def attention_keying(hw, window, shift: bool, num_heads: int, dims_per_head: int,
                     device) -> dl.Keying:
    """K3's dropout keying of an ``hw`` map (``dropout_layout.py``, ``"k3"``)."""
    return dl.keying("k3", hw, window, shift, num_heads, dims_per_head, device)


def window_attention_plain(
    x, wq, bq, wk, bk, wv, bv, wp, bp, bias, *,
    window: Tuple[int, int], num_heads: int, dims_per_head: int, shift: bool, cross: bool,
    attn_drop_rate: float = 0.0, drop_seed: Optional[int] = None,
    kv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same inputs and semantics.

    x: (S, B, H, W, C) fp32 or bf16; wq/wk/wv: (S, C, inner); bq/bk/bv: (S, inner); wp:
    (S, inner, C); bp: (S, C); bias: (S, T, T) gathered relative-position bias, all fp32.
    Returns (S, B, H, W, C) in x's dtype, computed in fp32 with the bf16 rounding points
    of the module docstring when x is bf16, the attention weights masked by the hash
    dropout of ``attn_drop_rate`` and ``drop_seed``. ``kv``: the tensor k/v are made from
    (stream-flipped under cross), x itself by default; the plain backward passes a copy
    of x to keep the k/v side of x's gradient apart.
    """
    _check_geometry(x, window)
    dl.check_seed((attn_drop_rate,), drop_seed)
    rnd = operand_rounding(x.dtype == torch.bfloat16)
    s, b, h, w, _ = x.shape
    t = window[0] * window[1]
    d = dims_per_head
    inner = num_heads * d
    top, left = wrap_offsets(window)

    def windows(a):  # (S, B, H, W, C) -> (S, Bw, T, C) fp32, in the shifted partition
        a = a.float()
        if shift:
            a = torch.roll(a, shifts=(top, left), dims=(2, 3))
        return window_partition(a, window)

    xw = windows(x)
    kvw = xw if kv is None else windows(kv)
    kvw = kvw.flip(0) if cross else kvw
    bw = xw.shape[1]

    def proj(a, wmat, bvec):  # (S, Bw, T, C) -> (S, Bw, heads, T, d)
        y = torch.einsum("sntc,sci->snti", a, rnd(wmat)) + bvec[:, None, None, :]
        return y.reshape(s, bw, t, num_heads, d).transpose(2, 3)

    q = proj(xw, wq, bq) * d**-0.5
    k = proj(kvw, wk, bk)
    v = proj(kvw, wv, bv)
    scores = q @ k.transpose(-1, -2) + bias[:, None, None]
    if shift:
        scores = apply_shift_mask(
            scores, device_constant(wrap_region_mask, ((h, w), tuple(window)), x.device))
    p = fast_softmax(scores)
    if attn_drop_rate:
        k3 = attention_keying((h, w), window, shift, num_heads, d, x.device)
        keep = dl.attention_keep(drop_seed, attn_drop_rate, k3,
                                 dl.windows_table(k3), s, b, num_heads)
        p = hd.apply_mask(p, keep.reshape(p.shape), attn_drop_rate)
    av = rnd(rnd(p) @ rnd(v))
    av = av.transpose(2, 3).reshape(s, bw, t, inner)
    out = torch.einsum("snti,sic->sntc", av, rnd(wp)) + bp[:, None, None, :]
    out = window_unpartition(out, window, (h, w))
    if shift:
        out = torch.roll(out, shifts=(-top, -left), dims=(2, 3))
    return out.to(x.dtype)


_P = ctypes.c_void_p
_I = ctypes.c_int


def split_input_grad(x, run, g, cross: bool) -> Tuple[torch.Tensor, ...]:
    """(g_x, the weight gradients) of ``run(xq, xkv)``, the fp32 forward of a kernel whose
    q side reads ``xq`` and whose k/v side reads ``xkv`` (x upcast; None in self mode,
    where both read ``xq``), for the output gradient ``g``: the JAX bf16 backward bodies'
    result. g_x is in x's dtype: the fp32 sum rounded once in self mode; under cross the q
    side and the k/v side rounded apart and added in x's dtype, as JAX adds its kernels'
    gx and gkv outputs."""
    xq = x.detach().float().requires_grad_()
    xkv = x.detach().float().requires_grad_() if cross else None
    out, weights = run(xq, xkv)
    inputs = [xq, xkv, *weights] if cross else [xq, *weights]
    grads = torch.autograd.grad(out, inputs, g.float())
    if not cross:
        return (grads[0].to(x.dtype), *grads[1:])
    gx = (grads[0].to(x.dtype).float() + grads[1].to(x.dtype).float()).to(x.dtype)
    return (gx, *grads[2:])


def window_attention_bwd_plain(g, x, *weights, **kw) -> Tuple[torch.Tensor, ...]:
    """Plain backward: (g_x, the 9 weight gradients) of :func:`window_attention_plain`
    for the output gradient ``g``. Keyword arguments as the forward's. fp32: autograd of
    the plain version. bf16: the fp32 backward at the upcast x and g, g_x in bf16
    (:func:`split_input_grad`), the weight gradients fp32 (module docstring)."""
    with torch.enable_grad():
        if x.dtype == torch.float32:
            inputs = [a.detach().requires_grad_() for a in (x, *weights)]
            return torch.autograd.grad(window_attention_plain(*inputs, **kw), inputs, g)
        leaves = [a.detach().requires_grad_() for a in weights]
        return split_input_grad(
            x, lambda xq, xkv: (window_attention_plain(xq, *leaves, kv=xkv, **kw), leaves),
            g, kw["cross"])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("window_attention")
    drop = ctypes.POINTER(dl.DropArgs)
    lib.swin_window_attention_fwd.argtypes = [_P] * 15 + [drop] + [_I] * 12 + [ctypes.c_float, _P]
    lib.swin_window_attention_fwd.restype = _I
    lib.swin_window_attention_bwd_workspace.argtypes = [_I] * 11
    lib.swin_window_attention_bwd_workspace.restype = ctypes.c_size_t
    lib.swin_window_attention_bwd.argtypes = [_P] * 3 + [drop] + [_I] * 12 + [ctypes.c_float, _P]
    lib.swin_window_attention_bwd.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library(build: str = "") -> ctypes.CDLL:
    """``csrc/window_attention_bwd{build}.cu``: the 7x7 build (""), or the any-window one without
    dropout ("_any") or with it ("_any_drop") (:meth:`WindowClass.bwd_build`)."""
    lib = _build.load(f"window_attention_bwd{build}")
    drop = ctypes.POINTER(dl.DropArgs)
    lib.swin_k3_bwd.argtypes = [_P, _P, _P, ctypes.c_size_t, drop] + [_I] * 13 + [ctypes.c_float, _I, _I, _P]
    lib.swin_k3_bwd.restype = _I
    lib.swin_k3_bwd_smem.argtypes = [_I] * 10
    lib.swin_k3_bwd_smem.restype = ctypes.c_size_t
    lib.swin_k3_bwd_workspace.argtypes = [_I] * 13
    lib.swin_k3_bwd_workspace.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_library(build: str = "") -> ctypes.CDLL:
    """``csrc/window_attention_fwd{build}.cu``: the 7x7 build ("") or the any-window one ("_any")."""
    lib = _build.load(f"window_attention_fwd{build}")
    lib.swin_k3_fwd.argtypes = [_P] * 12 + [ctypes.POINTER(dl.DropArgs)] + [_I] * 12 + [ctypes.c_float, _I, _I, _P]
    lib.swin_k3_fwd.restype = _I
    lib.swin_k3_fwd_smem.argtypes = [_I] * 12
    lib.swin_k3_fwd_smem.restype = ctypes.c_size_t
    return lib


# ---- the window classes (csrc/window_fwd.cuh): which build of the kernels a window runs ------
FWD_WINDOW = (7, 7)  # the window of the 7x7 build, whose T = 49 is a compile-time constant
MAX_WINDOW_TOKENS = 64  # the largest window (wh * ww tokens) the any-window build takes


@dataclass(frozen=True)
class WindowClass:
    """The build of K3's kernels that a window runs, and the block geometry it fixes (as
    ``csrc/window_fwd.cuh``, ``window_bwd.cuh``): ``build`` the sources' suffix ("" for
    ``window_attention_fwd.cu`` / ``_bwd.cu``, "_any" for ``window_attention_fwd_any.cu`` /
    ``_bwd_any.cu``); ``t`` the window's tokens; ``row_groups`` the fp32 GEMMs' groups of 8 rows;
    ``pitch_f`` floats a channel of an fp32 A operand; ``tile_n`` the forward GEMM's register tile
    columns; ``core_rows`` and ``pp`` the rows and row pitch of the tiled core's P and g_S."""

    build: str
    t: int
    row_groups: int
    pitch_f: int
    tile_n: int
    core_rows: int
    pp: int

    def bwd_build(self, drop: bool) -> str:
        """The backward library's suffix: the 7x7 build holds both forms of the block kernel; the
        any-window backward is built once a form, ``_bwd_any.cu`` and ``_bwd_any_drop.cu``, so
        that the two halves of the longest build compile at once."""
        return self.build + ("_drop" if drop and self.build else "")


SEVEN = WindowClass("", 49, 7, 60, 4, 49, 52)


@functools.lru_cache(maxsize=None)
def window_class(window: Tuple[int, int]) -> WindowClass:
    """The 7x7 build for (7, 7); the any-window build (64 rows a block: eight row groups of 8 x 8
    register tiles, A rows pitched 68 floats, the tiled core's rows pitched 65) for any other
    window of at most ``MAX_WINDOW_TOKENS`` tokens; ValueError naming "windows" above it."""
    wh, ww = window
    if (wh, ww) == FWD_WINDOW:
        return SEVEN
    if wh < 1 or ww < 1 or wh * ww > MAX_WINDOW_TOKENS:
        raise ValueError(f"the window-attention kernels take windows of at most {MAX_WINDOW_TOKENS} tokens, "
                         f"got {tuple(window)} ({wh * ww} tokens)")
    return WindowClass("_any", wh * ww, 8, 68, 8, 64, 65)


# ---- the forward (csrc/window_attention_fwd.cu): its launch plan ----------------------------
# Block geometry of the kernels, as in the source: 256 threads; fp32 GEMM rows in groups of 8
# (the window class's: 7 groups of 8x4 register tiles for 7x7 windows, 8 of 8x8 tiles for the
# others, at most one tile per thread), bf16 rows padded to 64 (mma tiles of 16 rows and 8
# columns, at most three column tiles per warp); channels in chunks of 16; tables of at most
# 192 q/k/v columns.
FWD_PITCHES = (4, 8, 12, 16, 24, 32, 48)  # q/k row pitches (d rounded up), one kernel each
_THREADS, _WARPS, _ROWS_B, _KC = 256, 8, 64, 16
_STAGES, _PROJ_STAGES = 3, 6  # cp.async ring depths of the attention and projection kernels
_STRIDE_B, _P_STRIDE, _MAX_COLS = 24, 72, 3 * 8 * 8
PROJ_COLS = 48  # output columns per block of the projection launch
GROUP_COLS = 48  # q/k/v columns per part that a block of the split route takes at most
FUSED_SMEM_MAX = SMEM_LIMIT_BYTES // 2  # the one-launch route only where two blocks fit an SM


@dataclass(frozen=True)
class FwdPlan:
    """How the forward (or its dropout form) runs at one shape: ``route`` "fused" (one launch, a
    block per window and stream with every head, the projection included) or "split" (a
    block per window, stream and group of ``heads_per_block`` heads writes AV, then a
    projection launch over 48-column groups); ``smem`` and ``proj_smem`` are each block's
    shared-memory bytes (``proj_smem`` 0 when fused)."""

    route: str
    launches: int
    heads_per_block: int
    pitch: int
    smem: int
    proj_smem: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _align16(v: int) -> int:
    return _round_up(v, 16)


def _f32_tiles(nb: int, cls: WindowClass = SEVEN) -> int:
    return cls.row_groups * (nb // cls.tile_n)


def _ring_a_bytes(bf16: bool, parts: int, stages: int, pitch_f: int = SEVEN.pitch_f) -> int:
    return stages * parts * (_ROWS_B * _STRIDE_B * 2 if bf16 else _KC * pitch_f * 4)


def _b_bytes(bf16: bool, nb: int, stages: int) -> int:
    """The fp32 weight ring; in bf16 rows pitched nb + 4 floats."""
    return stages * _KC * (nb + 4 if bf16 else nb) * 4


def attention_smem(bf16: bool, fused: bool, cross: bool, c: int, inner: int, hg: int, d: int,
                   pitch: int, drop: bool = False, window: Tuple[int, int] = FWD_WINDOW) -> int:
    """Shared-memory bytes of one attention block (``attention_layout`` in the source) at
    ``window``: the GEMM space (the x and weight rings; after the q/k/v GEMM, bf16's P and the
    fused route's wp), q/k/v (T rows a head), AV when fused, the T x T bias table, the row and
    column tables; ``drop`` (the dropout form, ``drop_attention_bytes``) adds the tokens' unit
    hashes and slots and, for the bf16 core, the keep words of the block's heads."""
    cls = window_class(window)
    t = cls.t
    ki = _round_up(inner, _KC)
    ring = _ring_a_bytes(bf16, 2 if cross else 1, _STAGES, cls.pitch_f) + _b_bytes(bf16, 3 * hg * d, _STAGES)
    after = (_WARPS * 32 * _P_STRIDE * 2 if bf16 else 0) + (ki * (c + 4 if bf16 else c) * 4 if fused else 0)
    total = _align16(max(ring, after)) + 2 * _align16(hg * t * pitch * 4)
    total += _align16(hg * _round_up(d, 8) * _P_STRIDE * 2 if bf16 else hg * t * pitch * 4)
    if fused:
        total += _align16(_ROWS_B * (ki + 8) * 2 if bf16 else ki * cls.pitch_f * 4)
    total += _align16(t * t * 4) + _align16((2 * _ROWS_B + 3 * _MAX_COLS) * 4)
    if drop:
        total += _align16(2 * _ROWS_B * 4) + (keep_words_bytes(hg, window) if bf16 else 0)
    return total


def proj_smem(bf16: bool, window: Tuple[int, int] = FWD_WINDOW) -> int:
    """Shared-memory bytes of one projection block (``proj_layout`` in the source)."""
    gemm = (_ring_a_bytes(bf16, 1, _PROJ_STAGES, window_class(window).pitch_f)
            + _b_bytes(bf16, PROJ_COLS, _PROJ_STAGES))
    return _align16(gemm) + _align16(2 * _ROWS_B * 4)


def _takes(c: int, heads: int, d: int, hg: int, fused: bool, cls: WindowClass = SEVEN) -> bool:
    """The kernels' limits on a head grouping (``supported`` in the source): every q/k/v column
    and, fused, every output column a tile of the block's threads."""
    n = hg * d
    if n % 8 or 3 * n > _MAX_COLS or _f32_tiles(3 * n, cls) > _THREADS:
        return False
    return not fused or (c <= _MAX_COLS and _f32_tiles(c, cls) <= _THREADS)


@functools.lru_cache(maxsize=None)
def fwd_plan(c: int, heads: int, d: int, window: Tuple[int, int], cross: bool,
             bf16: bool, drop: bool = False) -> FwdPlan:
    """The launch plan of the forward (``drop``: its dropout form, whose blocks add the
    masks' pieces to their shared memory), or ValueError where its kernels do
    not take the shape: windows of at most 64 tokens (7x7 runs the 7x7 build, any other the
    any-window build, ``window_class``), d <= 48, C and heads*d multiples of 8. Every head in
    one block (one launch) where q, k, v of every head fit its column tiles (3 heads*d <=
    192) and two such blocks fit an SM (alone on an SM a block waits on each of its phases);
    else the largest group of heads with at most 48 columns per q/k/v part (a multiple of
    8) and the projection as a second launch. With dropout every stage of the default model
    at 7x7 keeps its route: the masks add 512 bytes (fp32) or 3,648 (bf16) to a stage-1 block,
    which stays within two an SM. At 8x8 the 64-row blocks move stage 1 (C = 48) to the split
    route, but for its bf16 form without dropout (115,200 bytes, within two an SM)."""
    inner = heads * d
    cls = window_class(tuple(window))
    pitch = next((p for p in FWD_PITCHES if d <= p), None)
    if pitch is None:
        raise ValueError(f"the window-attention forward takes at most {FWD_PITCHES[-1]} dims per "
                         f"head, got {d}")
    if c % 8 or inner % 8:
        raise ValueError(f"the window-attention forward takes C and heads*d multiples of 8, "
                         f"got C={c}, heads*d={inner}")
    if _takes(c, heads, d, heads, True, cls):
        smem = attention_smem(bf16, True, cross, c, inner, heads, d, pitch, drop, window)
        if smem <= FUSED_SMEM_MAX:
            return FwdPlan("fused", 1, heads, pitch, smem, 0)
    for hg in range(heads, 0, -1):
        if heads % hg == 0 and hg * d <= GROUP_COLS and _takes(c, heads, d, hg, False, cls):
            return FwdPlan("split", 2, hg, pitch, attention_smem(bf16, False, cross, c, inner, hg, d, pitch, drop,
                                                                 window), proj_smem(bf16, window))
    raise ValueError(f"the window-attention forward has no head grouping for {heads} heads "
                     f"of {d} dims")


# ---- the backward without dropout (csrc/window_attention_bwd.cu): its launch plan ----------
# Block geometry as the forward's; every product streams its weights (and on the recompute its
# A rows) through two-slot rings; a product takes at most 144 columns (7 x 36 tiles of 8 x 4 at
# 7x7 windows, 8 x 18 of 8 x 8 in the any-window build).
BWD_KERNELS = ("attention", "gx")  # the block kernel; the split route's g_x kernel
BWD_RING = 2
BWD_COLS = 144
BWD_FUSED_PITCHES = (4, 8)  # the fused route's q/k row pitches
# the largest q/k row pitch whose block runs csrc/window_bwd.cuh's core_bwd passes; above it (d =
# 48) the block runs core_bwd_tiled, with a head's P and g_S rows ([49][52] floats each; the
# any-window build's [64][65]) in shared memory
PASSES_PITCH_MAX = 24


def tiled_core_bytes(window: Tuple[int, int] = FWD_WINDOW) -> int:
    """Shared memory of core_bwd_tiled's P and g_S of one head (``tiled_core_bytes``)."""
    cls = window_class(window)
    return _align16(2 * cls.core_rows * cls.pp * 4)
_WG_SLAB, _WG_TARGET_BLOCKS, _WG_RECT = 64, 132 * 8, 16  # csrc/window_bwd.cuh's kWgSlab, kWgTargetBlocks, kWgRect


def _bwd_blocks_per_sm(pitch: int, smem: int) -> int:
    """Blocks an SM of the block kernel: its register bound (``min_blocks`` in the source, one
    from a row pitch of 24 on, the tiled core's pitch 48 too) and its shared memory."""
    return 1 if pitch >= 24 or smem > SMEM_TWO_PER_SM else 2


def bwd_smem(fused: bool, cross: bool, c: int, inner: int, hg: int, d: int, pitch: int,
             drop: bool = False, window: Tuple[int, int] = FWD_WINDOW) -> int:
    """Shared-memory bytes of one block of the backward's block kernel (``bwd_layout`` in the
    source) at ``window`` (T tokens, the class's A pitch): the A ring (x, and under cross the kv
    rows, 2 slots x 16 channels x 60 floats a part; 68 in the any-window build) and the weight
    ring (2 x 16 x the 3 hg*d q/k/v columns), over which the fused route keeps g_q | g_k | g_v
    resident ([3 heads*d rounded to 16][the A pitch]); q, k, v and g_o of hg heads [hg][T][pitch]
    (on the fused route at least the g_x product's ring, 2 x 16 x C, and a row buffer [T][C]); the
    rows pass's (1/sum, dot) per (head, row); the masked bias table; the row, region and token
    tables, the column offsets and biases; ``drop`` (the dropout form) adds the keep words of the
    block's heads ([hg][T][2] 32-bit words); above ``PASSES_PITCH_MAX`` the tiled core's P and g_S
    rows of one head come last."""
    cls = window_class(window)
    t = cls.t
    n = hg * d
    qkv = _align16(hg * t * pitch * 4)
    ring = _ring_a_bytes(False, 2 if cross else 1, BWD_RING, cls.pitch_f) + _b_bytes(False, 3 * n, BWD_RING)
    total = _align16(max(ring, _round_up(3 * inner, _KC) * cls.pitch_f * 4 if fused else 0))
    gx = _align16(_b_bytes(False, c, BWD_RING)) + _align16(t * c * 4) if fused else 0
    total += max(4 * qkv, gx)
    total += _align16(hg * t * 8) + _align16(t * t * 4) + _align16((3 * _ROWS_B + 2 * _MAX_COLS) * 4)
    total += keep_words_bytes(hg, window) if drop else 0
    return total + (tiled_core_bytes(window) if pitch > PASSES_PITCH_MAX else 0)


def keep_words_bytes(heads: int, window: Tuple[int, int] = FWD_WINDOW) -> int:
    """Shared memory of a window's attention keep words for ``heads`` heads (``csrc/
    hash_dropout.cuh::attention_keep_words``: two 32-bit words per (head, query row), keys 0-31
    and 32-63)."""
    return _align16(heads * window_class(window).t * 2 * 4)


def gx_width(c: int) -> int:
    """Output columns of a block of the split route's g_x kernel: C in the fewest groups of
    at most 144 columns, each a multiple of 4 (``gx_width`` in the source)."""
    groups = -(-c // BWD_COLS)
    return _round_up(-(-c // groups), 4)


def gx_smem(c: int, window: Tuple[int, int] = FWD_WINDOW) -> int:
    """Shared-memory bytes of one block of the g_x kernel (``gx_layout``): its A ring (2 x 16
    x the class's A pitch), weight ring (2 x 16 x width), a row buffer [T][width] and the row
    table."""
    cls = window_class(window)
    width = gx_width(c)
    return (_align16(_ring_a_bytes(False, 1, BWD_RING, cls.pitch_f) + _b_bytes(False, width, BWD_RING))
            + _align16(cls.t * width * 4) + _align16(_ROWS_B * 4))


def _wg_rect(ka: int, nb: int) -> bool:
    """Whether a weight-gradient job is cut into rectangles of 16 x 16 output tiles
    (``wg_rect`` in csrc/window_bwd.cuh)."""
    return (ka + 4) // 4 > _WG_RECT and (nb + 3) // 4 > _WG_RECT


def _wg_groups(ka: int, nb: int) -> int:
    """Blocks of one chunk of rows of a weight-gradient job (``wg_groups_of_tiles``)."""
    if _wg_rect(ka, nb):
        return -(-((ka + 4) // 4) // _WG_RECT) * -(-((nb + 3) // 4) // _WG_RECT)
    return -(-((ka + 4) // 4 * ((nb + 3) // 4)) // _THREADS)


def _wg_smem(ka: int, nb: int) -> int:
    """Shared memory of a weight-gradient block (``wg_smem`` in csrc/window_bwd.cuh)."""
    cols = 8 * _WG_RECT if _wg_rect(ka, nb) else _round_up(ka + 1, 4) + _round_up(nb, 4)
    return max(_WG_SLAB * cols, _THREADS * 16) * 4


@dataclass(frozen=True)
class BwdPlan:
    """How the backward runs at one shape, fp32 and bf16 alike (fp32 inside), with or without
    dropout (the same launches):
    ``route`` "fused" (a block per group of windows and stream with every head forms g_x too:
    the transposed weights, the block kernel, under cross the sum of g_x's two sides, the
    weight gradients, one reduction) or "split" (a block per group of windows, stream and group
    of ``heads_per_block`` heads, then the g_x kernel); ``smem``: (kernel, dynamic
    shared-memory bytes of one block) of the route's kernels (``BWD_KERNELS``);
    ``blocks_per_sm`` of the block kernel; ``window`` the call's."""

    route: str
    heads_per_block: int
    pitch: int
    smem: Tuple[Tuple[str, int], ...]
    blocks_per_sm: int
    window: Tuple[int, int] = FWD_WINDOW

    def launches(self, cross: bool) -> int:
        """Kernel launches of one call."""
        return 5 if self.route == "split" or cross else 4

    def blocks(self, s: int, b: int, h: int, w: int, heads: int, sms: int = DEFAULT_SMS) -> int:
        """Blocks per (stream, group of heads) of the block kernel: one wave of the card, at
        most one per window."""
        windows = b * (h // self.window[0]) * (w // self.window[1])
        groups = heads // self.heads_per_block
        return max(1, min(windows, sms * self.blocks_per_sm // (s * groups)))


@functools.lru_cache(maxsize=None)
def bwd_plan(c: int, heads: int, d: int, window: Tuple[int, int], cross: bool,
             bf16: bool, drop: bool = False) -> BwdPlan:
    """The launch plan of the backward (``drop``: its dropout form, whose block adds its heads'
    keep words to its shared memory), or ValueError where its kernels do
    not take the shape: windows of at most 64 tokens (``window_class``), d <= 48, C and heads*d
    multiples of 8, and the weight gradients' row slabs within a block's shared memory. Every
    head in one block ("fused") where d <= 8, 3 heads*d <= 144 and C <= 144 (one product's
    columns); else the largest group of heads with at most 48 columns per q/k/v part (a
    multiple of 8, as the forward's split route). ``bf16`` does not change the plan: the
    backward is fp32 inside."""
    del bf16  # one plan for both dtypes
    inner = heads * d
    window = tuple(window)
    window_class(window)
    pitch = next((p for p in FWD_PITCHES if d <= p), None)
    if pitch is None:
        raise ValueError(f"the window-attention backward takes at most {FWD_PITCHES[-1]} dims per "
                         f"head, got {d}")
    if c % 8 or inner % 8:
        raise ValueError(f"the window-attention backward takes C and heads*d multiples of 8, "
                         f"got C={c}, heads*d={inner}")
    if max(_wg_smem(c, inner), _wg_smem(inner, c), gx_smem(c, window)) > SMEM_LIMIT_BYTES:
        raise ValueError(f"the window-attention backward's weight gradients at C={c}, heads*d={inner} "
                         f"need more than the {SMEM_LIMIT_BYTES} bytes of shared memory a block has")
    if pitch in BWD_FUSED_PITCHES and 3 * inner <= BWD_COLS and c <= BWD_COLS:
        smem = bwd_smem(True, cross, c, inner, heads, d, pitch, drop, window)
        if smem <= SMEM_LIMIT_BYTES:
            return BwdPlan("fused", heads, pitch, (("attention", smem),), _bwd_blocks_per_sm(pitch, smem), window)
    for hg in range(heads, 0, -1):
        n = hg * d
        if heads % hg or n > GROUP_COLS or n % 8:
            continue
        smem = bwd_smem(False, cross, c, inner, hg, d, pitch, drop, window)
        if smem > SMEM_LIMIT_BYTES:
            break
        return BwdPlan("split", hg, pitch, (("attention", smem), ("gx", gx_smem(c, window))),
                       _bwd_blocks_per_sm(pitch, smem), window)
    raise ValueError(f"the window-attention backward has no head grouping for {heads} heads of {d} dims")


def _wgrad_chunks(m: int, jobs: int) -> int:
    """Chunks of the token rows of a weight-gradient launch (``wg_chunk_rows`` in
    ``csrc/window_bwd.cuh``: about eight blocks an SM of a 132-SM card, whole slabs of 64
    rows)."""
    slabs = -(-m // _WG_SLAB)
    chunks = max(1, min(slabs, _WG_TARGET_BLOCKS // jobs))
    return -(-m // _round_up(-(-m // chunks), _WG_SLAB))


def bwd_workspace_floats(s: int, b: int, h: int, w: int, c: int, heads: int, d: int, plan: BwdPlan,
                         blocks: int, cross: bool) -> int:
    """Floats of workspace of one call (``carve`` in the source, every piece rounded up to 32
    floats): wp^T and [wq | wk | wv]^T; AV, g_q, g_k and g_v of every token; on the fused route
    under cross g_x's q side and k/v side; the bias-table partials per block; the weight
    gradients' chunks (wq, wk, wv, wp with their biases; chunks for about eight blocks an SM
    counting every job's tile groups); the bias-table partials are T x T at the plan's window. The
    dropout form needs no more: its keep words live in each block's shared memory."""
    inner, m = heads * d, b * h * w
    sm = s * m
    pieces = [s * c * inner, s * 3 * inner * c] + [sm * inner] * 4
    pieces += [sm * c] * 2 if plan.route == "fused" and cross else []
    t = window_class(plan.window).t
    pieces.append(s * (heads // plan.heads_per_block) * blocks * t * t)
    jobs = 4 * s * max(_wg_groups(c, inner), _wg_groups(inner, c))
    pieces.append(s * _wgrad_chunks(m, jobs) * (3 * (c + 1) * inner + (inner + 1) * c))
    return sum(_round_up(p, 32) for p in pieces)


def _sm_count(device: torch.device) -> int:
    """The card's SM count (the backward kernels' blocks fill one wave of it)."""
    if device.type != "cuda":
        return DEFAULT_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dims(x, kw):
    """(S, B, H, W, C, heads, d, wh, ww) of a checked call."""
    return (*x.shape, kw["num_heads"], kw["dims_per_head"], *kw["window"])


def _drop_args(x, kw):
    """The kernels' dropout arguments of a call (None without dropout); kept alive by the
    caller until the launch returns."""
    rate = kw.get("attn_drop_rate", 0.0)
    if not rate:
        return None
    k3 = attention_keying(x.shape[2:4], kw["window"], kw["shift"], kw["num_heads"],
                          kw["dims_per_head"], x.device)
    return dl.drop_args(k3, (rate, 0.0, 0.0, 0.0), kw["drop_seed"])


def _launch_fwd(x, weights, kw) -> torch.Tensor:
    """The fp32 kernels for an fp32 x, their bf16 form for a bf16 x: never an upcast.
    Every call launches the forward of ``csrc/window_attention_fwd.cu`` (one or two
    launches, :func:`fwd_plan`), a dropout call its dropout form: the attention block's masks
    keyed as :func:`window_attention_plain`'s (the attention site of ``_drop_args``); AV
    through a window-major scratch in x's dtype on the split route."""
    global LAUNCHES, BF16_LAUNCHES, DROP_LAUNCHES, BF16_DROP_LAUNCHES
    s, b, h, w, c, heads, d, wh, ww = _dims(x, kw)
    bf16 = x.dtype == torch.bfloat16
    plan = fwd_plan(c, heads, d, (wh, ww), bool(kw["cross"]), bf16, bool(kw.get("attn_drop_rate")))
    drop = _drop_args(x, kw)
    lib = _fwd_library(window_class((wh, ww)).build)
    out = torch.empty_like(x)
    av = None if plan.route == "fused" else x.new_empty(s * b * h * w * heads * d)
    rc = _build.launch_on(
        x.device, lib.swin_k3_fwd,
        x.data_ptr(), *(a.data_ptr() for a in weights), out.data_ptr(),
        None if av is None else av.data_ptr(), dl.drop_pointer(drop), s, b, h, w, c, heads, d,
        plan.heads_per_block, int(plan.route == "fused"), int(kw["shift"]), int(kw["cross"]),
        int(bf16), float(d**-0.5), wh, ww,
    )
    _build.check_launch(lib, rc, "window attention")
    if drop is not None and bf16:
        BF16_DROP_LAUNCHES += 1
    elif drop is not None:
        DROP_LAUNCHES += 1
    elif bf16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def _launch_three(x, weights, kw) -> torch.Tensor:
    """``swin_window_attention_fwd`` of ``csrc/window_attention.cu``, the three launches, with
    and without dropout: the old forward, which the card checks time the redesigned one
    against. No call of the model runs it; counts nothing."""
    s, b, h, w, c, heads, d, wh, ww = _dims(x, kw)
    bf16 = x.dtype == torch.bfloat16
    drop = _drop_args(x, kw)
    lib = _library()
    out = torch.empty_like(x)
    # q (scaled), k, v (fp32) and AV (x's dtype: rounded in bf16) of every token, written
    # and read once by the kernels
    scratch = [x.new_empty(s, b, h, w, heads * d, dtype=torch.float32) for _ in range(3)]
    scratch.append(x.new_empty(s, b, h, w, heads * d))
    rc = _build.launch_on(
        x.device, lib.swin_window_attention_fwd,
        x.data_ptr(), *(a.data_ptr() for a in weights), out.data_ptr(),
        *(a.data_ptr() for a in scratch), dl.drop_pointer(drop), s, b, h, w, c, heads, d,
        wh, ww, int(kw["shift"]), int(kw["cross"]), int(bf16), float(d**-0.5),
    )
    _build.check_launch(lib, rc, "window attention")
    return out


def _launch_bwd(g, x, weights, kw) -> Tuple[torch.Tensor, ...]:
    """The fp32 backward kernels for an fp32 x, their bf16 form (fp32 inside, g_x in bf16,
    the weight gradients fp32) for a bf16 x: ``csrc/window_attention_bwd.cu``
    (:func:`bwd_plan`), in its dropout form for a dropout call; the workspace
    (:func:`bwd_workspace_floats`) fp32."""
    global BWD_LAUNCHES, BF16_BWD_LAUNCHES, DROP_BWD_LAUNCHES, BF16_DROP_BWD_LAUNCHES
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"the output gradient must be {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    s, b, h, w, c, heads, d, wh, ww = _dims(x, kw)
    cross = bool(kw["cross"])
    bf16 = x.dtype == torch.bfloat16
    drop = _drop_args(x, kw)
    plan = bwd_plan(c, heads, d, (wh, ww), cross, bf16, drop is not None)
    blocks = plan.blocks(s, b, h, w, heads, _sm_count(x.device))
    g = g.contiguous()
    lib = _bwd_library(window_class((wh, ww)).bwd_build(drop is not None))
    grads = [torch.empty_like(a) for a in (x, *weights)]
    floats = bwd_workspace_floats(s, b, h, w, c, heads, d, plan, blocks, cross)
    workspace = x.new_empty(floats, dtype=torch.float32)
    ins = (_P * (len(weights) + 2))(*(a.data_ptr() for a in (x, *weights, g)))
    outs = (_P * len(grads))(*(a.data_ptr() for a in grads))
    rc = _build.launch_on(
        x.device, lib.swin_k3_bwd,
        ins, outs, workspace.data_ptr(), floats, dl.drop_pointer(drop), s, b, h, w, c, heads, d,
        plan.heads_per_block, int(plan.route == "fused"), blocks, int(kw["shift"]), int(cross), int(bf16),
        float(d**-0.5), wh, ww,
    )
    _build.check_launch(lib, rc, "window attention backward")
    if drop is not None and bf16:
        BF16_DROP_BWD_LAUNCHES += 1
    elif drop is not None:
        DROP_BWD_LAUNCHES += 1
    elif bf16:
        BF16_BWD_LAUNCHES += 1
    else:
        BWD_LAUNCHES += 1
    return tuple(grads)


def _launch_bwd_three(g, x, weights, kw) -> Tuple[torch.Tensor, ...]:
    """``swin_window_attention_bwd`` of ``csrc/window_attention.cu``, the backward that
    recomputes with the three launches, with and without dropout: the old form, which the card
    checks time the redesigned backward against. No call of the model runs it; counts
    nothing."""
    dims = _dims(x, kw)
    g = g.contiguous()
    bf16 = x.dtype == torch.bfloat16
    drop = _drop_args(x, kw)
    lib = _library()
    grads = [torch.empty_like(a) for a in (x, *weights)]
    workspace = x.new_empty(lib.swin_window_attention_bwd_workspace(*dims, int(bf16), int(kw["cross"])),
                            dtype=torch.float32)
    ins = (_P * (len(weights) + 2))(*(a.data_ptr() for a in (x, *weights, g)))
    outs = (_P * len(grads))(*(a.data_ptr() for a in grads))
    rc = _build.launch_on(
        x.device, lib.swin_window_attention_bwd,
        ins, outs, workspace.data_ptr(), dl.drop_pointer(drop), *dims, int(kw["shift"]),
        int(kw["cross"]), int(bf16), float(kw["dims_per_head"]**-0.5),
    )
    _build.check_launch(lib, rc, "window attention backward")
    return tuple(grads)


class _WindowAttentionFunction(torch.autograd.Function):
    """The kernels' forward and backward on a card, the plain versions on the CPU (a bf16
    call, whose plain backward is not autograd of its plain forward); saves only x and the
    weights (and, in ``kw``, the dropout's rate and seed, so that the backward recomputes
    the forward's masks)."""

    @staticmethod
    def forward(ctx, kw, x, *weights):
        ctx.kw = kw
        ctx.save_for_backward(x, *weights)
        if x.device.type == "cpu":
            return window_attention_plain(x, *weights, **kw)
        return _launch_fwd(x, weights, kw)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        if x.device.type == "cpu":
            return (None, *window_attention_bwd_plain(g, x, *weights, **ctx.kw))
        return (None, *_launch_bwd(g, x, weights, ctx.kw))


def recorded(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``."""
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def window_attention(
    x, wq, bq, wk, bk, wv, bv, wp, bp, bias, *,
    window: Tuple[int, int], num_heads: int, dims_per_head: int, shift: bool, cross: bool,
    attn_drop_rate: float = 0.0, drop_seed: Optional[int] = None,
) -> torch.Tensor:
    """Window attention: the plain version on the CPU (with its plain backward when
    autograd records a bf16 call), the CUDA kernels on a card.

    Arguments as :func:`window_attention_plain`. On a CUDA tensor every argument must be
    a contiguous tensor on that device, x float32 or bfloat16 and every weight float32;
    anything else raises. A bf16 x runs the bf16 form of the kernels, dropout their dropout
    form. When autograd records the call, its backward is the backward kernel of x's dtype.
    """
    kw = dict(window=window, num_heads=num_heads, dims_per_head=dims_per_head,
              shift=shift, cross=cross, attn_drop_rate=float(attn_drop_rate),
              drop_seed=drop_seed)
    args = (x, wq, bq, wk, bk, wv, bv, wp, bp, bias)
    if x.device.type == "cpu":
        if x.dtype == torch.bfloat16 and recorded(*args):
            return _WindowAttentionFunction.apply(kw, *args)
        return window_attention_plain(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention runs on cpu or cuda tensors, not {x.device}")
    _check_geometry(x, window)
    s, _, _, _, c = x.shape
    wh, ww = window
    t = wh * ww
    inner = num_heads * dims_per_head
    expected = {
        "wq": (s, c, inner), "bq": (s, inner), "wk": (s, c, inner), "bk": (s, inner),
        "wv": (s, c, inner), "bv": (s, inner), "wp": (s, inner, c), "bp": (s, c),
        "bias": (s, t, t),
    }
    for name, a in zip(("x", *expected), args):
        dtypes = ACT_DTYPES if name == "x" else (torch.float32,)
        if a.device != x.device or a.dtype not in dtypes or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {' or '.join(map(str, dtypes))} "
                             f"tensor on {x.device}, got {a.dtype} on {a.device}, "
                             f"contiguous={a.is_contiguous()}")
        if name in expected and tuple(a.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {expected[name]}")
    if not 1 <= s <= MAX_STREAMS or (cross and s < 2):
        raise ValueError(f"the kernel takes 1 to {MAX_STREAMS} streams (2 for cross), got {s}")
    dl.check_seed((attn_drop_rate,), drop_seed)
    bf16 = x.dtype == torch.bfloat16
    fwd_plan(c, num_heads, dims_per_head, tuple(window), bool(cross), bf16, attn_drop_rate > 0)
    if recorded(*args):
        bwd_plan(c, num_heads, dims_per_head, tuple(window), bool(cross), bf16, attn_drop_rate > 0)
        return _WindowAttentionFunction.apply(kw, *args)
    return _launch_fwd(x, args[1:], kw)
