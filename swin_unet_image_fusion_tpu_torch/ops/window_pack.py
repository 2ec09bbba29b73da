"""Window-packed tokens for a whole stage, and the re-partition between the normal and
the shifted window grid (K2): the CUDA kernel's wrapper, its plain version and its
launch counter.

Counterpart of the layout half of the JAX ``ops/pallas_pack.py``. The TPU packs two
64-token windows per 128-lane register in C-major strips, only because of the TPU's
(8, 128) tile padding; here a stage's tokens are simply grouped by window:

- :func:`pack_windows` turns ``(S, B, H, W, C)`` into ``(S, B, nWin, T, C)``, T = wh*ww
  unpadded, windows row-major. The shifted geometry is the wrap-roll the window-attention
  kernel uses: the map rolled by ``(top, left) = (wh - wh//2, ww - ww//2)``, the same
  window count, the seams masked by region inside the block. The TPU's padded shifted
  partition (``shift_pad_geometry``) is mathematically identical and is not carried over.
- :func:`unpack_windows` is its inverse.
- :func:`repartition_windows` (K2) moves packed tokens from one geometry to the other. It
  is a pure permutation of tokens, so the kernel (``csrc/repartition.cu``) is bit-exact
  in any dtype; it moves fp32 or bf16 tokens.
  Its backward (K2 bwd) is the transpose of the permutation, i.e. its inverse: the same
  kernel launched from ``to_shift`` back to ``from_shift``, through
  ``_RepartitionFunction`` when autograd records the call on a card.

:func:`pack_beneficial` is the JAX package's default rule for which stages the
``pallas_pack`` configuration packs (``models/layers.py::pack_beneficial``); the port's
``cuda_pack`` packs the same stages.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build
from .window import window_partition, window_unpartition
from .window_attention import ACT_DTYPES, wrap_offsets

# Calls that launched the kernel forward on fp32 and on bf16 tokens, and backward calls
# that launched it on an fp32 and on a bf16 gradient, since the last reset; the plain
# version never counts.
LAUNCHES = 0
BF16_LAUNCHES = 0
BWD_LAUNCHES = 0
BF16_BWD_LAUNCHES = 0


def pack_beneficial(c: int, w: int) -> bool:
    """Whether the packed path runs a stage of C channels on maps W wide (the JAX
    package's default rule): C in [128, 256) always; C < 128 where W >= 28 or where
    NHWC's 128-lane padding of C would waste more than C-major's padding of W."""
    if c >= 128:
        return c < 256
    nhwc_waste = math.ceil(c / 128) * 128 / c
    nchw_waste = math.ceil(w / 128) * 128 / w
    return nhwc_waste > nchw_waste or w >= 28


def _check_map(hw: Tuple[int, int], window: Tuple[int, int]) -> None:
    if hw[0] % window[0] or hw[1] % window[1]:
        raise ValueError(f"map {hw[0]}x{hw[1]} is not a multiple of the window {window}")


def pack_windows(x: torch.Tensor, window: Tuple[int, int], shift: bool) -> torch.Tensor:
    """(S, B, H, W, C) -> (S, B, nWin, T, C) in the normal or the shifted geometry."""
    _check_map(tuple(x.shape[2:4]), window)
    if shift:
        x = torch.roll(x, shifts=wrap_offsets(window), dims=(2, 3))
    s, b = x.shape[:2]
    return window_partition(x, window).reshape(s, b, -1, window[0] * window[1], x.shape[-1])


def unpack_windows(xw: torch.Tensor, hw: Tuple[int, int], window: Tuple[int, int],
                   shift: bool) -> torch.Tensor:
    """Inverse of :func:`pack_windows`: (S, B, nWin, T, C) -> (S, B, H, W, C)."""
    _check_map(hw, window)
    s, b, n_win, t, c = xw.shape
    x = window_unpartition(xw.reshape(s, b * n_win, t, c), window, hw)
    if shift:
        top, left = wrap_offsets(window)
        x = torch.roll(x, shifts=(-top, -left), dims=(2, 3))
    return x


@functools.lru_cache(maxsize=1024)
def _check_shape(shape: Tuple[int, ...], hw: Tuple[int, int], window: Tuple[int, int]) -> None:
    """Raises unless ``shape`` is that of the windows of an ``hw`` map (cached: the wrapper
    checks every call, and its host time is most of a launch's)."""
    _check_map(hw, window)
    n_win = (hw[0] // window[0]) * (hw[1] // window[1])
    if len(shape) != 5 or shape[2:4] != (n_win, window[0] * window[1]):
        raise ValueError(f"windows of a {hw[0]}x{hw[1]} map are (S, B, {n_win}, "
                         f"{window[0] * window[1]}, C), got {tuple(shape)}")


def _check_windows(xw: torch.Tensor, hw: Tuple[int, int], window: Tuple[int, int]) -> None:
    _check_shape(xw.shape, tuple(hw), tuple(window))


def repartition_windows_plain(xw: torch.Tensor, hw: Tuple[int, int], window: Tuple[int, int],
                              from_shift: bool, to_shift: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: unpack from one geometry, pack into the other."""
    _check_windows(xw, hw, window)
    return pack_windows(unpack_windows(xw, hw, window, from_shift), window, to_shift)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("repartition")
    lib.swin_repartition_fwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.swin_repartition_fwd.restype = ctypes.c_int
    lib.swin_repartition_halo_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.swin_repartition_halo_fwd.restype = ctypes.c_int
    return lib


def _launch(xw: torch.Tensor, hw, window, from_shift: bool, to_shift: bool) -> torch.Tensor:
    s, b, _, _, c = xw.shape
    out = torch.empty_like(xw)
    lib = _library()
    rc = _build.launch_on(xw.device, lib.swin_repartition_fwd, xw.data_ptr(), out.data_ptr(), s * b,
                          hw[0], hw[1], c * xw.element_size(), window[0], window[1], int(from_shift),
                          int(to_shift))
    _build.check_launch(lib, rc, "repartition")
    return out


def _count_forward(xw: torch.Tensor) -> None:
    global LAUNCHES, BF16_LAUNCHES
    if xw.dtype == torch.bfloat16:
        BF16_LAUNCHES += 1
    else:
        LAUNCHES += 1


def repartition_windows_bwd_plain(g: torch.Tensor, hw: Tuple[int, int], window: Tuple[int, int],
                                  from_shift: bool, to_shift: bool) -> torch.Tensor:
    """Plain backward of the re-partition: the inverse permutation of ``g``."""
    return repartition_windows_plain(g, hw, window, to_shift, from_shift)


class _RepartitionFunction(torch.autograd.Function):
    """The kernel forward; its backward is the kernel from ``to_shift`` to ``from_shift``."""

    @staticmethod
    def forward(ctx, xw, hw, window, from_shift, to_shift):
        ctx.geometry = (hw, window, from_shift, to_shift)
        out = _launch(xw, hw, window, from_shift, to_shift)
        _count_forward(xw)
        return out

    @staticmethod
    def backward(ctx, g):
        global BWD_LAUNCHES, BF16_BWD_LAUNCHES
        hw, window, from_shift, to_shift = ctx.geometry
        out = _launch(g.contiguous(), hw, window, to_shift, from_shift)
        if g.dtype == torch.bfloat16:
            BF16_BWD_LAUNCHES += 1
        else:
            BWD_LAUNCHES += 1
        return out, None, None, None, None


def repartition_windows(xw: torch.Tensor, hw: Tuple[int, int], window: Tuple[int, int],
                        from_shift: bool, to_shift: bool) -> torch.Tensor:
    """Re-partition (S, B, nWin, T, C) tokens of an ``hw`` map from the ``from_shift`` to
    the ``to_shift`` geometry: the plain version on the CPU, the CUDA kernel on a card.

    On a CUDA tensor ``xw`` must be contiguous float32 or bfloat16; anything else raises.
    When autograd records the call, its backward is the kernel's inverse permutation.
    """
    kind = xw.device.type
    if kind == "cpu":
        return repartition_windows_plain(xw, hw, window, from_shift, to_shift)
    if kind != "cuda":
        raise ValueError(f"repartition_windows runs on cpu or cuda tensors, not {xw.device}")
    _check_windows(xw, hw, window)
    if xw.dtype not in ACT_DTYPES or not xw.is_contiguous():
        raise ValueError(f"xw must be a contiguous float32 or bfloat16 tensor, got {xw.dtype}, "
                         f"contiguous={xw.is_contiguous()}")
    if torch.is_grad_enabled() and xw.requires_grad:
        return _RepartitionFunction.apply(xw, tuple(hw), tuple(window), from_shift, to_shift)
    out = _launch(xw, hw, window, from_shift, to_shift)
    _count_forward(xw)
    return out
