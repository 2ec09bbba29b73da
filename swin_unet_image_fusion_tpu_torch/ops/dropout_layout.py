"""Where each token's dropout masks come from: per-token keying tables for the three TPU
kernels' geometries, the masks of the plain versions, and the kernels' dropout arguments.

The JAX kernels key a mask element on a *unit* (the global index of the window, or of
the pair of windows, that the kernel's grid gives the element) and an intra-unit offset
made from in-unit positions. The port lays tokens out in other orders, so a table gives
every token of one image, in the order of the port's layout, its unit within the image
and its in-unit position; the global unit is ``(s * B + b) * units + unit``, with s the
stream of the output (the query's, under cross). The tables are built on the host once
per geometry from pure-Python copies of the JAX geometry and kept on each device by
:func:`~.window.device_constant`.

Keyings (``kind``), each the JAX kernel's:

- ``"k3"`` (``pallas_attention.py``): the wrap-rolled windows of the map, row-major
  (``win0``, l.282-284), the slot the in-window position t; attention offset
  ``h * tp^2 + t * tp + u`` with tp = T rounded up to 8 (56 for 7x7 windows);
- ``"k4"`` (``pallas_block.py``): as K3 for normal blocks; a shifted block keys on the
  zero-padded partition of ``shift_pad_geometry`` (l.105): the token's window and
  position in the map padded by (top, left). A wrap window then holds tokens of up to
  four padded windows, and exactly the pairs that the wrap mask leaves unmasked share
  one; masked pairs have p = 0, so their keep bit is never seen. Proj and MLP offsets
  ``t * cols + c``;
- ``"k1"`` (``pallas_pack.py``): the packed kernel's window *pairs* in its own
  geometry (``shift_pad_geometry`` l.1055: wrap or zero-padded by ``use_wrap``, window
  rows and columns rounded up to even counts, the dummy windows taking indices), unit
  ``row * np_w + col // 2`` and slot the lane ``(col % 2) * 64 + t``; attention offset
  ``(h * 64 + u) * 128 + lane_q`` (the transposed win64 score map, l.627) or
  ``lane_q * heads * 128 + h * 128 + lane_k`` (the head-batched map, l.636) when
  heads * d is not a multiple of 8; proj and MLP offsets ``c * 128 + lane``.

The composition (``models/layers.py``'s torch paths) keys on ``"k4"``: its shifted
windows hold the same tokens as the padded partition's on every unmasked pair, so a
block under the composition and under K4 draws the same masks from the same seed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import hash_dropout as hd
from .window import device_constant

TOK = 64  # the packed kernel's slots per window
LANES = 2 * TOK
T_PAD_MULTIPLE = 8
KINDS = ("k3", "k4", "k1")
# how the attention offset is formed: from window slots (K3/K4), the win64 score map of
# the packed kernel, or its head-batched score map
ATTN_SLOTS, ATTN_WIN64, ATTN_HEADBATCHED = 0, 1, 2


def padded_t(t: int) -> int:
    return (t + T_PAD_MULTIPLE - 1) // T_PAD_MULTIPLE * T_PAD_MULTIPLE


def shift_pad_geometry(hw: Tuple[int, int], window: Tuple[int, int], shift: bool,
                       even_cols: bool = False, even_rows: bool = False):
    """(top, left, H', W', nh, nw) of the zero-padded shifted partition (JAX
    ``pallas_attention.py::shift_pad_geometry``)."""
    h, w = hw
    wh, ww = window
    top = wh - wh // 2 if shift else 0
    left = ww - ww // 2 if shift else 0
    hp, wp = top + h, left + w
    hp += (-hp) % wh
    wp += (-wp) % ww
    nh, nw = hp // wh, wp // ww
    if even_cols and nw % 2:
        nw += 1
        wp += ww
    if even_rows and nh % 2:
        nh += 1
        hp += wh
    return top, left, hp, wp, nh, nw


@functools.lru_cache(maxsize=None)
def wrap_profitable(hw: Tuple[int, int], window: Tuple[int, int]) -> bool:
    """Whether the packed kernel's wrap-rolled shifted partition has strictly fewer
    even-rounded windows than the padded one (JAX ``pallas_pack.py::_wrap_profitable``)."""
    *_, nh_p, nw_p = shift_pad_geometry(hw, window, True, even_cols=True, even_rows=True)
    *_, nh_u, nw_u = shift_pad_geometry(hw, window, False, even_cols=True, even_rows=True)
    return nh_p * nw_p > nh_u * nw_u


def use_wrap(hw: Tuple[int, int], window: Tuple[int, int], shift: bool) -> bool:
    """Whether the packed kernel's shifted geometry is the wrap roll (JAX ``use_wrap``)."""
    return shift and wrap_profitable(hw, window)


def pack_geometry(hw: Tuple[int, int], window: Tuple[int, int], shift: bool):
    """(top, left, H', W', nh, nw) of the packed kernel (JAX ``pallas_pack.py::
    shift_pad_geometry``): under wrap the unshifted even-rounded grid with (top, left)
    as roll amounts."""
    if use_wrap(hw, window, shift):
        top, left, *_ = shift_pad_geometry(hw, window, True)
        return (top, left, *shift_pad_geometry(hw, window, False, even_cols=True,
                                               even_rows=True)[2:])
    return shift_pad_geometry(hw, window, shift, even_cols=True, even_rows=True)


def _wrap_pixels(hw, window, shift):
    """(nWin * T,) row and column of each token of the port's windows layout
    (``window_pack.pack_windows``: the map rolled by (top, left) under shift)."""
    h, w = hw
    wh, ww = window
    top, left = (wh - wh // 2, ww - ww // 2) if shift else (0, 0)
    nh, nw = h // wh, w // ww
    wr, wc, i, j = np.meshgrid(np.arange(nh), np.arange(nw), np.arange(wh), np.arange(ww),
                               indexing="ij")
    rows = (wr * wh + i - top) % h
    cols = (wc * ww + j - left) % w
    return rows.reshape(-1), cols.reshape(-1)


def _image_pixels(hw):
    h, w = hw
    rows, cols = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return rows.reshape(-1), cols.reshape(-1)


def _windows_key(prow, pcol, window, nw):
    """(window index, in-window slot) of positions in a window grid nw windows wide."""
    wh, ww = window
    return (prow // wh) * nw + pcol // ww, (prow % wh) * ww + pcol % ww


@functools.lru_cache(maxsize=None)
def keying_table(kind: str, hw: Tuple[int, int], window: Tuple[int, int],
                 shift: bool) -> Tuple[np.ndarray, int]:
    """(table, units) of one image: ``table`` (tokens, 2) int32 holds each token's unit
    within the image and its slot, tokens in image order (H, W) for ``"k3"`` and ``"k4"``
    and in the port's windows order (nWin, T) for ``"k1"``; ``units`` per image."""
    h, w = hw
    wh, ww = window
    if h % wh or w % ww:
        raise ValueError(f"map {h}x{w} is not a multiple of the window {window}")
    if kind == "k3":
        rows, cols = _image_pixels(hw)
        top, left = (wh - wh // 2, ww - ww // 2) if shift else (0, 0)
        unit, slot = _windows_key((rows + top) % h, (cols + left) % w, window, w // ww)
        units = (h // wh) * (w // ww)
    elif kind == "k4":
        rows, cols = _image_pixels(hw)
        top, left, _, _, nh, nw = shift_pad_geometry(hw, window, shift)
        unit, slot = _windows_key(rows + top, cols + left, window, nw)
        units = nh * nw
    elif kind == "k1":
        rows, cols = _wrap_pixels(hw, window, shift)
        top, left, _, _, nh, nw = pack_geometry(hw, window, shift)
        if use_wrap(hw, window, shift):
            prow, pcol = (rows + top) % h, (cols + left) % w
        else:
            prow, pcol = rows + top, cols + left
        win, t = _windows_key(prow, pcol, window, nw)
        wr, wc = win // nw, win % nw
        unit, slot = wr * (nw // 2) + wc // 2, (wc % 2) * TOK + t
        units = nh * (nw // 2)
    else:
        raise ValueError(f"unknown keying {kind!r}; expected one of {KINDS}")
    return np.stack([unit, slot], axis=-1).astype(np.int32), units


def attention_mode(kind: str, num_heads: int, dims_per_head: int) -> int:
    """How the attention offset is formed under ``kind`` (the packed kernel takes the
    win64 score map where heads * d is a multiple of 8, JAX ``pallas_pack.py:1406``)."""
    if kind != "k1":
        return ATTN_SLOTS
    return ATTN_WIN64 if (num_heads * dims_per_head) % 8 == 0 else ATTN_HEADBATCHED


class Keying(NamedTuple):
    """A block's keying on one device: the per-token table, its constants and the
    geometry it was made for."""

    table: torch.Tensor  # (tokens, 2) int32: unit within the image, slot
    units: int  # per image
    pairs: int  # 1: the packed kernel's window pairs (token offsets c * 128 + lane)
    attn_mode: int  # ATTN_SLOTS, ATTN_WIN64 or ATTN_HEADBATCHED
    t_pad: int  # K3/K4's padded window length
    geometry: tuple  # (kind, hw, window, shift)


def _table(kind, hw, window, shift) -> np.ndarray:
    return keying_table(kind, hw, window, shift)[0]


def keying(kind: str, hw, window, shift: bool, num_heads: int, dims_per_head: int,
           device) -> Keying:
    """The keying of a block whose kernel is ``kind``, its table on ``device``."""
    key = (kind, tuple(hw), tuple(window), bool(shift))
    return Keying(device_constant(_table, key, torch.device(device)), keying_table(*key)[1],
                  int(kind == "k1"), attention_mode(kind, num_heads, dims_per_head),
                  padded_t(window[0] * window[1]), key)


def _windows_order(kind: str, hw, window, shift: bool, roll) -> np.ndarray:
    """(nWin, T, 2) an image-order keying table of the map rolled by ``roll``, partitioned
    into windows row-major."""
    h, w = hw
    wh, ww = window
    table = np.roll(_table(kind, hw, window, shift).reshape(h, w, 2), roll, axis=(0, 1))
    table = table.reshape(h // wh, wh, w // ww, ww, 2).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(table.reshape(-1, wh * ww, 2))


def windows_table(k: Keying) -> torch.Tensor:
    """(nWin, T, 2) the keying's (unit, slot) of every token in the port's windows order
    (``window_pack.pack_windows``: under shift the map rolled by (top, left); the ``"k1"``
    table is in it already), kept on the table's device."""
    _, _, window, shift = k.geometry
    if k.pairs:
        return k.table.reshape(-1, window[0] * window[1], 2)
    roll = (window[0] - window[0] // 2, window[1] - window[1] // 2) if shift else (0, 0)
    return device_constant(_windows_order, (*k.geometry, roll), k.table.device)


def composition_windows(k: Keying) -> torch.Tensor:
    """(nWin, T, 2) the keying's (unit, slot) of every token in the composition's window
    order (``window.cyclic_shift`` rolls a shifted map by (-wh//2, -ww//2))."""
    _, _, window, shift = k.geometry
    roll = (-(window[0] // 2), -(window[1] // 2)) if shift else (0, 0)
    return device_constant(_windows_order, (*k.geometry, roll), k.table.device)


def _stream_batch(s: int, b: int, ndim: int, device) -> torch.Tensor:
    """(S, B, 1, ...) global image index s * B + b, ``ndim`` dimensions in all."""
    return torch.arange(s * b, device=device).reshape(s, b, *(1,) * (ndim - 2))


def token_keep(seed: int, site: int, rate: float, k: Keying, s: int, b: int, cols: int,
               table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, B, tokens, cols) keep mask of a token site (proj, MLP hidden, MLP out) over
    the tokens of ``table`` (default ``k.table``) in its order."""
    table = (k.table if table is None else table).reshape(-1, 2).long()
    unit = _stream_batch(s, b, 4, table.device) * k.units + table[:, 0].reshape(1, 1, -1, 1)
    slot = table[:, 1].reshape(1, 1, -1, 1)
    c = torch.arange(cols, device=table.device).reshape(1, 1, 1, -1)
    intra = c * LANES + slot if k.pairs else slot * cols + c
    return hd.keep_mask(seed, site, rate, unit, intra)


def attention_keep(seed: int, rate: float, k: Keying, windows: torch.Tensor, s: int, b: int,
                   num_heads: int) -> torch.Tensor:
    """(S, B, nWin, heads, T, T) keep mask of the attention weights (query t, key u) of
    windows whose tokens' (unit, slot) are ``windows`` (nWin, T, 2)."""
    win = windows.long()
    n_win, t = win.shape[:2]
    unit = (_stream_batch(s, b, 6, win.device) * k.units
            + win[..., 0].reshape(1, 1, n_win, 1, t, 1))
    sq = win[..., 1].reshape(1, 1, n_win, 1, t, 1)
    sk = win[..., 1].reshape(1, 1, n_win, 1, 1, t)
    h = torch.arange(num_heads, device=win.device).reshape(1, 1, 1, -1, 1, 1)
    if k.attn_mode == ATTN_SLOTS:
        intra = h * k.t_pad * k.t_pad + sq * k.t_pad + sk
    elif k.attn_mode == ATTN_WIN64:
        intra = (h * TOK + (sk & (TOK - 1))) * LANES + sq
    else:
        intra = sq * num_heads * LANES + h * LANES + sk
    return hd.keep_mask(seed, hd.SITE_ATTN, rate, unit, intra)


class DropArgs(ctypes.Structure):
    """The kernels' dropout arguments (``struct DropArgs`` of ``csrc/hash_dropout.cuh``);
    sites in the order attention, proj, MLP hidden, MLP out."""

    _fields_ = [("table", ctypes.c_void_p), ("units", ctypes.c_int), ("pairs", ctypes.c_int),
                ("attn_mode", ctypes.c_int), ("t_pad", ctypes.c_int),
                ("on", ctypes.c_int * 4), ("base", ctypes.c_uint32 * 4),
                ("threshold", ctypes.c_uint32 * 4), ("scale", ctypes.c_float * 4)]


def drop_args(k: Keying, rates, seed: int) -> Optional[DropArgs]:
    """The kernels' arguments for per-site ``rates`` (attention, proj, hidden, out) and
    one seed; a site of rate 0 is off; None when every site is."""
    if not any(rates):
        return None
    a = DropArgs()
    a.table = k.table.data_ptr()
    a.units, a.pairs, a.attn_mode, a.t_pad = k.units, k.pairs, k.attn_mode, k.t_pad
    for i, (site, rate) in enumerate(zip(hd.SITES, rates)):
        a.on[i] = int(rate > 0.0)
        if rate > 0.0:
            a.base[i] = hd.site_base(seed, site)
            a.threshold[i] = hd.keep_threshold(rate)
            a.scale[i] = hd.keep_scale(rate)
    return a


def drop_pointer(args: Optional[DropArgs]):
    """``args`` as the kernels' ``const DropArgs*`` (NULL for None)."""
    return None if args is None else ctypes.pointer(args)


def check_seed(rates, seed) -> None:
    """A nonzero rate needs an integer seed in [0, 2^24) (the JAX kernels take it as an
    exact float32); rates lie in [0, 1)."""
    if any(not 0.0 <= r < 1.0 for r in rates):
        raise ValueError(f"dropout rates must lie in [0, 1), got {tuple(rates)}")
    if any(rates) and (seed is None or not 0 <= int(seed) < 1 << 24):
        raise ValueError(f"a nonzero dropout rate needs a seed in [0, 2^24), got {seed!r}")
