"""Banded forms of K1 and K2 for a map split into row bands over ranks (port of the JAX
``ops/pallas_pack_spmd.py``): their wrappers, plain versions and launch counters.

``parallel/spatial.py`` splits a stage's map into bands of whole window rows, one a rank.
The JAX package teaches GSPMD to run its packed kernels per row shard; here each rank
calls the kernels on its band:

- **K1 band** (:func:`fused_block_band`): window attention never crosses a window, so the
  fused block runs on a band's windows unchanged, with one exception, the wrap seam of the
  shifted partition. Its row term is "rolled row < top" (``csrc/window_fwd.cuh``,
  ``window_rows``), which only the band holding the map's first shifted window row meets;
  in the windows layout ``top`` enters nothing else. So the band form is a launch argument
  of ``csrc/fused_block_fwd.cu``: ``shift = 2`` (top 0, the column seam kept) for every
  other band. The plain version slices the map's ``wrap_region_mask`` to the band's
  windows, as JAX's ``mask_rows`` does.
- **K2 halo** (:func:`repartition_halo`): normal -> shifted needs the previous band's last
  window row, shifted -> normal the next band's first (the roll wraps around the whole
  map, so the neighbours form a ring; ``parallel/spatial.py`` exchanges the row). The
  result is the band's rows of the re-partition of the ``[halo; band]`` (or ``[band;
  halo]``) map of n + 1 window rows: the kept rows read the halo linearly, so the map's own
  wrap touches only the halo row's output, which is dropped (the trick of
  ``pallas_pack_spmd.py:329-367``). The plain version builds that map and drops the row;
  on a card ``csrc/repartition.cu``'s halo form is one launch over the band's n rows of
  output, reading each source token from the halo or from the band in place.

Both are forward-only, as in JAX (the spatial fuser serves), and take fp32 or bf16 tokens
(K1 computes in fp32 inside, bf16 only its I/O; K2 is a permutation). On the CPU each runs
its plain version; on a card the kernel, counted in ``BAND_LAUNCHES`` / ``HALO_LAUNCHES``
(``BF16_*`` for bf16 tokens); the plain versions never count.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import _build
from . import fused_block as fb
from . import window_pack as wp
from .window import device_constant
from .window_attention import ACT_DTYPES, recorded, wrap_region_mask

BAND_LAUNCHES = 0
BF16_BAND_LAUNCHES = 0
HALO_LAUNCHES = 0
BF16_HALO_LAUNCHES = 0


@functools.lru_cache(maxsize=1024)
def _band_shape(shape: Tuple[int, ...], hw: Tuple[int, int], window: Tuple[int, int]) -> Tuple[int, int]:
    nw = hw[1] // window[1]
    if len(shape) != 5 or shape[3] != window[0] * window[1] or shape[2] % nw:
        raise ValueError(f"a band of a map {hw[1]} wide is (S, B, k * {nw}, "
                         f"{window[0] * window[1]}, C) windows, got {tuple(shape)}")
    return shape[2] // nw * window[0], hw[1]


def band_hw(xw: torch.Tensor, hw: Tuple[int, int], window: Tuple[int, int]) -> Tuple[int, int]:
    """The (rows, W) of the band whose windows ``xw`` (S, B, nWin, T, C) holds, for a map
    ``hw`` W wide; raises unless it holds whole window rows of it (cached by shape)."""
    return _band_shape(xw.shape, tuple(hw), tuple(window))


def band_mask(hw: Tuple[int, int], window: Tuple[int, int], row0: int, rows: int) -> np.ndarray:
    """The (nWin, T, T) wrap-seam mask of window rows [row0, row0 + rows) of an ``hw`` map:
    its windows' slice of the map's ``wrap_region_mask``."""
    nw = hw[1] // window[1]
    return wrap_region_mask(tuple(hw), tuple(window))[row0 * nw:(row0 + rows) * nw]


def fused_block_band_plain(xw, *weights, hw: Tuple[int, int], row0: int, window: Tuple[int, int],
                           num_heads: int, dims_per_head: int, shift: bool, cross: bool,
                           activation: str = "elu") -> torch.Tensor:
    """Plain version of the K1 band form: the block on the windows of window rows [row0,
    row0 + n) of an ``hw`` map, ``xw`` (S, B, n * nw, T, C) fp32 or bf16 in the geometry of
    ``shift``; the weights as ``fused_block_plain``'s."""
    fb.activation_code(activation)
    bhw = band_hw(xw, hw, window)
    mask = None
    if shift:
        args = (tuple(hw), tuple(window), row0, bhw[0] // window[0])
        mask = device_constant(band_mask, args, xw.device)
    out = fb._block_windows_plain(
        xw.float(), *weights, hw=bhw, window=window, num_heads=num_heads,
        dims_per_head=dims_per_head, shift=shift, cross=cross, rnd=lambda t: t, mask=mask,
        activation=activation)
    return out.to(xw.dtype)


def fused_block_band(xw, *weights, hw: Tuple[int, int], row0: int, window: Tuple[int, int],
                     num_heads: int, dims_per_head: int, shift: bool, cross: bool,
                     activation: str = "elu") -> torch.Tensor:
    """K1 on a band of window rows [row0, row0 + n) of an ``hw`` map: the plain version on
    the CPU, ``csrc/fused_block_fwd.cu``'s windows layout on a card, launched on the band's
    (n * wh, W) map with the row seam off unless the band holds window row 0. Arguments as
    :func:`fused_block_band_plain`; on a card x contiguous fp32 or bf16 and the weights
    contiguous fp32 on its device. Forward-only: a call autograd records raises."""
    global BAND_LAUNCHES, BF16_BAND_LAUNCHES
    kw = dict(window=window, num_heads=num_heads, dims_per_head=dims_per_head, shift=shift,
              cross=cross, activation=activation)
    if xw.device.type == "cpu":
        return fused_block_band_plain(xw, *weights, hw=hw, row0=row0, **kw)
    if xw.device.type != "cuda":
        raise ValueError(f"fused_block_band runs on cpu or cuda tensors, not {xw.device}")
    if recorded(xw, *weights):
        raise ValueError("the K1 band form is forward-only; call it without autograd recording")
    if xw.dtype not in ACT_DTYPES or not xw.is_contiguous():
        raise ValueError(f"xw must be a contiguous float32 or bfloat16 tensor, got {xw.dtype}")
    for a in weights:
        if a.device != xw.device or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"the weights must be contiguous float32 tensors on {xw.device}")
    fb.activation_code(activation)
    bhw = band_hw(xw, hw, window)
    code = 0 if not shift else 1 if row0 == 0 else 2
    out = fb.run_fwd(xw, weights, dict(kw, layout="windows", hw=bhw), code)
    if xw.dtype == torch.bfloat16:
        BF16_BAND_LAUNCHES += 1
    else:
        BAND_LAUNCHES += 1
    return out


def halo_side(from_shift: bool, to_shift: bool) -> int:
    """Which neighbour's window row a band's re-partition reads: -1 the previous band's
    last (normal -> shifted), +1 the next band's first (shifted -> normal)."""
    if from_shift == to_shift:
        raise ValueError("a re-partition goes between the normal and the shifted geometry")
    return -1 if to_shift else 1


def _check_halo(xw: torch.Tensor, halo: torch.Tensor, nw: int) -> None:
    if halo.shape != (*xw.shape[:2], nw, *xw.shape[3:]):
        raise ValueError(f"the halo is one window row {(*xw.shape[:2], nw, *xw.shape[3:])}, "
                         f"got {tuple(halo.shape)}")


def _extended(xw: torch.Tensor, halo: torch.Tensor, side: int, nw: int) -> torch.Tensor:
    _check_halo(xw, halo, nw)
    return torch.cat([halo, xw] if side < 0 else [xw, halo], dim=2).contiguous()


def _drop_halo(out: torch.Tensor, nw: int, side: int) -> torch.Tensor:
    return (out[:, :, nw:] if side < 0 else out[:, :, :-nw]).contiguous()


def repartition_halo_plain(xw: torch.Tensor, halo: torch.Tensor, hw: Tuple[int, int],
                           window: Tuple[int, int], from_shift: bool, to_shift: bool) -> torch.Tensor:
    """Plain version of the K2 halo form: the band's windows ``xw`` (S, B, n * nw, T, C) of
    a map ``hw[1]`` wide moved from the ``from_shift`` to the ``to_shift`` geometry, with
    ``halo`` (S, B, nw, T, C) the neighbour's window row (:func:`halo_side`)."""
    side = halo_side(from_shift, to_shift)
    rows, w = band_hw(xw, hw, window)
    ext = _extended(xw, halo, side, w // window[1])
    out = wp.repartition_windows_plain(ext, (rows + window[0], w), window, from_shift, to_shift)
    return _drop_halo(out, w // window[1], side)


def repartition_halo(xw: torch.Tensor, halo: torch.Tensor, hw: Tuple[int, int],
                     window: Tuple[int, int], from_shift: bool, to_shift: bool) -> torch.Tensor:
    """K2 on a band with its halo row: the plain version on the CPU, one launch of
    ``csrc/repartition.cu``'s halo form on a card (the band and the halo contiguous fp32 or
    bf16 tokens on one device). Arguments as :func:`repartition_halo_plain`. Forward-only."""
    global HALO_LAUNCHES, BF16_HALO_LAUNCHES
    device = xw.device
    if device.type == "cpu":
        return repartition_halo_plain(xw, halo, hw, window, from_shift, to_shift)
    if device.type != "cuda":
        raise ValueError(f"repartition_halo runs on cpu or cuda tensors, not {device}")
    if recorded(xw, halo):
        raise ValueError("the K2 halo form is forward-only; call it without autograd recording")
    if xw.dtype not in ACT_DTYPES or halo.dtype != xw.dtype:
        raise ValueError(f"the band and its halo must be float32 or bfloat16 alike, got "
                         f"{xw.dtype} and {halo.dtype}")
    if halo.device != device or not (xw.is_contiguous() and halo.is_contiguous()):
        raise ValueError(f"the band and its halo must be contiguous on one device, got {device} "
                         f"and {halo.device}")
    side = halo_side(from_shift, to_shift)
    rows, w = band_hw(xw, hw, window)
    _check_halo(xw, halo, w // window[1])
    s, b, _, _, c = xw.shape
    out = torch.empty_like(xw)
    lib = wp._library()
    rc = _build.launch_on(device, lib.swin_repartition_halo_fwd, xw.data_ptr(), halo.data_ptr(),
                          out.data_ptr(), s * b, rows, w, c * xw.element_size(), window[0], window[1],
                          int(from_shift), int(to_shift), side)
    _build.check_launch(lib, rc, "repartition halo")
    if xw.dtype == torch.bfloat16:
        BF16_HALO_LAUNCHES += 1
    else:
        HALO_LAUNCHES += 1
    return out
