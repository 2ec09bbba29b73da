"""Counter-based dropout masks (PyTorch port of the JAX ``ops/hash_dropout.py``).

A keep decision is a pure function of ``(seed, site, global position)``: a murmur3
finalizer of 32-bit integers, two-level so that nothing wraps into a collision. A
per-unit hash of the *global unit index* (a window, or a pair of windows for the packed
kernel), then a finalize of ``unit hash + intra-unit offset``; the low 23 bits decide.
The same masks are therefore made by the TPU kernels, by the CUDA kernels of
``csrc/hash_dropout.cuh`` and by the plain versions here, however the work is tiled.

The JAX module computes on wrapping int32 with logical shifts. PyTorch's ``>>`` on int32
is arithmetic and its overflow is no contract, so every function here computes on int64
holding the unsigned 32-bit value (products split so that none exceeds 2^48) and
returns int32 re-signed as JAX's two's complement gives it.

Sites (the reference's four, ``a001_WindowAttention.py:58-66``,
``a003_AutoPathMLP.py:26-31``): the softmax attention weights, the projection's output,
the MLP hidden after its activation and the MLP output.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# murmur3 finalizer constants and the golden-ratio salt step (JAX hash_dropout.py:36-38)
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
_MASK32 = 0xFFFFFFFF

KEEP_BITS = 23

SITE_ATTN = 1
SITE_PROJ = 2
SITE_MLP_HIDDEN = 3
SITE_MLP_OUT = 4
SITES = (SITE_ATTN, SITE_PROJ, SITE_MLP_HIDDEN, SITE_MLP_OUT)


def _u32(h) -> torch.Tensor:
    """An integer tensor (or Python int / numpy array) as int64 holding its low 32 bits."""
    return torch.as_tensor(np.asarray(h) if not isinstance(h, torch.Tensor) else h).long() & _MASK32


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32): h times each 16-bit half of c stays below
    2^48, and only the low 16 bits of the high half's product reach the result."""
    return (h * (c & 0xFFFF) + (((h * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _signed(h: torch.Tensor) -> torch.Tensor:
    return (h - ((h >> 31) << 32)).to(torch.int32)


def _fmix_int(h: int) -> int:
    """fmix32 of one unsigned 32-bit Python int."""
    h ^= h >> 16
    h = (h * _C1) & _MASK32
    h ^= h >> 13
    h = (h * _C2) & _MASK32
    return h ^ (h >> 16)


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 holding unsigned 32-bit values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def finalize(h) -> torch.Tensor:
    """murmur3 fmix32 of int32 values, as the JAX function computes it on wrapping int32."""
    return _signed(_fmix(_u32(h)))


def keep_threshold(rate: float) -> int:
    """Static int threshold: low 23 hash bits < threshold  <=>  keep (prob 1-rate)."""
    t = int(round((1.0 - float(rate)) * (1 << KEEP_BITS)))
    return max(0, min(t, 1 << KEEP_BITS))


def keep_scale(rate: float) -> float:
    """The inverted-dropout scale 1/(1-rate) rounded to float32, as JAX's ``apply_mask``."""
    return float(np.float32(1.0 / (1.0 - float(rate))))


def site_base(seed: int, site: int) -> int:
    """``finalize(seed + salt(site))`` as an unsigned 32-bit int: the per-(seed, site) term
    of :func:`pair_hash`, computed once on the host for the kernels."""
    salt = (site * _GOLD) & _MASK32
    return _fmix_int((int(seed) + salt) & _MASK32)


def _pair_hash_u32(seed: int, site: int, unit) -> torch.Tensor:
    return _fmix(_u32(unit) ^ site_base(seed, site))


def pair_hash(seed: int, site: int, pair_idx) -> torch.Tensor:
    """Per-unit hash of GLOBAL unit indices ``pair_idx`` (int32 values)."""
    return _signed(_pair_hash_u32(seed, site, pair_idx))


def _keep_u32(ph: torch.Tensor, intra, rate: float) -> torch.Tensor:
    h = _fmix((ph + _u32(intra)) & _MASK32)
    return (h & ((1 << KEEP_BITS) - 1)) < keep_threshold(rate)


def keep_from_hash(ph, intra, rate: float) -> torch.Tensor:
    """Bool keep mask from broadcast(unit hash + intra-unit offset)."""
    return _keep_u32(_u32(ph), intra, rate)


def apply_mask(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout: x/(1-rate) where kept, else 0 (x times the float32 scale)."""
    return torch.where(keep, x * keep_scale(rate), torch.zeros((), dtype=x.dtype, device=x.device))


def intra_offsets(shape: Tuple[int, int], row_stride: int) -> torch.Tensor:
    """(rows, cols) int32 offsets ``r * row_stride + c``."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int32)[:, None]
    return r * row_stride + torch.arange(cols, dtype=torch.int32)[None]


def tile_keep_mask(seed: int, site: int, pair0: int, tile: int, inner_shape: Tuple[int, int],
                   rate: float, intra_base: int = 0) -> torch.Tensor:
    """(tile, rows, cols) keep mask of ``tile`` consecutive units from global unit
    ``pair0``, intra offsets ``r * cols + c + intra_base`` (JAX ``tile_keep_mask``)."""
    rows, cols = inner_shape
    pidx = pair0 + torch.arange(tile, dtype=torch.long)[:, None, None]
    intra = intra_offsets((rows, cols), cols).long()[None] + intra_base
    return _keep_u32(_pair_hash_u32(seed, site, pidx), intra, rate)


def keep_mask(seed: int, site: int, rate: float, unit: torch.Tensor,
              intra: torch.Tensor) -> torch.Tensor:
    """Keep mask of elements whose global unit index is ``unit`` and whose intra-unit
    offset is ``intra`` (int tensors that broadcast against each other): what every
    kernel decides for the element at that position."""
    return _keep_u32(_pair_hash_u32(seed, site, unit), intra, rate)
