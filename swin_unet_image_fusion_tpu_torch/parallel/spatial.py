"""Exact single-image fusion with the map's rows split into bands over ranks (port of the
JAX ``parallel/spatial.py``).

Where ``tiled.py`` approximates the tile borders, this path is exact: every rank holds a
band of rows of each map, and the forward exchanges exactly the rows that an operation
reads across a band's edge. JAX lets GSPMD derive those exchanges from H-sharded arrays;
here they are explicit point-to-point sends (``torch.distributed.batch_isend_irecv``)
between the ranks whose bands meet (:func:`exchange_rows`):

- the encoder's bottom reflect pads and 2x2 merges and the decoder's crops and 2x2
  anti-merges: each rank fetches the input rows its output band reads, the reflection at
  the map's bottom included (``ops/shape_plan.py``, ``ops/patch.py``);
- a stage's four blocks: the band is whole window rows of the stage's map, packed by
  window; K1 (or the composition) runs on the band's windows with its wrap seams
  (``ops/window_pack_spmd.py::fused_block_band``), and every change of geometry is K2 with
  a one-window-row halo from the neighbouring band, a ring around the whole map, as the
  roll wraps (``repartition_halo``); the stage ends back in the normal geometry;
- the head's two reflect 3x3 convolutions: a one-row halo on each side, reflected at the
  map's top and bottom.

Which stages run banded: a stage whose attention map has at least as many window rows as
there are ranks; each rank takes ``rows // ranks`` window rows and the last the remainder.
Any other stage runs replicated, JAX's "replicated fallback: still exact, just unscaled":
every rank gathers the stage's map, runs the one-device stage and keeps it. Which stages
ran which way is recorded in :attr:`SpatialFuser.partitions`, as JAX's ``LAST_PARTITIONS``
records its lowerings.

Routes: ``"torch"`` (the composition, on the band's windows) and ``"cuda_pack"`` (K1's band
form and K2's halo form; a stage ``pack_beneficial`` rejects, C = 384 in the default model,
runs the composition, as the JAX model routes it to jnp). ``"cuda"`` and ``"cuda_block"``
are rejected with JAX's reason: their kernels take the whole image.

Equal to the one-device forward within fp32 reduction noise. The input and output bands
split H as evenly as the stage bands do (the last rank holds the remainder), so no padding
of H is needed where it does not divide the ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import ModelConfig
from ..infer import load_model
from ..models.unet import SwinFusionUNet, fp32_accumulation
from ..ops import window_pack_spmd as spmd
from ..ops.patch import pad_reflect, reflect_index
from ..ops.shape_plan import make_plan
from ..ops.window import device_constant
from ..ops.window_pack import pack_windows, unpack_windows
from ..utils.device import require_device

_SUPPORTED_IMPLS = ("torch", "cuda_pack")

Ranges = Tuple[Tuple[int, int], ...]


def split_rows(n: int, ranks: int) -> Ranges:
    """[lo, hi) of each rank when ``n`` rows split into ``n // ranks`` each, the last rank
    holding the remainder."""
    base = n // ranks
    return tuple((r * base, n if r == ranks - 1 else (r + 1) * base) for r in range(ranks))


@dataclass
class Band:
    """Rows [lo, lo + x.shape[dim]) of a map of ``h`` rows that this rank holds, and the
    rows each rank owns (disjoint, covering the map, each inside what its rank holds):
    the rows a rank sends when another asks for them."""

    x: torch.Tensor
    lo: int
    own: Ranges
    h: int
    dim: int = 2


class _Ranks:
    """The process group of a spatial forward; one rank without a group.

    Over more than one rank every rank enters a barrier here, so that a collective has run
    on the group before its first point-to-point batch: NCCL wants every rank of the group
    in the group's first ``batch_isend_irecv``, and an exchange between some of the ranks
    (:func:`exchange_rows`) leaves the others out."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if self.size > 1:
            dist.barrier(group=group)

    def peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r) if self.group is not None else r


def exchange_rows(band: Band, want: Sequence[Tuple[int, int]], ranks: _Ranks) -> torch.Tensor:
    """Rows [want[rank]) of the map on this rank: each owner sends every rank the rows of
    its own that the rank wants (every rank computes every rank's wants from the shapes, so
    nothing but rows crosses), in one ``batch_isend_irecv``."""
    me = ranks.rank
    lo, hi = want[me]
    ops, pieces = [], []
    for q in range(ranks.size):
        a, b = max(band.own[me][0], want[q][0]), min(band.own[me][1], want[q][1])
        if q != me and a < b:
            send = band.x.narrow(band.dim, a - band.lo, b - a).contiguous()
            ops.append(dist.P2POp(dist.isend, send, ranks.peer(q), ranks.group))
    for q in range(ranks.size):
        a, b = max(band.own[q][0], lo), min(band.own[q][1], hi)
        if a >= b:
            continue
        if q == me:
            pieces.append((a, band.x.narrow(band.dim, a - band.lo, b - a)))
        else:
            shape = list(band.x.shape)
            shape[band.dim] = b - a
            buf = band.x.new_empty(shape)
            ops.append(dist.P2POp(dist.irecv, buf, ranks.peer(q), ranks.group))
            pieces.append((a, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    pieces.sort(key=lambda p: p[0])
    got = sum(p.shape[band.dim] for _, p in pieces)
    if got != hi - lo:
        raise RuntimeError(f"rows [{lo}, {hi}) of a {band.h}-row map: the owners hold {got} of them")
    if len(pieces) == 1:
        return pieces[0][1]
    return torch.cat([p for _, p in pieces], dim=band.dim)


def _rows_read(index: torch.Tensor) -> Tuple[int, int]:
    return int(index.min()), int(index.max()) + 1


def gather_index(band: Band, index_of, targets: Sequence[Tuple[int, int]], ranks: _Ranks):
    """Rows ``index_of(lo, hi)`` (a 1-D index into ``band``'s map) for this rank's target
    [lo, hi): fetch the range of rows every rank's target reads, then pick locally."""
    reads = [_rows_read(index_of(lo, hi)) if hi > lo else (0, 0) for lo, hi in targets]
    fetched = exchange_rows(band, reads, ranks)
    lo, hi = targets[ranks.rank]
    index = index_of(lo, hi) - reads[ranks.rank][0]
    return fetched.index_select(band.dim, index.to(fetched.device))


class SpatialFuser:
    """Fuse one (possibly huge) pair with its rows split over the ranks of ``group``.

    ``model`` is a :class:`~.models.unet.SwinFusionUNet` or its ``ModelConfig`` (a model's
    own weights are not read), ``variables`` flax variables, flat or nested; the model runs
    on ``device`` (the card unless the caller passes ``device="cpu"``), one device a rank.
    ``group=None`` is one rank (JAX's one-device mesh); over a group, every rank constructs
    the fuser (the constructor enters a barrier) and calls :meth:`fuse` with
    the whole pair and gets its band of the fused map back, rows :meth:`row_range`;
    :meth:`gather_rows` assembles the whole map on every rank.
    """

    def __init__(self, model: Union[SwinFusionUNet, ModelConfig], variables: Mapping, group=None,
                 *, device: torch.device | str = "cuda"):
        self.device = require_device(device, "SpatialFuser")
        self.model = load_model(model, variables, self.device)
        impl = self.model.cfg.resolved_attention_impl(self.device)
        if impl not in _SUPPORTED_IMPLS:
            raise ValueError(
                f"SpatialFuser does not support attention_impl={impl!r}: the image-layout "
                "kernels take the whole image, so splitting H would gather the activations "
                "around every kernel call. Use attention_impl='cuda_pack' (the banded packed "
                "kernels) or 'torch' (see parallel/spatial.py)")
        self.ranks = _Ranks(group)
        self.partitions: List[Tuple[str, int, str]] = []

    def row_range(self, h: int) -> Tuple[int, int]:
        """[lo, hi) of the rows of an ``h``-row pair that this rank's band holds."""
        return split_rows(h, self.ranks.size)[self.ranks.rank]

    def gather_rows(self, band: torch.Tensor, h: int) -> torch.Tensor:
        """The whole (B, h, W, C) map on every rank from each rank's band (B, rows, W, C)."""
        own = split_rows(h, self.ranks.size)
        lo = own[self.ranks.rank][0]
        return exchange_rows(Band(band, lo, own, h, dim=1), [(0, h)] * self.ranks.size, self.ranks)

    @torch.inference_mode()
    def fuse(self, ir, vis_y) -> torch.Tensor:
        """ir, vis_y: the whole (B, H, W, 1) pair in [0, 1], on the host or a device; returns
        this rank's band (B, hi - lo, W, 1) of the clamped fused map on the device."""
        ir = torch.as_tensor(ir)
        vis_y = torch.as_tensor(vis_y)
        h = ir.shape[1]
        if h < self.ranks.size:
            raise ValueError(f"a pair of {h} rows cannot be split over {self.ranks.size} ranks")
        lo, hi = self.row_range(h)
        own = split_rows(h, self.ranks.size)
        x = torch.stack([ir[:, lo:hi], vis_y[:, lo:hi]], dim=0).to(self.device, torch.float32)
        with fp32_accumulation():
            out = self._forward(Band(x.to(self.model.compute_dtype), lo, own, h), ir.shape[2])
        return torch.clamp(out, 0.0, 1.0)

    # ------------------------------------------------------------------ forward
    def _stage_rows(self, att_h: int, window_h: int) -> Tuple[bool, Ranges]:
        """Whether a stage of ``att_h`` rows runs banded, and each rank's rows in it."""
        n = att_h // window_h
        if n >= self.ranks.size:
            return True, tuple((a * window_h, b * window_h) for a, b in split_rows(n, self.ranks.size))
        return False, ((0, att_h),) * self.ranks.size

    def _forward(self, band: Band, w: int) -> torch.Tensor:
        model, ranks = self.model, self.ranks
        cfg = model.cfg
        n = cfg.num_stages
        h = band.h
        plan = make_plan(h, w, n, cfg.merging_size, cfg.window_size)
        impls = model.stage_impls(h, w, self.device)
        wh = cfg.window_size[0]
        ph, _ = cfg.merging_size
        self.partitions = []
        layout = [self._stage_rows(p.att_hw[0], wh) for p in plan]
        skips = []
        for k in range(n):
            p = plan[k]
            banded, targets = layout[k]
            m = p.merged_hw[0]
            win_index = reflect_index(m, 0, p.pad_win[0])
            in_index = reflect_index(band.h, 0, p.pad_merge[0])
            # merged rows [mlo, mhi) that the stage rows read, then the input rows they read
            merged = [_rows_read(win_index[a:b]) for a, b in targets]
            x = gather_index(band, lambda a, b: in_index[ph * a:ph * b], merged, ranks)
            x = pad_reflect(x, 3, 0, p.pad_merge[1])
            x = getattr(model, f"enc{k}_merge")(x)
            x = pad_reflect(x, 3, 0, p.pad_win[1])
            mlo = merged[ranks.rank][0]
            lo, hi = targets[ranks.rank]
            x = x.index_select(2, (win_index[lo:hi] - mlo).to(x.device))
            own = targets if banded else split_rows(p.att_hw[0], ranks.size)
            band = Band(self._blocks(f"enc{k}_blocks", x, p.att_hw, lo, banded, impls[k], ("enc", k)),
                        lo, own, p.att_hw[0])
            if k < n - 1:
                skips.append(band)

        for j in range(n):
            k = n - 1 - j
            p = plan[k]
            banded, targets = layout[k]
            if j > 0:
                skip = skips.pop()
                x = exchange_rows(band, targets, ranks)
                band = Band(x + skip.x, skip.lo, skip.own, skip.h)
            lo = band.lo
            x = self._blocks(f"dec{k}_blocks", band.x, p.att_hw, lo, banded, impls[k], ("dec", k))
            # crop the window pad, anti-merge, crop the merge pad: rows scale by the merge
            m, hin = p.merged_hw[0], p.in_hw[0]
            hi = min(lo + x.shape[2], m)
            x = x[:, :, :hi - lo, :x.shape[3] - p.pad_win[1]]
            x = getattr(model, f"dec{k}_unmerge")(x)
            lo, hi = ph * lo, min(ph * hi, hin)
            x = x[:, :, :hi - lo, :x.shape[3] - p.pad_merge[1]]
            own = tuple((min(ph * a, hin), min(ph * min(b, m), hin)) for a, b in band.own)
            band = Band(x, lo, own, hin)
        return self._head(band)

    def _blocks(self, name: str, x: torch.Tensor, att_hw, lo: int, banded: bool, impl: str,
                where: Tuple[str, int]) -> torch.Tensor:
        pair = getattr(self.model, name)
        route = "cuda_pack" if impl == "cuda_pack" else "torch"
        self.partitions.append((*where, "banded" if banded else "replicated"))
        if not banded:
            return pair(x, route)
        return self._band_pair(pair, x, tuple(att_hw), lo, route)

    def _band_pair(self, pair, x: torch.Tensor, hw, lo: int, route: str) -> torch.Tensor:
        """The four blocks of ``pair`` on a band (S, B, rows, W, C) starting at row ``lo`` of
        an ``hw`` map: packed by window in the normal geometry, K2's halo form between the
        geometries, back to the normal geometry at the end."""
        window = pair.self_normal.attn.window_size
        row0 = lo // window[0]
        bhw = (x.shape[2], x.shape[3])
        xw = pack_windows(x, window, shift=False)
        was_shift = False
        for name, shift, _ in pair.ORDER:
            if shift != was_shift:
                xw = self._repartition(xw, hw, window, was_shift, shift, route)
                was_shift = shift
            block = getattr(pair, name)
            if route == "cuda_pack":
                attn = block.attn
                xw = spmd.fused_block_band(
                    xw.contiguous(), *block.fused_weights(), hw=hw, row0=row0, window=window,
                    num_heads=attn.num_heads, dims_per_head=attn.dims_per_head, shift=shift,
                    cross=attn.cross, activation=block.activation)
            else:
                mask = None
                if shift:
                    rows = bhw[0] // window[0]
                    mask = device_constant(spmd.band_mask, (tuple(hw), tuple(window), row0, rows),
                                           xw.device)
                xw = block.windows(xw, mask)
        if was_shift:
            xw = self._repartition(xw, hw, window, True, False, route)
        return unpack_windows(xw, bhw, window, shift=False)

    def _repartition(self, xw: torch.Tensor, hw, window, from_shift: bool, to_shift: bool,
                     route: str) -> torch.Tensor:
        """K2's halo form on this rank's band (its plain version on the composition's
        route), the neighbour's window row fetched around the ring of bands."""
        ranks = self.ranks
        nw = hw[1] // window[1]
        n_rows = hw[0] // window[0]
        _, targets = self._stage_rows(hw[0], window[0])
        rows = [(a // window[0], b // window[0]) for a, b in targets]
        side = spmd.halo_side(from_shift, to_shift)
        want = [((a - 1) % n_rows, (a - 1) % n_rows + 1) if side < 0 else (b % n_rows, b % n_rows + 1)
                for a, b in rows]
        s, b = xw.shape[:2]
        grid = xw.reshape(s, b, -1, nw, *xw.shape[3:])
        halo = exchange_rows(Band(grid, rows[ranks.rank][0], tuple(rows), n_rows), want, ranks)
        halo = halo.reshape(s, b, nw, *xw.shape[3:])
        repartition = spmd.repartition_halo if route == "cuda_pack" else spmd.repartition_halo_plain
        return repartition(xw.contiguous(), halo.contiguous(), hw, window, from_shift, to_shift)

    def _head(self, band: Band) -> torch.Tensor:
        """FinalHead in eval on the output bands: each reflect conv reads one row of halo
        on each side, reflected at the map's top and bottom."""
        ranks, head = self.ranks, self.model.final_head
        h = band.h
        out_rows = split_rows(h, ranks.size)
        index = reflect_index(h, head.pad, head.pad)
        lo = out_rows[ranks.rank][0]

        def padded(b: Band) -> torch.Tensor:  # rows [lo - pad, hi + pad), reflected
            return gather_index(b, lambda a, c: index[a:c + 2 * head.pad], out_rows, ranks)

        x = band.x
        xy = torch.cat([x[0], x[1]], dim=-1)  # (B, rows, W, 2)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = padded(Band(xy.permute(0, 3, 1, 2), band.lo, band.own, h))
            y = self._conv(y, head.conv1, xy.dtype)
            y = head.act(head.bn(y, False))
            y = padded(Band(y, lo, out_rows, h))
            y = self._conv(y, head.conv2, xy.dtype)
        return y.permute(0, 2, 3, 1).float()

    def _conv(self, x: torch.Tensor, conv, dtype) -> torch.Tensor:
        """``FinalHead._reflect_conv`` on rows already padded: the W pad, then the conv."""
        pad = self.model.final_head.pad
        x = pad_reflect(x, 3, pad, pad).to(dtype)
        return F.conv2d(x, conv.weight.to(dtype)) + conv.bias.to(dtype)[:, None, None]
