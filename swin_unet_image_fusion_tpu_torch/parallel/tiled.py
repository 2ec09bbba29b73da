"""High-resolution (2K/4K) tiled fusion on one device or over ranks (port of the JAX
``parallel/tiled.py``).

The image pair is cut into overlapping tiles, the tiles are fused in batches, and the
overlaps are blended back with a separable linear (Bartlett) ramp so that tile seams
cancel. Window attention is local (7x7 windows; global context comes from shifted windows
and the 5x downsampling), so a tile with enough overlap reproduces the full-image output
away from a thin border that the ramp down-weights; every batch runs the model at one
tile size, in bounded memory.

The whole pipeline stays on the device: the pair crosses to it once, the tiles are
gathered there by index arithmetic, fused in chunks of ``max_batch`` tiles and blended
there, and the fused image crosses back once. uint8 input and output (``return_uint8``)
move a quarter of the bytes: the 8-bit images the reference's test script reads and
writes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..config import ModelConfig
from ..infer import fused_y, load_model
from ..models.unet import SwinFusionUNet
from ..utils.device import require_device


def plan_tiles(length: int, tile: int, overlap: int) -> List[int]:
    """Start offsets covering [0, length) with ``tile``-sized windows and at least
    ``overlap`` overlap between neighbours; the last tile is right-aligned."""
    if length <= tile:
        return [0]
    stride = tile - overlap
    n = math.ceil((length - tile) / stride) + 1
    # even spacing: actual overlap >= requested, no bunching at the right edge
    return [int(round(i * (length - tile) / (n - 1))) for i in range(n)]


def _ramp_weights(tile: int, starts: List[int], length: int) -> np.ndarray:
    """Per-tile 1-D blend weights: triangular ramp, constant where no neighbour."""
    w = np.ones((len(starts), tile), np.float32)
    for i, s in enumerate(starts):
        if i > 0:  # left overlap with previous tile
            ov = starts[i - 1] + tile - s
            if ov > 0:
                w[i, :ov] *= np.linspace(0.0, 1.0, ov + 2, dtype=np.float32)[1:-1]
        if i < len(starts) - 1:  # right overlap with next tile
            ov = s + tile - starts[i + 1]
            if ov > 0:
                w[i, -ov:] *= np.linspace(1.0, 0.0, ov + 2, dtype=np.float32)[1:-1]
    return w


class _Plan:
    """The tiling of one (h, w): tile starts and size, and on the device the gather
    indices, each tile's 2-D blend weight and the inverse of their sum per pixel."""

    def __init__(self, h: int, w: int, tile: int, overlap: int, device: torch.device):
        self.th, self.tw = min(tile, h), min(tile, w)
        self.ys = plan_tiles(h, self.th, overlap)
        self.xs = plan_tiles(w, self.tw, overlap)
        self.n_tiles = len(self.ys) * len(self.xs)
        rows = np.asarray(self.ys)[:, None] + np.arange(self.th)  # (ny, th)
        cols = np.asarray(self.xs)[:, None] + np.arange(self.tw)  # (nx, tw)
        self.rows = torch.as_tensor(rows[:, None, :, None], device=device)
        self.cols = torch.as_tensor(cols[None, :, None, :], device=device)
        wy = _ramp_weights(self.th, self.ys, h)
        wx = _ramp_weights(self.tw, self.xs, w)
        weights = np.stack([wy[i][:, None] * wx[j][None, :]
                            for i in range(len(self.ys)) for j in range(len(self.xs))])
        # the per-pixel normaliser is data-independent: a host constant
        norm = np.zeros((h, w), np.float32)
        for k, (y0, x0) in enumerate(self.starts()):
            norm[y0:y0 + self.th, x0:x0 + self.tw] += weights[k]
        self.weights = torch.as_tensor(weights[..., None], device=device)
        self.inv_norm = torch.as_tensor((1.0 / np.maximum(norm, 1e-8)).astype(np.float32)[..., None],
                                        device=device)

    def starts(self) -> List[Tuple[int, int]]:
        """(y0, x0) of every tile, row-major: the order of the tile batch."""
        return [(y0, x0) for y0 in self.ys for x0 in self.xs]


class TiledFuser:
    """Fuse arbitrarily large pairs by batching fixed-size tiles on one device or over ranks.

    ``model`` is a :class:`~.models.unet.SwinFusionUNet` or its ``ModelConfig``;
    ``variables`` are flax variables, flat or nested, as ``Fuser`` takes them
    (:func:`~.infer.load_model`: a given model's config is taken, its weights left as they
    are). The model runs on ``device`` (the card unless the caller passes ``device="cpu"``).
    Every pair goes through the same plan: one no larger than a tile is one tile of weight 1.

    ``max_batch > 0`` fuses the tiles in chunks of that many, one forward each. The JAX
    fuser pads the last chunk by repeating the last tile, so that XLA reuses one compiled
    executable for every resolution; PyTorch compiles nothing per shape, so here the last
    chunk runs at its true size: the same result for less work (at 4K with chunks of 32,
    45 tiles fused instead of 64). ``return_uint8=True`` rounds the fused image to uint8 on
    the device before the copy back.

    Over ranks (the JAX ``mesh``): with a process ``group`` (``torch.distributed``, one
    process a device) every rank is handed the whole pair, fuses its share of every chunk
    (the chunk cut into equal shares, the last tile repeated to fill the last one), and the
    fused tiles are all-gathered and cropped, so that every rank blends and returns the
    whole image. ``max_batch`` must then divide by the group's size, as the JAX fuser
    asserts. ``group=None`` is one device, as JAX's ``mesh=None``.
    """

    def __init__(self, model: Union[SwinFusionUNet, ModelConfig], variables: Mapping,
                 tile: int = 512, overlap: int = 64, max_batch: int = 0,
                 return_uint8: bool = False, *, device: torch.device | str = "cuda",
                 group=None):
        self.device = require_device(device, "TiledFuser")
        self.model = load_model(model, variables, self.device)
        self.tile = tile
        self.overlap = overlap
        self.group = group
        self.world = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        if max_batch % self.world:
            raise ValueError(f"max_batch={max_batch} does not divide by the {self.world} ranks")
        self.max_batch = max_batch
        self.return_uint8 = return_uint8
        self._plans: Dict[Tuple[int, int], _Plan] = {}

    def plan(self, h: int, w: int) -> _Plan:
        if (h, w) not in self._plans:
            self._plans[(h, w)] = _Plan(h, w, self.tile, self.overlap, self.device)
        return self._plans[(h, w)]

    def _to_device(self, img) -> torch.Tensor:
        """An (H, W, 1) array or tensor on the device, as float32 in [0, 1]: uint8 is
        divided by 255 there (a division, as the host converts)."""
        img = torch.as_tensor(img, device=self.device)
        if img.dtype == torch.uint8:
            return img.float() / 255.0
        return img.float()

    def tiles(self, img: torch.Tensor, plan: _Plan) -> torch.Tensor:
        """(H, W, 1) on the device -> (n_tiles, th, tw, 1), row-major over tiles."""
        return img[plan.rows, plan.cols].reshape(plan.n_tiles, plan.th, plan.tw, img.shape[-1])

    def fuse_tiles(self, tiles_ir: torch.Tensor, tiles_vis: torch.Tensor) -> torch.Tensor:
        """The clamped fused Y of every tile, ``max_batch`` tiles a forward (all at once
        with ``max_batch=0``)."""
        n = tiles_ir.shape[0]
        chunk = self.max_batch or n
        return torch.cat([self._fuse_chunk(tiles_ir[c0:c0 + chunk], tiles_vis[c0:c0 + chunk])
                          for c0 in range(0, n, chunk)])

    def _fuse_chunk(self, ir: torch.Tensor, vis: torch.Tensor) -> torch.Tensor:
        """One chunk's fused tiles: on one device one forward; over ranks this rank's share
        (the chunk padded with its last tile to equal shares), all-gathered and cropped."""
        if self.group is None:
            return fused_y(self.model, ir, vis)
        n = ir.shape[0]
        share = -(-n // self.world)
        pick = torch.arange(self.rank * share, (self.rank + 1) * share, device=ir.device).clamp_(max=n - 1)
        mine = fused_y(self.model, ir[pick], vis[pick]).contiguous()
        shares = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(shares, mine, group=self.group)
        return torch.cat(shares)[:n]

    def blend(self, fused: torch.Tensor, plan: _Plan, h: int, w: int) -> torch.Tensor:
        """The weighted tiles added row-major into the (h, w, 1) image, one slice-add per
        tile (no atomics: the same bits on every run), times the inverse weight sum."""
        weighted = fused.float() * plan.weights
        acc = torch.zeros((h, w, 1), dtype=torch.float32, device=self.device)
        for k, (y0, x0) in enumerate(plan.starts()):
            acc[y0:y0 + plan.th, x0:x0 + plan.tw] += weighted[k]
        out = acc * plan.inv_norm
        if self.return_uint8:
            return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
        return out

    def fuse(self, ir: np.ndarray, vis_y: np.ndarray) -> np.ndarray:
        """ir / vis_y: (H, W, 1), float [0, 1] or uint8 [0, 255]. Returns the fused
        (H, W, 1) float32 (or uint8 with ``return_uint8``)."""
        return self.fuse_on_device(ir, vis_y).cpu().numpy()

    @torch.inference_mode()
    def fuse_on_device(self, ir, vis_y) -> torch.Tensor:
        """:meth:`fuse`, returning the tensor on the device, so that a caller can time the
        device's work apart from the transfers; inputs may already be on the device."""
        h, w, _ = ir.shape
        plan = self.plan(h, w)
        fused = self.fuse_tiles(self.tiles(self._to_device(ir), plan),
                                self.tiles(self._to_device(vis_y), plan))
        return self.blend(fused, plan, h, w)
