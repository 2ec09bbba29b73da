"""The port's banded spatial fusion (``parallel/spatial.py``, ``ops/window_pack_spmd.py``)
and ``TiledFuser`` over ranks, against the JAX package and the one-device port.

- ``SpatialFuser`` on the tiny model over 2 and 4 gloo processes on the CPU
  (``torch_dist_worker.py``), under ``"torch"`` and ``"cuda_pack"`` (the kernels' plain
  versions here), against JAX's one-device ``jnp`` forward with the same weights and pair:
  (112, 84) at atol 1e-5, (100, 90) and (224, 224) at 5e-5, as
  ``tests/test_spatial_sharding.py`` holds JAX's; each rank's band and the whole map from
  ``gather_rows``. Every stage runs banded at (112, 84) and (224, 224); at (56, 56) over 4
  ranks stage 1 (2 window rows) runs replicated, and the result is the same.
  ``"cuda"`` and ``"cuda_block"`` are rejected.
- The plain K1 band form and K2 halo form equal the matching windows of the whole map's
  plain call bit for bit (fp32 and bf16, every band of 2 and 3 bands); the halo form's kept
  windows never read across the extended map's wrap; on a card the band form hands the
  kernel shift code 2 below the first window row (a fake library reads it).
- ``TiledFuser`` over 2 processes equals one device at atol 1e-6, with and without chunks,
  and JAX's ``TiledFuser`` over a 2-device data mesh with the same weights, pair, tile,
  overlap and chunks at ``tests/test_torch_tiled.py``'s tolerance (atol 2e-4, rtol 1e-3).

About 70 s in one process (JAX's forwards ~25 s, each group of processes ~10 s).
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import unflatten_dict

from swin_unet_image_fusion_tpu.config import ModelConfig as JaxModelConfig
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.parallel import mesh as jmesh
from swin_unet_image_fusion_tpu.parallel import tiled as jtiled
from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.infer import fused_y, load_model
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd
from swin_unet_image_fusion_tpu_torch.parallel.spatial import SpatialFuser, split_rows
from swin_unet_image_fusion_tpu_torch.parallel.tiled import TiledFuser

import torch_dist_worker as worker
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = worker.TINY
WINDOW = (7, 7)
SEEDS = dict(data_seed=41, weights_seed=42)
SHAPES = ((112, 84), (100, 90), (224, 224), (56, 56))
ATOL = {(112, 84): 1e-5, (100, 90): 5e-5, (224, 224): 5e-5, (56, 56): 5e-5}
IMPLS = ("torch", "cuda_pack")


@functools.lru_cache(maxsize=None)
def _jax_forward(hw):
    """JAX's one-device clamped ``jnp`` forward of the seeded pair."""
    flat = random_variables(ModelConfig(**TINY), SEEDS["weights_seed"])
    model = JaxUNet(JaxModelConfig(**TINY, attention_impl="jnp"))
    ir, vis = worker.global_batch(1, hw, SEEDS["data_seed"])
    out = jax.jit(model.apply)(unflatten_dict(flat, sep="/"), jnp.asarray(ir), jnp.asarray(vis))
    return np.asarray(jnp.clip(out, 0.0, 1.0))


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    """Every rank's outputs of each route and shape, over 2 and over 4 processes."""
    args = dict(SEEDS, impls=list(IMPLS), shapes=[list(s) for s in SHAPES])
    return {world: worker.run("spatial", world, args, str(tmp_path_factory.mktemp(f"w{world}")))
            for world in (2, 4)}


@pytest.mark.parametrize("hw", SHAPES[:3], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("world", [2, 4])
def test_spatial_fuser_matches_jax_one_device(spatial_runs, world, impl, hw):
    ref = _jax_forward(hw)
    key = f"{impl}/{hw[0]}x{hw[1]}"
    for rank, out in enumerate(spatial_runs[world]):
        lo, hi = out[f"{key}/rows"]
        assert (lo, hi) == split_rows(hw[0], world)[rank]
        np.testing.assert_allclose(out[f"{key}/band"], ref[:, lo:hi], atol=ATOL[hw], rtol=0)
        np.testing.assert_allclose(out[f"{key}/whole"], ref, atol=ATOL[hw], rtol=0)


@pytest.mark.parametrize("hw", [(112, 84), (224, 224)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("world", [2, 4])
def test_every_stage_runs_banded(spatial_runs, world, hw):
    for impl in IMPLS:
        banded = spatial_runs[world][0][f"{impl}/{hw[0]}x{hw[1]}/banded"]
        assert banded.tolist() == [True] * 4, (impl, banded)


def test_a_stage_of_fewer_window_rows_than_ranks_runs_replicated(spatial_runs):
    """(56, 56) over 4 ranks: stage 1's 14-row map has 2 window rows, so it runs replicated
    (encoder and decoder), stage 0's 4 rows banded, and the result is the same."""
    ref = _jax_forward((56, 56))
    for impl in IMPLS:
        assert spatial_runs[4][0][f"{impl}/56x56/banded"].tolist() == [True, False, False, True]
        np.testing.assert_allclose(spatial_runs[4][0][f"{impl}/56x56/whole"], ref, atol=5e-5, rtol=0)


@pytest.mark.parametrize("impl", ["cuda", "cuda_block"])
def test_image_layout_kernels_are_rejected(impl):
    cfg = ModelConfig(**TINY, attention_impl=impl)
    with pytest.raises(ValueError, match="does not support attention_impl"):
        SpatialFuser(cfg, random_variables(cfg, 0), device="cpu")


@pytest.mark.parametrize("impl", IMPLS)
def test_one_rank_equals_the_one_device_forward(impl):
    cfg = ModelConfig(**TINY, attention_impl=impl)
    flat = random_variables(cfg, 3)
    ir, vis = worker.global_batch(1, (112, 84), 4)
    ref = fused_y(load_model(cfg, flat, torch.device("cpu")), torch.from_numpy(ir), torch.from_numpy(vis))
    fuser = SpatialFuser(cfg, flat, device="cpu")
    out = fuser.fuse(ir, vis)
    assert torch.equal(out, ref.detach())
    assert torch.equal(fuser.gather_rows(out, 112), out)


def _block_weights(rng, c, heads, d, hidden):
    inner = heads * d
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2)
    return [1 + g(2, c), g(2, c), g(2, c, inner), g(2, inner), g(2, c, inner), g(2, inner),
            g(2, c, inner), g(2, inner), g(2, inner, c), g(2, c), g(2, 49, 49), 1 + g(2, c), g(2, c),
            g(2, c, hidden), g(2, hidden), g(2, hidden, c), g(2, c)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shift,cross", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("bands", [2, 3])
def test_k1_band_form_equals_the_whole_map_rows(dtype, shift, cross, bands):
    rng = np.random.default_rng(5)
    hw, c, heads, d = (42, 28), 8, 2, 4
    weights = _block_weights(rng, c, heads, d, 4 * c)
    x = torch.from_numpy(rng.standard_normal((2, 2, 24, 49, c)).astype(np.float32)).to(dtype)
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
    whole = tfb.fused_block_plain(x, *weights, layout="windows", hw=hw, **kw)
    nw = hw[1] // WINDOW[1]
    for lo, hi in split_rows(hw[0] // WINDOW[0], bands):
        band = spmd.fused_block_band(x[:, :, lo * nw:hi * nw].contiguous(), *weights, hw=hw, row0=lo, **kw)
        assert band.dtype == dtype
        assert torch.equal(band, whole[:, :, lo * nw:hi * nw]), (lo, hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("from_shift", [False, True], ids=["to_shifted", "to_normal"])
@pytest.mark.parametrize("bands", [1, 2, 3])
def test_k2_halo_form_equals_the_whole_map_rows(dtype, from_shift, bands):
    rng = np.random.default_rng(6)
    hw = (42, 28)
    nh, nw = hw[0] // WINDOW[0], hw[1] // WINDOW[1]
    x = torch.from_numpy(rng.standard_normal((2, 1, nh * nw, 49, 3)).astype(np.float32)).to(dtype)
    whole = twp.repartition_windows_plain(x, hw, WINDOW, from_shift, not from_shift)
    side = spmd.halo_side(from_shift, not from_shift)
    for lo, hi in split_rows(nh, bands):
        row = (lo - 1) % nh if side < 0 else hi % nh  # the ring neighbour's window row
        halo = x[:, :, row * nw:(row + 1) * nw]
        band = spmd.repartition_halo(x[:, :, lo * nw:hi * nw], halo, hw, WINDOW, from_shift, not from_shift)
        assert torch.equal(band, whole[:, :, lo * nw:hi * nw]), (lo, hi)


@pytest.mark.parametrize("from_shift", [False, True], ids=["to_shifted", "to_normal"])
def test_k2_halo_form_reads_no_wrapped_row_into_the_kept_windows(from_shift):
    """The extended map's input tokens valued by their rolled row 7k + i in the input grid:
    a kept output token (window row k, token row i) holds the value 7k + i - 4 (normal ->
    shifted, halo first) or 7k + i + 4 (shifted -> normal, halo last), read without wrapping
    around the extended map; only the dropped halo row wraps."""
    n, nw = 3, 2  # a band of 3 window rows, 2 windows wide, and the halo row
    ext_hw = ((n + 1) * WINDOW[0], nw * WINDOW[1])
    rows = torch.arange(n + 1, dtype=torch.float32)[:, None, None, None] * 7 + torch.arange(7.0)[:, None]
    ext = rows.expand(n + 1, nw, 7, 7).reshape(1, 1, (n + 1) * nw, 49, 1)
    out = twp.repartition_windows_plain(ext, ext_hw, WINDOW, from_shift, not from_shift)
    out = out.reshape(n + 1, nw, 7, 7)
    step = 4 if from_shift else -4
    expect = (rows + step).expand(n + 1, nw, 7, 7)
    kept = slice(0, n) if from_shift else slice(1, n + 1)
    dropped = n if from_shift else 0
    assert torch.equal(out[kept], expect[kept])
    assert not torch.equal(out[dropped], expect[dropped]), "the dropped row is where the map wraps"


class _FakeLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("row0,code", [(0, 1), (2, 2)])
def test_k1_band_launch_hands_the_row_seam_code(monkeypatch, row0, code):
    lib = _FakeLibrary()
    monkeypatch.setattr(tfb, "_fwd_library", lambda drop=False: lib)
    monkeypatch.setattr(twp, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    weights = _block_weights(np.random.default_rng(0), 8, 2, 4, 32)
    x = torch.zeros(2, 1, 8, 49, 8)
    before = (spmd.BAND_LAUNCHES, tfb.LAUNCHES)
    spmd.fused_block_band(x, *weights, hw=(56, 28), row0=row0, window=WINDOW, num_heads=2,
                          dims_per_head=4, shift=True, cross=False)
    (name, args), = lib.calls
    assert name == "swin_k4_fwd"
    # ..., fused, shift, cross, windows, bf16_io, bf16_ops, scale, activation (ELU), stream
    assert args[-9:-5] == (1, code, 0, 1) and args[-19:-15] == (2, 1, 14, 28) and args[-2] == 0
    assert (spmd.BAND_LAUNCHES, tfb.LAUNCHES) == (before[0] + 1, before[1])
    before = spmd.HALO_LAUNCHES
    out = spmd.repartition_halo(x, torch.zeros(2, 1, 4, 49, 8), (56, 28), WINDOW, False, True)
    # one launch of the halo form on the band's 14 rows, the halo row read in place (side -1)
    name, args = lib.calls[-1]
    assert len(lib.calls) == 2 and out.shape == x.shape
    assert name == "swin_repartition_halo_fwd" and args[3:7] == (2, 14, 28, 8 * 4)
    assert args[-4:-1] == (0, 1, -1), "from_shift, to_shift, side"
    assert spmd.HALO_LAUNCHES == before + 1


@pytest.mark.parametrize("max_batch", [0, 2])
def test_tiled_fuser_over_two_ranks_equals_one_device(tmp_path, max_batch):
    args = dict(SEEDS, hw=[126, 126], tile=56, overlap=28, max_batch=max_batch)
    outs = worker.run("tiled", 2, args, str(tmp_path))
    cfg = ModelConfig(**TINY)
    ir, vis = worker.global_batch(1, (126, 126), SEEDS["data_seed"])
    flat = random_variables(cfg, SEEDS["weights_seed"])
    one = TiledFuser(cfg, flat, tile=56, overlap=28, max_batch=max_batch, device="cpu").fuse(ir[0], vis[0])
    ref = jtiled.TiledFuser(JaxUNet(JaxModelConfig(**TINY, attention_impl="jnp")),
                            unflatten_dict(flat, sep="/"), tile=56, overlap=28,
                            mesh=jmesh.data_mesh(2), max_batch=max_batch).fuse(ir[0], vis[0])
    for out in outs:
        np.testing.assert_allclose(out["fused"], one, atol=1e-6, rtol=0)
        np.testing.assert_allclose(out["fused"], np.asarray(ref), atol=2e-4, rtol=1e-3)
