"""The composition's token mask kernel (``csrc/window_core.cuh::dropout_rows_kernel``, launched
by ``ops/dropout_mask.py::token_dropout`` on a card) written out in numpy, and the cached
arguments of its wrapper.

- The kernel's walk: its vector width and group of threads per token row, its grid over the
  SMs, each group's rows (kDropRows at a time, striding over every stream's rows) and each
  lane's vectors; each row's image, table entry, slot and unit hash taken once, each element's
  keep bit from the row's unit hash and ``intra0 + c * step``. The mirror writes every element
  once, its keep mask equals ``dl.token_keep`` (and the JAX package's ``keep_from_hash`` of
  the same units and offsets), and its output equals ``token_dropout_plain`` bit for bit, fp32
  and bf16 (the product in fp32, rounded once), for the plain (``"k4"``) and the pairs
  (``"k1"``) keying at every stage's ``cols`` of the default model.
- ``_site_args``, which copies a cached struct and sets the seed's hash base, equals a freshly
  built ``dl.drop_args`` byte for byte across changing seeds, sites, rates and keyings.

About 10 s in one process.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from swin_unet_image_fusion_tpu.ops import hash_dropout as jhd
from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WINDOW = (7, 7)
THREADS = 256  # kDropThreads
ROWS = 4  # kDropRows
SMS = 132  # an H100's SMs, which size the grid
LANES = 128  # kPackLanes
M32 = np.uint64(0xFFFFFFFF)


def fmix32(h):
    """murmur3 fmix32 on uint64 arrays holding unsigned 32-bit values."""
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(0x85EBCA6B)) & M32
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(0xC2B2AE35)) & M32
    return h ^ (h >> np.uint64(16))


def vector_width(cols, in_bytes, out_bytes, misalign=0):
    """``launch_dropout_rows``'s V: 16 bytes of the wider type, else 8, else one element."""
    wide = max(in_bytes, out_bytes)
    for v in (16 // wide, 8 // wide):
        if cols % v == 0 and misalign % (v * in_bytes) == 0 and misalign % (v * out_bytes) == 0:
            return v
    return 1


def rows_launch(x, table, units, pairs, images, base, threshold, scale, elem_bytes, misalign=0):
    """What ``launch_dropout_rows`` computes on ``x`` (S, M, N) fp32 values of ``elem_bytes``-
    byte elements, thread by thread: returns (the keep mask, the output in fp32, each
    element's writes)."""
    s_n, m, n = x.shape
    v = vector_width(n, elem_bytes, elem_bytes, misalign)
    vecs = n // v
    group = 1
    while group < vecs and group < 32:
        group *= 2
    sets = (s_n * m + ROWS - 1) // ROWS
    blocks = min((sets * group + THREADS - 1) // THREADS, 8 * SMS)
    groups = blocks * (THREADS // group)
    rows = s_n * m
    hw = m // images
    step = LANES if pairs else 1
    keep = np.zeros((rows, n), bool)
    writes = np.zeros((rows, n), np.int64)
    thread = np.arange(blocks * THREADS)
    lane, gid = thread & (group - 1), thread // group
    r0 = gid.copy()
    while (r0 < rows).any():
        for i in range(ROWS):  # the group's rows r0 + i * groups
            r = r0 + i * groups
            live = (r0 < rows) & (r < rows)
            r, ln = r[live].astype(np.int64), lane[live]
            s, gr = r // m, r % m
            b = gr // hw
            e = table[gr - b * hw]
            unit = (s * images + b) * units + e[:, 0]
            ph = fmix32(unit.astype(np.uint64) ^ np.uint64(base))
            intra0 = (e[:, 1] if pairs else e[:, 1] * n).astype(np.uint64)
            vv = ln.copy()
            while (vv < vecs).any():  # each lane's vectors v, v + group, ...
                on = vv < vecs
                for j in range(v):
                    c = vv[on] * v + j
                    h = fmix32((ph[on] + intra0[on] + c.astype(np.uint64) * np.uint64(step)) & M32)
                    keep[r[on], c] = (h & np.uint64((1 << 23) - 1)) < threshold
                    writes[r[on], c] += 1
                vv = vv + group
        r0 = r0 + ROWS * groups
    out = np.where(keep, x.reshape(rows, n) * np.float32(scale), np.float32(0))
    return keep.reshape(s_n, m, n), out.reshape(s_n, m, n), writes


def _cols():
    cfg = ModelConfig()
    cols = set()
    for k, c in enumerate(cfg.out_dims_list):
        cols |= {c, c * cfg.mlp_hidden_dims_ratio, cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio}
    return sorted(cols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind,shift", [("k4", False), ("k4", True), ("k1", True)])
def test_row_hoisted_keep_equals_the_plain_masks(dtype, kind, shift):
    s, b, hw, rate, seed = 2, 2, (14, 21), 0.5, 1_234_567
    key = dl.keying(kind, hw, WINDOW, shift, 2, 4, "cpu")
    table = key.table.numpy().astype(np.int64)
    assert key.pairs == (kind == "k1")  # offsets c * 128 + slot, else slot * cols + c
    for site, cols in [(hd.SITE_PROJ, 24), *((hd.SITE_MLP_HIDDEN, c) for c in _cols())]:
        gen = torch.Generator().manual_seed(cols)
        a = torch.randn(s, b, *hw, cols, generator=gen).to(dtype)
        keep, out, writes = rows_launch(
            a.float().reshape(s, -1, cols).numpy(), table, key.units, key.pairs, b,
            hd.site_base(seed, site), hd.keep_threshold(rate), hd.keep_scale(rate),
            a.element_size())
        assert (writes == 1).all(), f"cols {cols}: every element written once"
        want = dl.token_keep(seed, site, rate, key, s, b, cols).reshape(keep.shape)
        assert np.array_equal(keep, want.numpy()), f"cols {cols}"
        ref = dm.token_dropout_plain(a, seed, site, rate, key)
        assert torch.equal(torch.from_numpy(out).to(dtype).reshape(a.shape), ref), f"cols {cols}"
    # the JAX package's hash of the same units and offsets, at one cols
    cols = 96
    unit = (np.arange(s * b)[:, None] * key.units + table[None, :, 0]).reshape(-1, 1)
    slot = np.tile(table[:, 1], s * b).reshape(-1, 1)
    c = np.arange(cols)[None]
    intra = c * LANES + slot if key.pairs else slot * cols + c
    jax_keep = jhd.keep_from_hash(jhd.pair_hash(jnp.int32(seed), hd.SITE_MLP_HIDDEN,
                                                jnp.asarray(unit, jnp.int32)),
                                  jnp.asarray(intra, jnp.int32), rate)
    keep, _, _ = rows_launch(np.zeros((s, b * hw[0] * hw[1], cols), np.float32), table, key.units,
                             key.pairs, b, hd.site_base(seed, hd.SITE_MLP_HIDDEN),
                             hd.keep_threshold(rate), 1.0, 4)
    assert np.array_equal(keep.reshape(-1, cols), np.asarray(jax_keep))


@pytest.mark.parametrize("cols,elem_bytes,misalign,width", [
    (24, 4, 0, 4), (24, 2, 0, 8), (4, 4, 0, 4), (4, 2, 0, 4), (6, 4, 0, 2), (6, 2, 0, 1),
    (24, 4, 8, 2), (24, 2, 8, 4), (24, 2, 4, 1), (24, 4, 4, 1)])
def test_vector_width_and_the_narrow_forms(cols, elem_bytes, misalign, width):
    """The widths the launcher picks, and the mirror at each: the 8-byte and one-element
    forms (a row or a pointer that 16 bytes do not divide) give the same mask."""
    assert vector_width(cols, elem_bytes, elem_bytes, misalign) == width
    key = dl.keying("k4", (7, 14), WINDOW, True, 2, 4, "cpu")
    x = np.random.default_rng(cols).standard_normal((2, 3 * 98, cols)).astype(np.float32)
    args = (key.table.numpy().astype(np.int64), key.units, 0, 3, hd.site_base(5, hd.SITE_MLP_OUT),
            hd.keep_threshold(0.25), hd.keep_scale(0.25), elem_bytes)
    keep, out, writes = rows_launch(x, *args, misalign=misalign)
    assert (writes == 1).all()
    want = dl.token_keep(5, hd.SITE_MLP_OUT, 0.25, key, 2, 3, cols).reshape(keep.shape)
    assert np.array_equal(keep, want.numpy())


def test_cached_site_arguments_equal_fresh_ones():
    keys = [dl.keying("k4", (14, 14), WINDOW, False, 2, 4, "cpu"),
            dl.keying("k4", (14, 21), WINDOW, True, 2, 4, "cpu"),
            dl.keying("k1", (14, 28), WINDOW, True, 3, 4, "cpu")]
    rng = np.random.default_rng(3)
    for _ in range(3):  # again, once every template is cached
        for key in keys:
            for site in hd.SITES:
                for rate in (0.1, 0.25, 0.5):
                    for seed in rng.integers(0, 1 << 24, 4):
                        got = dm._site_args(key, site, rate, int(seed))
                        rates = [rate if s == site else 0.0 for s in hd.SITES]
                        want = dl.drop_args(key, rates, int(seed))
                        assert bytes(got) == bytes(want), (key.geometry, site, rate, seed)
    # a call's struct is its own: a later call does not change an earlier one's
    a = dm._site_args(keys[0], hd.SITE_PROJ, 0.1, 11)
    before = bytes(a)
    dm._site_args(keys[0], hd.SITE_PROJ, 0.1, 12)
    assert bytes(a) == before
