"""The halo form of K2 (``csrc/repartition.cu::swin_repartition_halo_fwd``, the one launch a
band of ``ops/window_pack_spmd.py::repartition_halo``) written out in numpy: its piece size,
its blocks of tokens, each token's source in the (n + 1)-row geometry of ``[halo; band]`` or
``[band; halo]`` read from the halo row or from the band in place, and each thread's walk over
the pieces. The mirror equals the plain version (``repartition_halo_plain``: concatenate, re-
partition the extended map, drop the halo row), which ``tests/test_torch_spatial.py`` holds
against the whole map and JAX's spatial forward, and it writes every output piece once and
reads nothing outside the band and the halo.

Bands of 2 and 4 (and the ring of one band) at every stage map of a 224x224 input of the
default model, both directions, fp32 and bf16; a non-square map with an uneven last band;
misaligned pointers (the 4- and 2-byte pieces). About 10 s in one process.
"""

import numpy as np
import pytest
import torch

from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd
from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan
from swin_unet_image_fusion_tpu_torch.parallel.spatial import split_rows

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WINDOW = (7, 7)
THREADS = 256  # kThreads
HALO_PIECES = 1024  # kHaloPieces


def source_token(tok, h, w, wh, ww, top_from, left_from, top_to, left_to):
    """``source_token`` of ``csrc/repartition.cu`` on int64 arrays."""
    t_len, nw = wh * ww, w // ww
    win, t = tok // t_len, tok % t_len
    rr = (win // nw) * wh + t // ww
    rc = (win % nw) * ww + t % ww
    ph = (rr - top_to + h) % h
    pw = (rc - left_to + w) % w
    fr = (ph + top_from) % h
    fc = (pw + left_from) % w
    return ((fr // wh) * nw + fc // ww) * t_len + (fr % wh) * ww + fc % ww


def halo_launch(band, halo, rows, w, wh, ww, from_shift, to_shift, side, misalign=0):
    """What ``swin_repartition_halo_fwd`` computes, grid block by grid block and thread by
    thread: ``band`` (N, rows * W, row_bytes) and ``halo`` (N, wh * W, row_bytes) as uint8;
    ``misalign`` bytes added to the pointers' alignment (0: 16-byte aligned)."""
    row_bytes = band.shape[2]
    assert row_bytes % 2 == 0 and rows % wh == 0 and w % ww == 0
    assert side == (-1 if to_shift else 1) and from_shift != to_shift
    piece = 16 if row_bytes % 16 == 0 and misalign % 16 == 0 else \
        4 if row_bytes % 4 == 0 and misalign % 4 == 0 else 2
    vec = row_bytes // piece
    tokens = 1 if vec >= HALO_PIECES else HALO_PIECES // vec
    top, left = wh - wh // 2, ww - ww // 2
    tf, lf = (top, left) if from_shift else (0, 0)
    tt, lt = (top, left) if to_shift else (0, 0)
    n = rows // wh
    row_tok = (w // ww) * wh * ww
    band_tok = n * row_tok
    h_ext = (n + 1) * wh
    halo_at = 0 if side < 0 else band_tok
    skip = row_tok if side < 0 else 0
    as_pieces = lambda a: np.ascontiguousarray(a).view(np.dtype((np.void, piece))).reshape(a.shape[0], -1)
    b, h = as_pieces(band), as_pieces(halo)
    out = np.zeros_like(b)
    writes = np.zeros(out.shape, np.int64)
    for blk in range((band_tok + tokens - 1) // tokens):
        tok0 = blk * tokens
        count = min(tokens, band_tok - tok0)
        s = source_token(tok0 + np.arange(count) + skip, h_ext, w, wh, ww, tf, lf, tt, lt)
        r = s - halo_at
        src = np.where((r >= 0) & (r < row_tok), ~r, s - skip)
        assert src.max() < band_tok and (~src[src < 0]).max(initial=0) < row_tok
        # each thread's walk: piece j = t * vec + p, stepped by THREADS without a division
        dt, dp = THREADS // vec, THREADS % vec
        j = np.arange(THREADS)
        t, p = j // vec, j % vec
        while (j < count * vec).any():
            live = j < count * vec
            sj, tj, pj, jj = src[t[live]], t[live], p[live], j[live]
            assert np.array_equal(tj * vec + pj, jj)
            ours = sj >= 0  # a band token, else ~(a halo token)
            out[:, tok0 * vec + jj[ours]] = b[:, sj[ours] * vec + pj[ours]]
            out[:, tok0 * vec + jj[~ours]] = h[:, ~sj[~ours] * vec + pj[~ours]]
            writes[:, tok0 * vec + jj] += 1
            j = j + THREADS
            t, p = t + dt, p + dp
            wrap = p >= vec
            p, t = np.where(wrap, p - vec, p), np.where(wrap, t + 1, t)
    assert (writes == 1).all(), "every output piece written once"
    return out.view(np.uint8).reshape(band.shape)


def _bytes(x: torch.Tensor) -> np.ndarray:
    """(S*B, tokens, C) of ``x`` (S, B, nWin, T, C) as its bytes."""
    s, b, n_win, t, c = x.shape
    return x.reshape(s * b, n_win * t, c).contiguous().view(torch.uint8).numpy()


def check_band(x, hw, from_shift, bands, misalign=0):
    nh, nw = hw[0] // WINDOW[0], hw[1] // WINDOW[1]
    side = spmd.halo_side(from_shift, not from_shift)
    for lo, hi in split_rows(nh, bands):
        row = (lo - 1) % nh if side < 0 else hi % nh  # the ring neighbour's window row
        part, halo = x[:, :, lo * nw:hi * nw].contiguous(), x[:, :, row * nw:(row + 1) * nw].contiguous()
        want = spmd.repartition_halo_plain(part, halo, hw, WINDOW, from_shift, not from_shift)
        got = halo_launch(_bytes(part), _bytes(halo), (hi - lo) * WINDOW[0], hw[1], *WINDOW,
                          from_shift, not from_shift, side, misalign)
        assert np.array_equal(got, _bytes(want)), (hw, bands, lo, hi)


def _stage_maps():
    cfg = ModelConfig()
    plan = make_plan(224, 224, cfg.num_stages, cfg.merging_size, cfg.window_size)
    return [(k, p.att_hw, cfg.out_dims_list[k]) for k, p in enumerate(plan)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("from_shift", [False, True], ids=["to_shifted", "to_normal"])
@pytest.mark.parametrize("stage", range(5))
def test_halo_kernel_mirror_equals_the_plain_form_at_every_stage(dtype, from_shift, stage):
    k, hw, c = _stage_maps()[stage]
    nh, nw = hw[0] // WINDOW[0], hw[1] // WINDOW[1]
    rng = np.random.default_rng(100 + k)
    x = torch.from_numpy(rng.standard_normal((2, 1, nh * nw, 49, c)).astype(np.float32)).to(dtype)
    for bands in (1, 2, 4):
        if bands <= nh:
            check_band(x, hw, from_shift, bands)


@pytest.mark.parametrize("dtype,c,misalign", [(torch.float32, 3, 0), (torch.bfloat16, 3, 0),
                                              (torch.float32, 8, 4), (torch.bfloat16, 8, 2)],
                         ids=["fp32-4B", "bf16-2B", "fp32-misaligned", "bf16-misaligned"])
@pytest.mark.parametrize("from_shift", [False, True], ids=["to_shifted", "to_normal"])
def test_halo_kernel_mirror_on_a_non_square_map_with_an_uneven_last_band(dtype, c, misalign,
                                                                         from_shift):
    hw = (63, 35)  # 9 window rows of 5 windows: 4 bands of 2, 2, 2 and 3 rows
    nh, nw = hw[0] // WINDOW[0], hw[1] // WINDOW[1]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 2, nh * nw, 49, c)).astype(np.float32)).to(dtype)
    for bands in (2, 4):
        assert split_rows(nh, bands)[-1][1] - split_rows(nh, bands)[-1][0] != nh // bands
        check_band(x, hw, from_shift, bands, misalign)
