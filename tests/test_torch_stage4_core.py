"""The C = 384 backward's design, on the CPU: K3's backward core at d = 48 and the split route's
plan at stage 4.

``csrc/window_bwd.cuh::core_bwd_tiled`` is K3's backward core above a q/k row pitch of 24 (d =
48, stage 4 of the default model; K1's and K4's split route runs it too): a head's P and g_S go
to shared memory, the rows pass forms the scores and g_P = g_o v^T four head columns at a time
with one running sum a key, and AV, g_q, g_k and g_v are four 49 x 49 by 49 x 48 products
summed over the keys or query rows in order. A CUDA kernel cannot run here, so a torch mirror
of that order (the same sums in the same sequence, one rounding a multiply and an add where the
card fuses them) is held against autograd of the plain core in float64, with and without
dropout keep words packed as ``csrc/hash_dropout.cuh`` packs them, at one head of d = 48 and
at two heads of d = 40 padded to the pitch of 48. Then the plans: ``window_attention.bwd_plan``
at d = 48 (the tiled core's shared memory, one block an SM), ``fused_block.block_bwd_plan`` at
C = 384 (the split route: every kernel's shared memory and the workspace counted buffer by
buffer, as ``test_torch_block_bwd_plan.py`` counts stages 2-3), and that no shape of the
default model plans the twenty launches of ``csrc/fused_block.cu``. The kernels themselves run
in ``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

T, QUARTER, LANES = 49, 13, 4
CLAMP = twa.SOFTMAX_CLAMP


def _keep_words(keep):
    """(heads, 49, 49) keep bits as the kernel reads them: two 32-bit words a (head, query row),
    keys 0-31 in the first, 32-48 in the second (``hash_dropout.cuh::word_keep``)."""
    bits = keep.astype(np.uint64) << (np.arange(T, dtype=np.uint64) % 32)
    return np.stack([bits[..., :32].sum(-1), bits[..., 32:].sum(-1)], -1).astype(np.uint32)


def _word_keep(words):
    """The (heads, 49, 49) keep bits of packed keep words, bit u of word u / 32."""
    u = np.arange(T)
    return ((words[..., u // 32] >> (u % 32).astype(np.uint32)) & 1).astype(bool)


def _lane_sum(x):
    """Sums over the 49 keys of each row as the rows pass's four lanes take them: lane q adds
    its keys 13 q .. in order, then the lanes' sums combine as (l0 + l1) + (l2 + l3)."""
    lanes = []
    for q in range(LANES):
        s = torch.zeros(x.shape[0], dtype=x.dtype)
        for u in range(QUARTER * q, min(QUARTER * (q + 1), T)):
            s = s + x[:, u]
        lanes.append(s)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def core_bwd_tiled_mirror(q, k, v, go, bias, d, scale, keep=None, drop_scale=1.0):
    """``core_bwd_tiled`` in the kernel's order on (heads, 49, pitch) fp32 q (scaled), k, v, g_o
    and the window's (49, 49) bias (-inf between wrap regions): AV, g_q, g_k, g_v as (heads, 49,
    d) and the bias-table gradient (49, 49) summed over the heads."""
    heads, _, pitch = q.shape
    out = {name: torch.zeros(heads, T, d) for name in ("av", "gq", "gk", "gv")}
    tab = torch.zeros(T, T)
    for h in range(heads):
        s, gp = torch.zeros(T, T), torch.zeros(T, T)
        for j in range(pitch):  # the rows pass: one running sum a key, in column order
            s = s + q[h, :, j, None] * k[h, None, :, j]
            gp = gp + go[h, :, j, None] * v[h, None, :, j]
        e = torch.exp(torch.clamp(s + bias, max=CLAMP))
        if keep is not None:
            gp = torch.where(keep[h], gp * drop_scale, torch.zeros(()))
        r = 1.0 / (_lane_sum(e) + 1e-30)
        dot = _lane_sum(e * gp) * r
        p = e * r[:, None]
        gs = p * (gp - dot[:, None])
        tab = tab + gs
        pd = p if keep is None else torch.where(keep[h], p * drop_scale, torch.zeros(()))
        av, gq, gk, gv = (torch.zeros(T, pitch) for _ in range(4))
        for i in range(T):  # the products: sums over the 49 keys (AV, g_q) or query rows (g_k, g_v) in order
            av = av + pd[:, i, None] * v[h, i]
            gq = gq + gs[:, i, None] * k[h, i]
            gk = gk + gs[i, :, None] * q[h, i]
            gv = gv + pd[i, :, None] * go[h, i]
        for name, value in (("av", av), ("gq", gq * scale), ("gk", gk), ("gv", gv)):
            out[name][h] = value[:, :d]
    return out, tab


def core_bwd_plain(q, k, v, go, bias, d, scale, keep=None, drop_scale=1.0):
    """The same by autograd of the plain core in float64: AV = drop(softmax(q k^T + bias)) v."""
    qq, kk, vv = (a[..., :d].double().requires_grad_() for a in (q, k, v))
    b = bias.double().requires_grad_()
    e = torch.exp(torch.clamp(qq @ kk.transpose(1, 2) + b, max=CLAMP))
    p = e / (e.sum(-1, keepdim=True) + 1e-30)
    if keep is not None:
        p = torch.where(keep, p * drop_scale, torch.zeros((), dtype=p.dtype))
    av = p @ vv
    av.backward(go[..., :d].double())
    grads = {"av": av.detach(), "gq": qq.grad * scale, "gk": kk.grad, "gv": vv.grad}
    return grads, torch.where(torch.isfinite(bias), b.grad, torch.zeros((), dtype=b.dtype))


def _core_case(heads, d, seed, rate):
    rng = np.random.default_rng(seed)
    pitch = 48

    def rows(scale=1.0):
        a = np.zeros((heads, T, pitch), np.float32)
        a[..., :d] = rng.standard_normal((heads, T, d)) * scale
        return torch.from_numpy(a)

    scale = d**-0.5
    q, k, v, go = rows(scale), rows(), rows(), rows()
    t = np.arange(T)
    region = 2 * (t // 7 >= 4) + (t % 7 >= 4)  # the four wrap regions of a shifted map's last window
    bias = rng.standard_normal((T, T)).astype(np.float32)
    bias[region[:, None] != region[None, :]] = -np.inf
    keep, drop_scale = None, 1.0
    if rate:
        words = _keep_words(rng.random((heads, T, T)) >= rate)
        keep, drop_scale = torch.from_numpy(_word_keep(words)), 1.0 / (1.0 - rate)
    return q, k, v, go, torch.from_numpy(bias), scale, keep, drop_scale


def test_keep_words_pack_as_the_kernel_reads_them():
    """Bit u of word u / 32 is key u's keep bit, both ways."""
    keep = np.random.default_rng(7).random((2, T, T)) >= 0.5
    words = _keep_words(keep)
    assert words.shape == (2, T, 2) and words.dtype == np.uint32
    assert np.array_equal(_word_keep(words), keep)
    assert not (words[..., 1] >> (T - 32)).any()  # keys 49-63 hold no bit


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5], ids=["nodrop", "drop0.1", "drop0.5"])
@pytest.mark.parametrize("heads,d", [(1, 48), (2, 40)], ids=["1x48", "2x40"])
def test_tiled_core_order_matches_the_plain_backward(heads, d, rate):
    """AV, g_q, g_k, g_v and the bias-table gradient of the mirror against autograd of the plain
    core: fp32 sums in the kernel's order, within rtol 2e-5 of each output's own largest; a
    masked score's gradient exactly 0; AV and g_v from the dropped weights, g_S from the
    undropped ones."""
    q, k, v, go, bias, scale, keep, drop_scale = _core_case(heads, d, 60 + heads + int(100 * rate), rate)
    got, tab = core_bwd_tiled_mirror(q, k, v, go, bias, d, scale, keep, drop_scale)
    ref, ref_tab = core_bwd_plain(q, k, v, go, bias, d, scale, keep, drop_scale)
    for name in ("av", "gq", "gk", "gv"):
        r = ref[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), r, rtol=2e-5, atol=2e-5 * np.abs(r).max(), err_msg=name)
    r = ref_tab.numpy()
    np.testing.assert_allclose(tab.numpy(), r, rtol=2e-5, atol=2e-5 * np.abs(r).max(), err_msg="bias")
    assert not tab[~torch.isfinite(bias)].any(), "a masked score's gradient is exactly 0"
    if rate:
        dropped = (keep == 0).sum().item()
        assert 0 < dropped < keep.numel()


def test_k3_plan_at_d48_takes_the_tiled_core():
    """K3's backward at stage 4 (C = 384, 8 heads of d = 48): the split route, one head a block,
    the tiled core above ``PASSES_PITCH_MAX`` with a head's P and g_S rows ([49][52] floats each)
    after the block's other buffers (under cross: the x rings of both streams, 2 x 16 x 60
    floats each, the weight ring 2 x 16 x 144, q/k/v/g_o [49][48], the row sums, the bias and
    tables), the dropout form its head's keep words before them; one block an SM (its 255
    registers; at two blocks' 128 its streamed products spill)."""
    assert twa.PASSES_PITCH_MAX == 24
    tail = 9616 + (3 * 64 + 2 * 192) * 4
    core = 2 * 49 * 52 * 4
    for cross in (False, True):
        for drop in (False, True):
            plan = twa.bwd_plan(384, 8, 48, (7, 7), cross, False, drop)
            smem = ((2 if cross else 1) * 2 * 16 * 60 * 4 + 2 * 16 * 144 * 4 + 4 * 49 * 48 * 4 + 400 + tail
                    + (400 if drop else 0) + core)
            assert (plan.route, plan.heads_per_block, plan.pitch, plan.blocks_per_sm) == ("split", 1, 48, 1)
            assert plan.smem == (("attention", smem), ("gx", twa.gx_smem(384)))
    assert dict(twa.bwd_plan(384, 8, 48, (7, 7), True, False).smem)["attention"] == 104_128
    assert twa.bwd_plan(192, 8, 24, (7, 7), True, False).blocks_per_sm == 1  # stage 3 keeps core_bwd


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("hidden", [1536, 768])
def test_the_stage4_split_plan_counts_every_buffer(hidden, drop):
    """Stage 4 (C = 384, d = 48) under cross takes the split route at pitch 48: the recomputed
    attention's block (the x rings of both streams, 3 x 16 x 60 floats each, the weight ring 3 x
    16 x 144, q/k/v of one head [49][48], the bias and tables; dropout: the tokens' hashes and
    slots, 2 x 64 x 4 bytes, and the head's keep words); the projection rows' and fc1's the
    forward's rings; the MLP backward's weight ring (2 x 16 x 144: the hidden step is wider than
    the 128-column g_lny groups), the g_lny sums [49][384], g resident (384 x 60), the step's
    g_pre (144 x 60), the LN2 statistics and sums (dropout: 4 x 64 x 4 of hashes), 224 KB, one
    block an SM; K3's block as ``window_attention.bwd_smem`` (the tiled core, one an SM); the
    g_ln product's rings (2 x 16 x 60, 2 x 16 x 128), both sides of LN1(x)'s gradient [49][384],
    the row table, LN1 statistics and sums, 174 KB, one an SM; the stepped MLP backward's LN2
    epilogue the g_lny sums [49][384] and the LN2 statistics and sums (dropout: the proj site's
    hashes and slots, 2 x 64 x 4); the grouped g_ln product's LN1 epilogue both sides of
    LN1(x)'s gradient [49][384] and the LN1 statistics and sums; the hidden steps (11 or 6 of
    144 columns) and the g_ln product's column groups (3 of 128)."""
    words = 49 * 2 * 4 if drop else 0
    tables = 9616 + (2 * 64 + 3 * 192) * 4
    attention = 3 * 2 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 3 * 49 * 48 * 4 + tables + (2 * 64 * 4 + 400 if drop else 0)
    rows, fc1 = 6 * 16 * 60 * 4 + 6 * 16 * 48 * 4 + 2 * 64 * 4, 3 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 64 * 4
    mlp = 2 * 16 * 144 * 4 + 49 * 384 * 4 + 384 * 60 * 4 + 144 * 60 * 4 + 64 * 8 + 2 * 384 * 4 + (4 * 64 * 4 if drop else 0)
    k3 = twa.bwd_smem(False, True, 384, 384, 1, 48, 48, drop)
    gln = 2 * 16 * 60 * 4 + 2 * 16 * 128 * 4 + 2 * 49 * 384 * 4 + 64 * 4 + 64 * 8 + 2 * 384 * 4
    ln2 = 49 * 384 * 4 + 64 * 8 + 2 * 384 * 4 + (2 * 64 * 4 if drop else 0)
    ln1 = 2 * 49 * 384 * 4 + 64 * 8 + 2 * 384 * 4
    plan = tfb.block_bwd_plan(384, 8, 48, hidden, (7, 7), True, drop)
    assert (plan.route, plan.launches, plan.pitch, plan.hidden_chunk) == ("split", 11, 48, 144)
    assert plan.split_steps == ({1536: 11, 768: 6}[hidden], 3)
    assert (plan.heads_per_block, plan.groups, plan.blocks_per_sm) == ((1, 1), 8, (1, 1, 1))
    assert plan.smem == (("attention", attention), ("rows", rows), ("fc1", fc1), ("mlp", mlp),
                         ("attention_bwd", k3), ("gln", gln), ("ln2", ln2), ("ln1", ln1))
    assert k3 == 104_128 + (400 if drop else 0) and words <= 400
    assert (mlp, gln) == (224_000 + (1024 if drop else 0), 178_432)
    assert max(b for _, b in plan.smem) <= tfb.SMEM_LIMIT_BYTES
    assert tfb.block_bwd_plan(384, 8, 48, hidden, (7, 7), False, drop).blocks_per_sm == (1, 1, 2)


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
def test_the_stage4_split_workspace_counts_every_buffer(drop):
    """Stage 4, encoder MLP, cross, at 448² batch 5 (a 14 x 14 map) on a 132-SM card: 20 MLP and
    20 g_ln blocks per stream (one per 49-token tile), 8 K3 blocks per stream and head (one an
    SM over 8 heads and 2 streams); the token buffers (LN1(x), y, LN2(y) and g_y of C = 384, the
    statistics, AV, g_q, g_k and g_v of 384, the hidden and g_pre of 1536), the transposed
    weights, the partials of the bias table per K3 block, of LN2 per MLP block and of LN1 per
    g_ln block, and the weight gradients' chunks: two, for sixteen of the 486 working blocks a
    stream (42 rectangles of 16 x 16 tiles for each of wq, wk, wv and wp, 168 for w1, 150 for
    w2) an SM; dropout adds g_m and g_proj per token and the keep words of every (image, window,
    head). At pitch 48 the MLP backward is stepped, a block a hidden step (11 of 144 columns),
    each step's g_lny of every token kept for the LN2 epilogue, and the g_ln product grouped, a
    block a column group (3 of 128), both sides of g_ln of every token kept for the LN1
    epilogue."""
    plan = tfb.block_bwd_plan(384, 8, 48, 1536, (7, 7), True, drop)
    m, blocks = 5 * 14 * 14, plan.blocks(2, 5, 14, 14)
    assert blocks == (20, 8, 20) and plan.split_steps == (11, 3)
    tokens = 2 * m * (384 * 8 + 2 + 1536 * 2)
    weights = 2 * (4 * 384 * 384 + 2 * 384 * 1536)
    partials = 2 * (8 * 8 * 49 * 49 + 20 * 768 + 20 * 768)
    assert tfb._wgrad_chunks(m, (4 * 42 + 168 + 150)) == 2
    chunks = 2 * 2 * (4 * 385 * 384 + 385 * 1536 + 1537 * 384)
    dropped = 2 * m * 2 * 384 + 2 * 5 * 4 * 8 * 49 * 2 if drop else 0
    stepped = 11 * 2 * m * 384 + 2 * 2 * m * 384
    expected = tokens + weights + partials + chunks + dropped + stepped
    floats = tfb.split_workspace_floats(2, 5, 14, 14, 384, 8, 48, 1536, plan, blocks, drop)
    assert expected <= floats < expected + 32 * 27  # every piece rounded up to 32 floats
    unstepped = dataclasses.replace(plan, split_steps=(1, 1))
    assert floats - tfb.split_workspace_floats(2, 5, 14, 14, 384, 8, 48, 1536, unstepped, blocks, drop) == stepped


def test_no_shape_of_the_default_model_plans_the_twenty_launches():
    """Every stage of the default model, both MLP widths, self and cross, with and without
    dropout, takes a redesigned route (the fused route at stages 0-1, the split route at 2-4):
    the plan depends on C, heads, d and the hidden alone, not on the map, so no crop's training
    step launches ``csrc/fused_block.cu``; K3's backward at stage 4 takes its tiled core."""
    cfg = ModelConfig()
    for k, c in enumerate(cfg.out_dims_list):
        d = cfg.dims_per_head(c)
        for hidden in (c * cfg.mlp_hidden_dims_ratio, cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio):
            for cross in (False, True):
                for drop in (False, True):
                    route = tfb.block_bwd_plan(c, cfg.att_num_heads, d, hidden, cfg.window_size, cross, drop).route
                    assert route == ("fused" if k < 2 else "split"), (k, hidden, cross, drop, route)
        assert (twa.bwd_plan(c, cfg.att_num_heads, d, cfg.window_size, True, False).pitch > twa.PASSES_PITCH_MAX) == (k == 4)
    assert tfb.SPLIT_PITCHES == (12, 24, 48)
