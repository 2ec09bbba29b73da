"""The dropout form of K3's redesigned backward (``csrc/window_attention_bwd.cu``: the fused
route at stages 0-1, the split route at stages 2-4, each block in its ``kDrop`` form), on the
CPU.

``k3_drop_bwd_plain`` states in plain torch what the block computes, in its order:

- the attention's keep bits of a window and head are two 32-bit words a query row (keys 0-31,
  then 32-48), hashed once from ``dl.attention_keep``'s masks (K3's keying);
- AV, which wp's gradient reads, comes from the dropped weights p_use = drop(p);
- g_o = g wp^T; g_v = p_use^T g_o; g_p = drop(g_o v^T) with the same bits and scale;
- g_s = p (g_p - sum g_p p) takes the undropped p, and feeds g_q, g_k and the bias table's
  gradient; the projection's dropout is the caller's.

These tests hold it against ``window_attention_bwd_plain`` (autograd of the plain dropout
attention, which the card tests hold the kernels against) at every K3 width of the default
model (C = 24, 48, 96, 192, 384 with 8 heads of d = 3, 6, 12, 24, 48), every shift x cross
case, rates 0.1 and 0.5 (at 0.5 a wrong mask cannot hide), fp32 at
``testing.assert_grads_close``'s tolerances and bf16 (fp32 inside at the upcast x and g) by
``test_torch_block_bwd_split.py``'s rounding rule; the launch plan of the dropout form with a
fake library (a dropout call reaches ``swin_k3_bwd`` with its dropout arguments, the counters,
the shared memory of the keep words); and the plain dropout backward at C = 96, the split
route's head-group geometry, against ``jax.vjp`` of the interpret-mode
``pallas_window_attention`` with the kernel's seed pinned. Inputs are made with numpy from a
seed."""

import numpy as np
import pytest
import torch

import jax

from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops.window import (apply_shift_mask, device_constant, window_partition,
                                                         window_unpartition)
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
from test_torch_attention import JaxAttention
from test_torch_attention import _case as attention_case
from test_torch_dropout import pinned_seed
from test_torch_grad import ATOL, RTOL, _assert_param_grads, _cotangent, _jax_grads
from test_torch_k3_plan import _attention_args, fake_library  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WINDOW = (7, 7)
T = 49
BF16 = torch.bfloat16
SEED = 6_291_469  # < 2^24
HW = (14, 14)
NAMES = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
# (C, heads, d) of the default model's five stages: the fused route at stages 0-1, the split
# route at 2-4
GEOMETRIES = ((24, 8, 3), (48, 8, 6), (96, 8, 12), (192, 8, 24), (384, 8, 48))
CASES = [(geo, shift, cross, rate) for geo in GEOMETRIES for shift in (False, True) for cross in (False, True)
         for rate in (0.1, 0.5)]
IDS = [f"c{g[0]}-shift{int(s)}-cross{int(c)}-rate{r}" for g, s, c, r in CASES]


def keep_words(keep: torch.Tensor) -> torch.Tensor:
    """(..., 49, 2) the kernel's keep words of (..., 49 query rows, 49 keys) keep bits: bit
    u % 32 of word u // 32 keeps key u (``hash_dropout.cuh::attention_keep_words``)."""
    bits = torch.zeros(*keep.shape[:-1], 64, dtype=torch.int64)
    bits[..., :T] = keep.long()
    weights = torch.bitwise_left_shift(torch.ones(32, dtype=torch.int64), torch.arange(32))
    return (bits.reshape(*keep.shape[:-1], 2, 32) * weights).sum(-1)


def word_keep(words: torch.Tensor) -> torch.Tensor:
    """(..., 49, 49) the keep bits that (..., 49, 2) keep words hold (``word_keep``)."""
    u = torch.arange(T)
    return (torch.bitwise_right_shift(words[..., u // 32], u % 32) & 1).bool()


def k3_drop_bwd_sides(g, x, wq, bq, wk, bk, wv, bv, wp, bp, bias, *, num_heads, dims_per_head, shift, cross,
                      attn_drop_rate, drop_seed):
    """The block's dropout backward on fp32 x and g (S, B, H, W, C): (g_x's q side, its k/v
    side, the nine weight gradients)."""
    s, b, h, w, c = x.shape
    heads, d = num_heads, dims_per_head
    top, left = twa.wrap_offsets(WINDOW)

    def windows(a):  # (S, B, H, W, C) -> (S, Bw, T, C), the wrap-rolled partition
        return window_partition(torch.roll(a, (top, left), (2, 3)) if shift else a, WINDOW)

    def image(a):
        a = window_unpartition(a, WINDOW, (h, w))
        return torch.roll(a, (-top, -left), (2, 3)) if shift else a

    def split(a):  # (S, Bw, T, heads*d) -> (S, Bw, heads, T, d)
        return a.reshape(s, -1, T, heads, d).transpose(2, 3)

    def join(a):
        return a.transpose(2, 3).reshape(s, -1, T, heads * d)

    def mm(a, wmat):  # per stream a @ w
        return torch.einsum("sntk,skm->sntm", a, wmat)

    def mm_t(a, wmat):  # per stream a @ w^T
        return torch.einsum("sntm,skm->sntk", a, wmat)

    def wgrad(a, gr):  # [A | 1]^T G per stream
        return torch.einsum("sntk,sntm->skm", a, gr), gr.sum((1, 2))

    xw, gw = windows(x), windows(g)
    kvw = xw.flip(0) if cross else xw
    q = split(mm(xw, wq) + bq[:, None, None]) * d**-0.5
    k = split(mm(kvw, wk) + bk[:, None, None])
    v = split(mm(kvw, wv) + bv[:, None, None])
    scores = q @ k.transpose(-1, -2) + bias[:, None, None]
    if shift:
        scores = apply_shift_mask(scores, device_constant(twa.wrap_region_mask, ((h, w), WINDOW), x.device))
    p = twa.fast_softmax(scores)
    key = twa.attention_keying((h, w), WINDOW, shift, heads, d, x.device)
    words = keep_words(dl.attention_keep(drop_seed, attn_drop_rate, key, dl.windows_table(key), s, b, heads))
    keep = word_keep(words).reshape(p.shape)

    def drop(a):
        return hd.apply_mask(a, keep, attn_drop_rate)

    p_use = drop(p)
    av = join(p_use @ v)
    g_wp, g_bp = wgrad(av, gw)
    g_o = split(mm_t(gw, wp))
    g_v = join(p_use.transpose(-1, -2) @ g_o)
    g_p = drop(g_o @ v.transpose(-1, -2))
    g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True))
    g_q = join(g_s @ k) * d**-0.5
    g_k = join(g_s.transpose(-1, -2) @ q)
    g_wq, g_bq = wgrad(xw, g_q)
    g_wk, g_bk = wgrad(kvw, g_k)
    g_wv, g_bv = wgrad(kvw, g_v)
    g_kv = mm_t(g_k, wk) + mm_t(g_v, wv)
    g_kv = g_kv.flip(0) if cross else g_kv  # to the rows k/v were made from
    return image(mm_t(g_q, wq)), image(g_kv), (g_wq, g_bq, g_wk, g_bk, g_wv, g_bv, g_wp, g_bp, g_s.sum((1, 2)))


def k3_drop_bwd_plain(g, x, *weights, window, sides=False, **kw):
    """(g_x, the nine weight gradients) of the dropout attention as the block computes them,
    fp32 inside at the upcast x and g; g_x in x's dtype, rounded once in self mode and its two
    sides rounded apart and added in bf16 under cross (the rule without dropout).
    ``sides``: the fp32 q side and k/v side instead."""
    assert tuple(window) == WINDOW
    q, kv, wgrads = k3_drop_bwd_sides(g.float(), x.float(), *weights, **kw)
    if sides:
        return q, kv
    if x.dtype == BF16 and kw["cross"]:
        gx = (q.to(BF16).float() + kv.to(BF16).float()).to(BF16)
    else:
        gx = (q + kv).to(x.dtype)
    return (gx, *wgrads)


def _args(geo, shift, cross, rate, dtype, seed):
    c, heads, d = geo
    inner = heads * d
    rng = np.random.default_rng(seed)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x, g = rand(2, 1, *HW, c), rand(2, 1, *HW, c)
    weights = (rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1), rand(2, c, inner, scale=c**-0.5),
               rand(2, inner, scale=0.1), rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
               rand(2, inner, c, scale=inner**-0.5), rand(2, c, scale=0.1), rand(2, T, T))
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross, attn_drop_rate=rate,
              drop_seed=SEED + c)
    return x.to(dtype), weights, g.to(dtype), kw


def test_keep_words_hold_the_masks_bits():
    """Two words a query row hold its 49 keys' bits, and nothing else."""
    keep = torch.rand(3, 8, T, T, generator=torch.Generator().manual_seed(1)) < 0.5
    words = keep_words(keep)
    assert words.shape == (3, 8, T, 2) and int(words.max()) < 2**32
    assert int(torch.bitwise_right_shift(words[..., 1], T - 32).max()) == 0
    assert torch.equal(word_keep(words), keep)


@pytest.mark.parametrize("geo,shift,cross,rate", CASES, ids=IDS)
def test_dropout_decomposition_matches_the_plain_backward_fp32(geo, shift, cross, rate):
    x, weights, g, kw = _args(geo, shift, cross, rate, torch.float32, seed=70 + geo[0] + 2 * shift + cross)
    got = k3_drop_bwd_plain(g, x, *weights, **kw)
    ref = twa.window_attention_bwd_plain(g, x, *weights, **kw)
    assert got[0].shape == x.shape and got[0].dtype == torch.float32
    assert_grads_close(got, ref, NAMES, f"{geo} shift={shift} cross={cross} rate={rate}")


@pytest.mark.parametrize("geo,shift,cross,rate", CASES, ids=IDS)
def test_dropout_decomposition_matches_the_plain_backward_bf16(geo, shift, cross, rate):
    """bf16: the weight gradients as in fp32; g_x in bf16 by the rounding rule of the form
    without dropout (``test_torch_block_bwd_split.py``): bit-equal where the two fp32 sums
    round alike, else one bf16 ulp away; under cross one ulp of each side's own magnitude and
    one of the sum's; plus fp32 noise of 2^-20 of g_x's largest."""
    x, weights, g, kw = _args(geo, shift, cross, rate, BF16, seed=80 + geo[0] + 2 * shift + cross)
    got = k3_drop_bwd_plain(g, x, *weights, **kw)
    ref = twa.window_attention_bwd_plain(g, x, *weights, **kw)
    what = f"{geo} shift={shift} cross={cross} rate={rate}"
    assert got[0].dtype == BF16 == ref[0].dtype
    assert_grads_close(got[1:], ref[1:], NAMES[1:], what)
    a, b = got[0].float(), ref[0].float()

    def ulp(*values):  # one bf16 ulp at the largest magnitude
        return 2.0 ** (torch.floor(torch.log2(torch.stack([v.abs() for v in values]).amax(0).clamp_min(2.0**-126))) - 7)

    if cross:
        q, kv = k3_drop_bwd_plain(g, x, *weights, sides=True, **kw)
        limit = ulp(q) + ulp(kv) + ulp(a, b)
    else:
        limit = ulp(a, b)
    limit = limit + 2.0**-20 * float(b.abs().max())
    assert bool(((a - b).abs() <= limit).all()), what
    assert float((a != b).float().mean()) < 1e-3, what


# ---- the dropout form's launch plan, with a fake library ---------------------------------


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,heads,d", GEOMETRIES, ids=[f"C{g[0]}" for g in GEOMETRIES])
def test_a_dropout_call_reaches_swin_k3_bwd_with_its_dropout_arguments(fake_library, c, heads, d, dtype, cross):
    """A dropout backward at every stage reaches ``swin_k3_bwd`` once (never the three-launch
    backward) with a pointer to the call's dropout arguments: K3's keying of the map (its
    units, the slots' attention offsets with tp = 56), the attention site on at the call's
    rate and seed and the other sites off; the dropout plan's route, head group and blocks; the
    workspace of the form without dropout; and counts once in its dtype's dropout counter."""
    x, weights = _attention_args(c, heads, d, dtype=dtype)
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=True, cross=cross, attn_drop_rate=0.25,
              drop_seed=11)
    before = (twa.BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES, twa.DROP_BWD_LAUNCHES, twa.BF16_DROP_BWD_LAUNCHES)
    grads = twa._launch_bwd(torch.zeros_like(x), x, weights, kw)
    assert grads[0].dtype == dtype and all(t.dtype == torch.float32 for t in grads[1:])
    (args,) = fake_library.calls["swin_k3_bwd"]
    assert "swin_window_attention_bwd" not in fake_library.calls
    drop = args[4].contents
    key = twa.attention_keying(HW, WINDOW, True, heads, d, "cpu")
    assert (drop.units, drop.pairs, drop.attn_mode, drop.t_pad) == (key.units, 0, dl.ATTN_SLOTS, 56)
    assert list(drop.on) == [1, 0, 0, 0] and drop.table != 0
    assert (drop.base[0], drop.threshold[0]) == (hd.site_base(11, hd.SITE_ATTN), hd.keep_threshold(0.25))
    assert drop.scale[0] == hd.keep_scale(0.25)
    plan = twa.bwd_plan(c, heads, d, WINDOW, cross, dtype == BF16, True)
    blocks = plan.blocks(2, 1, *HW, heads)
    # ..., head group, fused, blocks, shift, cross, bf16
    assert args[12:18] == (plan.heads_per_block, int(plan.route == "fused"), blocks, 1, int(cross),
                           int(dtype == BF16))
    assert args[3] == twa.bwd_workspace_floats(2, 1, *HW, c, heads, d, plan, blocks, cross)
    bf16 = dtype == BF16
    assert (twa.BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES, twa.DROP_BWD_LAUNCHES, twa.BF16_DROP_BWD_LAUNCHES) == (
        before[0], before[1], before[2] + 1 - bf16, before[3] + bf16)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_the_plan_counts_the_keep_words(cross):
    """The dropout form's block adds its heads' keep words to its shared memory (hg heads x 49
    rows x 2 words x 4 bytes, aligned to 16: 3,136 bytes at stages 0-1, where every head is in
    the block) and
    nothing else: the tokens' unit hashes lie over the ring, free until the q/k/v product. Every
    stage keeps its route, head group, launches and blocks an SM (stage 1, 102,928 bytes, still
    two), and the workspace is the same: the keep words live in shared memory."""
    for c, heads, d in GEOMETRIES:
        plain = twa.bwd_plan(c, heads, d, WINDOW, cross, False)
        drop = twa.bwd_plan(c, heads, d, WINDOW, cross, False, True)
        assert (drop.route, drop.heads_per_block, drop.pitch, drop.blocks_per_sm) == (
            plain.route, plain.heads_per_block, plain.pitch, plain.blocks_per_sm)
        assert drop.launches(cross) == plain.launches(cross)
        added = {kind: b - dict(plain.smem)[kind] for kind, b in drop.smem}
        words = -(-drop.heads_per_block * T * 2 * 4 // 16) * 16  # aligned to 16 bytes
        assert added == {"attention": words, **({"gx": 0} if drop.route == "split" else {})}
        assert twa.keep_words_bytes(drop.heads_per_block) == words
    assert twa.bwd_plan(48, 8, 6, WINDOW, cross, False, True).smem[0][1] == 102_928 <= twa.SMEM_TWO_PER_SM


def test_a_dropout_call_on_a_shape_the_plan_does_not_take_raises_before_any_launch(fake_library):
    x, weights = _attention_args(512, 8, 64)
    kw = dict(window=WINDOW, num_heads=8, dims_per_head=64, shift=False, cross=False, attn_drop_rate=0.1,
              drop_seed=3)
    with pytest.raises(ValueError, match="dims per head"):
        twa._launch_bwd(torch.zeros_like(x), x, weights, kw)
    assert not fake_library.calls


# ---- the plain dropout backward against JAX at the split route's head-group geometry --------


@pytest.mark.parametrize("shift,cross", [(True, True)], ids=["c96-shift1-cross1"])
def test_k3_dropout_grads_match_jax_pallas_attention_at_a_head_group_geometry(shift, cross):
    """The port's ``DualWindowAttention`` under ``cuda`` with the attention weights at rate 0.5
    runs, on the CPU, the plain dropout backward that the kernels reproduce; held against
    ``jax.vjp`` of the interpret-mode ``pallas_window_attention`` with the kernel's seed pinned
    at C = 96, 8 heads of d = 12 (the split route's four heads a block), a 14x14 map and one
    image per stream, at rtol/atol 2e-4 as ``test_torch_k3_bwd_parity.py`` holds it without
    dropout."""
    rate = 0.5
    x, kw, variables, port = attention_case((96, 8, 12, *HW), shift, cross, seed=61)
    x = np.ascontiguousarray(x[:, :1])
    g = _cotangent(x.shape, 62)
    module = JaxAttention(**kw, attention_drop_ratio=rate, impl="pallas_interpret")
    apply = jax.jit(lambda v, a: module.apply(v, a, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))
    with pinned_seed(jpa, "pallas_window_attention", SEED) as calls:
        ref_x, ref_params = _jax_grads(apply, variables, x, g)
    assert calls == [SEED]
    assert twa.bwd_plan(96, 8, 12, WINDOW, cross, False, True).route == "split"
    port.attention_drop_ratio = rate
    launches = twa.DROP_LAUNCHES, twa.DROP_BWD_LAUNCHES
    xt = torch.from_numpy(x).requires_grad_()
    port(xt, "cuda", (SEED, dl.keying("k4", HW, WINDOW, shift, 8, 12, "cpu"))).backward(torch.from_numpy(g))
    assert (twa.DROP_LAUNCHES, twa.DROP_BWD_LAUNCHES) == launches, "the plain backward counts no launch"
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=ATOL, rtol=RTOL)
    _assert_param_grads(port, ref_params)
