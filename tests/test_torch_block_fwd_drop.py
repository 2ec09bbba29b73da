"""The dropout form of the fused block's redesigned forward (K1 and K4 with dropout:
``csrc/fused_block_fwd.cu``'s one launch at stages 0-1 and six launches at stages 2-4, each
kernel in its ``kDrop`` form), on the CPU.

Both routes mask the same sites at the same points and round where the form without dropout
rounds; only where the block's pieces live differs (shared memory on the one-launch route, the
split route's scratch in the operands' dtype). ``drop_fwd_plain`` states that sequence in plain
torch, the masks computed as the kernels compute them: each token's unit hash once per site
(``hash_dropout.pair_hash`` of its global unit), then an element's keep bit from the hash and
its intra-unit offset; the attention's keep bits two 32-bit words a query row (the bf16 core
reads such words, the fp32 core hashes the same bits where it uses them):

- p before AV: in fp32 (K4 fp32, K1 in both dtypes) AV = (sum of the kept keys' e v) / (sum
  e + 1e-30) x scale, the core's order; in K4 bf16 p = e / (sum e + 1e-30) of a kept key
  times the scale, 0 else, rounded to bf16 as an operand of AV (the TPU body masks p before
  the cast);
- y = x + drop(AV wp + bp), fp32;
- the hidden drop(ELU(LN2(y) w1 + b1)), rounded after the mask in K4 bf16;
- out = y + drop(h w2 + b2), rounded once to x's dtype.

These tests hold it against ``fused_block_plain`` with ``drop_rates`` (which the card tests hold
the kernels against) at every width of the default model (C = 24, 48, 96, 192, 384), both
layouts (K4's keying on the image, K1's on window-packed tokens), fp32 and bf16, every shift x
cross case, rates 0.1 and 0.5; the launch plan of the dropout form with a fake library (the
routes, the shared memory of the masks, that a dropout call in either layout reaches
``swin_k4_fwd`` with its dropout arguments and never the five launches of
``csrc/fused_block.cu``); and the plain dropout forward at C = 96, the split route's geometry,
against the interpret-mode ``pallas_fused_block`` and ``pallas_packed_block_strips`` with the
kernel's seed pinned. Inputs are made with numpy from a seed."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops.window import device_constant
from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_windows, unpack_windows
from test_torch_dropout import _jax_block, _set_block_rates, pinned_seed
from test_torch_fused_block import _block_case
from test_torch_k3_bwd_drop import keep_words, one_torch_thread, word_keep  # noqa: F401 (an autouse fixture)
from test_torch_k4_plan import _block_args, _kw, _windows, fake_library  # noqa: F401 (a fixture)

WINDOW = (7, 7)
T = 49
BF16 = torch.bfloat16
SEED = 7_864_331  # < 2^24
HW = (14, 14)
# (C, heads, d, MLP hidden): the default model's five encoder blocks (stages 0-1 the one-launch
# route, 2-4 the six launches)
GEOMETRIES = ((24, 8, 3, 96), (48, 8, 6, 192), (96, 8, 12, 384), (192, 8, 24, 768), (384, 8, 48, 1536))
CASES = [(geo, shift, cross, rate) for geo in GEOMETRIES for shift in (False, True) for cross in (False, True)
         for rate in (0.1, 0.5)]
IDS = [f"c{g[0]}-shift{int(s)}-cross{int(c)}-rate{r}" for g, s, c, r in CASES]


def _unit_hashes(key, table, seed, site, s, b):
    """(S, B, nWin, T) the unit hash of every token at ``site``: computed once a token."""
    unit = torch.arange(s * b).reshape(s, b, 1, 1) * key.units + table[..., 0].long()
    return hd.pair_hash(seed, site, unit)


def _token_keep(ph, table, rate, cols, pairs):
    """(S, B, nWin, T, cols) keep bits of a token site from the tokens' unit hashes."""
    slot = table[..., 1].long()[..., None]
    c = torch.arange(cols)
    intra = c * dl.LANES + slot if pairs else slot * cols + c
    return hd.keep_from_hash(ph[..., None], intra, rate)


def drop_fwd_windows(xw, weights, *, hw, num_heads, dims_per_head, shift, cross, rates, seed, key, rnd, bf16_p):
    """The dropout forward on fp32 window-packed tokens (S, B, nWin, 49, C), in fp32."""
    (ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2_s, ln2_b, w1, b1, w2, b2) = weights
    s, b, n_win, t, c = xw.shape
    heads, d = num_heads, dims_per_head
    hidden = w1.shape[-1]
    rate_a, rate_p, rate_m = rates
    table = dl.windows_table(key)  # (nWin, T, 2) in the layout's window order
    ph = {site: _unit_hashes(key, table, seed, site, s, b) for site in hd.SITES}

    def site(a, site_id, rate):
        if not rate:
            return a
        return hd.apply_mask(a, _token_keep(ph[site_id], table, rate, a.shape[-1], key.pairs), rate)

    def split_heads(a):
        return a.reshape(s, b, n_win, t, heads, d).transpose(3, 4)

    ln = rnd(tfb._layer_norm(xw, ln1_s, ln1_b))
    kv = ln.flip(0) if cross else ln
    q = split_heads(tfb._dense(ln, rnd(wq), bq) * d**-0.5)
    k = split_heads(tfb._dense(kv, rnd(wk), bk))
    v = split_heads(tfb._dense(kv, rnd(wv), bv))
    scores = q @ k.transpose(-1, -2) + bias[:, None, None, None]
    if shift:
        scores = scores.masked_fill(device_constant(tfb.wrap_region_mask, (tuple(hw), WINDOW), xw.device)[:, None],
                                    -1e10)
    e = torch.exp(torch.clamp(scores, max=twa.SOFTMAX_CLAMP))
    r = 1.0 / (e.sum(-1, keepdim=True) + 1e-30)
    if rate_a:  # the query token's unit hash keys the pair: two words a query row
        slot = table[..., 1].long()
        hh = torch.arange(heads).reshape(1, 1, 1, heads, 1, 1)
        if key.attn_mode == dl.ATTN_SLOTS:
            intra = (hh * key.t_pad + slot[:, None, :, None]) * key.t_pad + slot[:, None, None, :]
        elif key.attn_mode == dl.ATTN_WIN64:
            intra = (hh * dl.TOK + (slot[:, None, None, :] & (dl.TOK - 1))) * dl.LANES + slot[:, None, :, None]
        else:
            intra = (slot[:, None, :, None] * heads + hh) * dl.LANES + slot[:, None, None, :]
        keep = hd.keep_from_hash(ph[hd.SITE_ATTN][:, :, :, None, :, None], intra, rate_a)
        keep = word_keep(keep_words(keep))
        scale = hd.keep_scale(rate_a)
        if bf16_p:  # p = e r of a kept key times the scale, rounded as AV's operand
            av = rnd(rnd(torch.where(keep, (e * r) * scale, torch.zeros(()))) @ rnd(v))
        else:  # the kept keys' e v, then 1 / (sum + 1e-30) and the scale
            av = ((torch.where(keep, e, torch.zeros(())) @ v) * r) * scale
    else:
        av = rnd(rnd(e * r) @ rnd(v))
    av = rnd(av.transpose(3, 4).reshape(s, b, n_win, t, heads * d))
    y = xw + site(tfb._dense(av, rnd(wp), bp), hd.SITE_PROJ, rate_p)
    h = F.elu(tfb._dense(rnd(tfb._layer_norm(y, ln2_s, ln2_b)), rnd(w1), b1))
    h = rnd(site(h, hd.SITE_MLP_HIDDEN, rate_m))
    return y + site(tfb._dense(h, rnd(w2), b2), hd.SITE_MLP_OUT, rate_m)


def drop_fwd_plain(x, *weights, window, num_heads, dims_per_head, shift, cross, layout, hw=None, drop_rates,
                   drop_seed):
    """The dropout forward as both routes compute it, for x in ``layout`` and either dtype."""
    h, w = tuple(x.shape[2:4]) if layout == "image" else hw
    key = tfb.block_keying(layout, (h, w), window, shift, num_heads, dims_per_head, x.device)
    ops = tfb.rounds_operands(x.dtype, layout)
    xw = pack_windows(x.float(), window, shift) if layout == "image" else x.float()
    out = drop_fwd_windows(xw, weights, hw=(h, w), num_heads=num_heads, dims_per_head=dims_per_head, shift=shift,
                           cross=cross, rates=drop_rates, seed=drop_seed, key=key,
                           rnd=twa.operand_rounding(ops), bf16_p=ops).to(x.dtype)
    return unpack_windows(out, (h, w), window, shift) if layout == "image" else out


def _args(geo, shift, cross, rate, layout, dtype, seed):
    c, heads, d, hidden = geo
    rng = np.random.default_rng(seed)
    inner = heads * d

    def rand(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))

    def dense(i, o):
        return rand(2, i, o, scale=i**-0.5), rand(2, o, scale=0.1)

    x = rand(2, 1, *HW, c)
    weights = (rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1), *dense(c, inner), *dense(c, inner),
               *dense(c, inner), *dense(inner, c), rand(2, T, T), rand(2, c, scale=0.1, offset=1.0),
               rand(2, c, scale=0.1), *dense(c, hidden), *dense(hidden, c))
    if layout == "windows":
        x = pack_windows(x, WINDOW, shift)
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross, layout=layout, hw=HW,
              drop_rates=(rate, rate, rate), drop_seed=SEED + c)
    return x.to(dtype), weights, kw


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("geo,shift,cross,rate", CASES, ids=IDS)
def test_dropout_forward_matches_the_plain_version_fp32(geo, shift, cross, rate, layout):
    """fp32: within 1e-5 of the output's largest magnitude (the core's sum of the kept terms
    before 1/(sum + 1e-30) and the scale, against the plain version's masked weights)."""
    x, weights, kw = _args(geo, shift, cross, rate, layout, torch.float32, seed=20 + geo[0] + 2 * shift + cross)
    got = drop_fwd_plain(x, *weights, **kw)
    ref = tfb.fused_block_plain(x, *weights, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("geo,shift,cross,rate", CASES, ids=IDS)
def test_dropout_forward_matches_the_plain_version_bf16(geo, shift, cross, rate, layout):
    """bf16: K1 (fp32 inside) rounds once on the store, so its output lies within the fp32
    test's 1e-5 of the largest magnitude and one bf16 ulp of the plain version's; K4 rounds where
    the plain version rounds (p after its mask, AV, LN1, LN2, the hidden after its mask), so
    every element is bit-equal but for the fp32 core's order, which K4 does not take: equal, or
    the bf16 kernels' criteria (rtol 2^-7, atol 2^-6 of the largest, at most 1% of the elements
    apart)."""
    x, weights, kw = _args(geo, shift, cross, rate, layout, BF16, seed=30 + geo[0] + 2 * shift + cross)
    got = drop_fwd_plain(x, *weights, **kw).float()
    ref = tfb.fused_block_plain(x, *weights, **kw).float()
    what = f"{geo} {layout} shift={shift} cross={cross} rate={rate}"
    if layout == "windows":
        ulp = 2.0 ** (torch.floor(torch.log2(torch.maximum(got.abs(), ref.abs()).clamp_min(2.0**-126))) - 7)
        assert bool(((got - ref).abs() <= ulp + 1e-5 * float(ref.abs().max())).all()), what
    else:
        torch.testing.assert_close(got, ref, rtol=2.0**-7, atol=2.0**-6 * float(ref.abs().max()), msg=what)
    assert float((got != ref).float().mean()) <= 0.01, what


# ---- the dropout form's launch plan, with a fake library ---------------------------------


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32-ops", "bf16-ops"])
def test_the_plan_routes_the_dropout_form_as_the_form_without_and_counts_its_masks(bf16, cross):
    """``block_fwd_plan(..., drop=True)`` keeps every shape's route, launches, head group, hidden
    step and blocks an SM (stage 0's one-launch block in fp32 still three: its core hashes
    each weight's keep bit where it uses it). The bf16 one-launch block holds every head's keep
    words after its P in the ring (8 heads x 49 rows x 2 words x 4 bytes, aligned to 16), which
    grows only where they do not fit; the split route's attention block adds its tokens' unit hashes and
    slots (2 x 64 x 4 bytes) and its head group's keep words; the row, fc1 and LN launches add
    nothing (the row and fc1 kernels hash their tokens over their ring after the GEMM)."""
    def words(heads):  # aligned to 16 bytes
        return -(-heads * T * 2 * 4 // 16) * 16

    for c, heads, d, hidden in GEOMETRIES:
        plain = tfb.block_fwd_plan(c, heads, d, hidden, WINDOW, cross, bf16)
        drop = tfb.block_fwd_plan(c, heads, d, hidden, WINDOW, cross, bf16, True)
        assert (drop.route, drop.launches, drop.heads_per_block, drop.hidden_chunk, drop.blocks_per_sm) == (
            plain.route, plain.launches, plain.heads_per_block, plain.hidden_chunk, plain.blocks_per_sm)
        added = {kind: b - dict(plain.smem)[kind] for kind, b in drop.smem}
        if drop.route == "fused":
            p_bytes = 8 * 32 * 72 * 2 if bf16 else 0  # bf16's P rows, 8 warps x 32 x 72 halves
            tile = 8 if bf16 else 4
            nb = max(3 * heads * d, c, -(-drop.hidden_chunk // tile) * tile)
            ring = 3 * 16 * (nb + (4 if bf16 else 0)) * 4  # the weight ring, three slots of 16 rows
            assert added == {"fused": max(ring, p_bytes + (words(heads) if bf16 else 0)) - max(ring, p_bytes)}
        else:
            assert added == {"ln": 0, "attention": 2 * 64 * 4 + words(drop.heads_per_block), "rows": 0, "fc1": 0}
    fp32_stage0 = tfb.block_fwd_plan(24, 8, 3, 96, WINDOW, cross, False, True)
    assert fp32_stage0.blocks_per_sm == 3 and dict(fp32_stage0.smem)["fused"] <= tfb.SMEM_THREE_PER_SM


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,hidden", [(24, 4), (96, 384)], ids=["C24-fused", "C96-split"])
def test_a_dropout_call_reaches_swin_k4_fwd_with_its_dropout_arguments(fake_library, c, hidden, dtype, layout):
    """A dropout forward in either layout reaches ``swin_k4_fwd`` once, never the five launches
    of ``csrc/fused_block.cu``, with a pointer to the call's dropout arguments (the keying of
    the layout's TPU kernel: K4's padded windows for the image, K1's window pairs for the
    windows layout, with its attention mode; each site's hash base, threshold and scale, a site
    of rate 0 off), the dropout plan's route, head group and hidden step, the layout's rounding
    flags and on the split route its scratch; it counts once in its dtype's dropout counter and
    nowhere else."""
    d = c // 8
    x, weights = _block_args(c, 8, d, hidden, dtype=dtype)
    xl = _windows(x) if layout == "windows" else x
    before = (tfb.LAUNCHES, tfb.BF16_LAUNCHES, tfb.DROP_LAUNCHES, tfb.BF16_DROP_LAUNCHES)
    out = tfb._launch_fwd(xl, weights, _kw(8, d, layout=layout, drop_rates=(0.1, 0.0, 0.25), drop_seed=9))
    assert out.dtype == dtype and out.shape == xl.shape
    (args,) = fake_library.calls["swin_k4_fwd"]
    assert "swin_fused_block_fwd" not in fake_library.calls
    drop = args[23].contents
    key = tfb.block_keying(layout, HW, WINDOW, True, 8, d, "cpu")
    assert (drop.units, drop.pairs, drop.attn_mode, drop.t_pad) == (key.units, key.pairs, key.attn_mode, key.t_pad)
    assert list(drop.on) == [1, 0, 1, 1] and drop.table != 0
    assert drop.base[0] == hd.site_base(9, hd.SITE_ATTN) and drop.base[3] == hd.site_base(9, hd.SITE_MLP_OUT)
    assert drop.threshold[2] == hd.keep_threshold(0.25) and drop.scale[2] == hd.keep_scale(0.25)
    ops = tfb.rounds_operands(dtype, layout)
    plan = tfb.block_fwd_plan(c, 8, d, hidden, WINDOW, True, ops, True)
    fused = plan.route == "fused"
    # ..., head group, hidden step, fused, shift, cross, windows layout, bf16 I/O, bf16 operands
    assert args[32:40] == (plan.heads_per_block, plan.hidden_chunk, int(fused), 1, 1, int(layout == "windows"),
                           int(dtype == BF16), int(ops))
    assert [a is None for a in args[19:23]] == [fused] * 4
    bf16 = dtype == BF16
    assert (tfb.LAUNCHES, tfb.BF16_LAUNCHES, tfb.DROP_LAUNCHES, tfb.BF16_DROP_LAUNCHES) == (
        before[0], before[1], before[2] + 1 - bf16, before[3] + bf16)


def test_a_dropout_call_on_a_shape_the_plan_does_not_take_raises_before_any_launch(fake_library):
    x, weights = _block_args(24, 8, 3, 98)
    with pytest.raises(ValueError, match="hidden"):
        tfb._launch_fwd(x, weights, _kw(8, 3, drop_rates=(0.1, 0.1, 0.1), drop_seed=3))
    assert not fake_library.calls


# ---- the plain dropout forward against JAX at the split route's geometry ------------------

PARITY = (96, 8, 12, 384, *HW, True, True)  # C, heads, d, hidden, H, W, shift, cross


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(), rtol=1e-4, err_msg=what)


def test_k4_dropout_forward_matches_jax_pallas_block_at_the_split_geometry():
    """K4's plain dropout forward (the image, every site at rate 0.5), which the six launches'
    dropout form reproduces on the card, against ``pallas_fused_block`` in interpret mode with
    the kernel's seed pinned, at C = 96 (the split route), shift and cross, at the tolerances of
    ``test_torch_dropout.py``."""
    x, kw, variables, port = _block_case(PARITY, seed=71)
    assert tfb.block_fwd_plan(96, 8, 12, 384, WINDOW, True, False, True).route == "split"
    with pinned_seed(jpb, "pallas_fused_block", SEED) as calls:
        ref = np.asarray(jax.jit(_jax_block(kw, "pallas_block_interpret"))(variables, jnp.asarray(x)))
    assert calls == [SEED]
    _set_block_rates(port, (0.5, 0.5, 0.5))
    launches = tfb.DROP_LAUNCHES
    with torch.no_grad():
        out = port.fused(torch.from_numpy(x), "image", seed=SEED)
    assert tfb.DROP_LAUNCHES == launches, "the plain version counts no launch"
    _close(out.numpy(), ref, "K4")


def test_k1_dropout_forward_matches_jax_pallas_pack_at_the_split_geometry():
    """K1's plain dropout forward (pack -> window-packed tokens -> unpack, every site at rate
    0.5) against ``pallas_packed_block_strips`` in interpret mode on C-major input with the
    kernel's seed pinned, at C = 96, shift and cross."""
    x, kw, variables, port = _block_case(PARITY, seed=73)
    shift, hw = kw["shift"], x.shape[2:4]
    packed = _jax_block(kw, "pallas_pack_interpret", packed=True)
    cmajor = jax.jit(lambda v, a: jnp.moveaxis(packed(v, jnp.moveaxis(a, -1, 2)), 2, -1))
    with pinned_seed(jpp, "pallas_packed_block_strips", SEED) as calls:
        ref = np.asarray(cmajor(variables, jnp.asarray(x)))
    assert calls == [SEED]
    _set_block_rates(port, (0.5, 0.5, 0.5))
    with torch.no_grad():
        xw = pack_windows(torch.from_numpy(x), WINDOW, shift)
        out = unpack_windows(port.fused(xw, "windows", hw, seed=SEED), hw, WINDOW, shift)
    _close(out.numpy(), ref, "K1")
