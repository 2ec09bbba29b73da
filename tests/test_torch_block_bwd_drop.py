"""The dropout form of the fused block's redesigned backward routes (K1 bwd and K4 bwd with
dropout: the fused route of ``csrc/fused_block_bwd.cu`` at stages 0-1, the split route of
``csrc/fused_block_bwd_split.cu`` at stages 2-3), on the CPU.

Both routes mask the same gradients in the same order, only where the attention's inputs come
from differs (the fused route stores q/k/v and AV in its recompute, the split route's K3 block
recomputes them from the stored LN1(x)). ``drop_route_plain`` states that sequence in plain
torch, with the masks of ``ops/dropout_layout.py`` (``token_keep``, ``attention_keep``):

- the recompute masks p before AV and proj + bp before the residual (so y and LN2(y) are the
  forward's) and keeps the ELU hidden h undropped;
- the MLP backward takes g_m = drop(g): g_pre = drop(g_m w2^T) ELU'(h), w2's gradient from
  the dropped h and g_m, b2's from g_m;
- g_y = g + LN2'(g_lny) takes the *undropped* g;
- the attention takes g_proj = drop(g_y) (wp's and bp's gradients, g_o = g_proj wp^T); its
  core gives g_v = drop(p)^T g_o and g_s = p (g_p - sum g_p p) with g_p = drop(g_o v^T);
- g_x = g_y + LN1'(g_ln) takes the *undropped* g_y; under cross the q side and the k/v side of
  g_ln apart.

These tests hold it against ``fused_block_bwd_plain`` (autograd of the plain dropout block,
which the card tests hold the kernels against) at rates 0.1 and 0.5 (at 0.5 a wrong mask cannot
hide) at every width the routes take in the default model (C = 24, 48, 96, 192), both layouts,
every shift x cross case, fp32 at ``testing.assert_grads_close``'s tolerances and bf16 (fp32
inside at the upcast x and g) by ``test_torch_block_bwd_split.py``'s rounding rule. They also
hold the launch plan of the dropout form with a fake library: which library a dropout call
reaches at each stage, that it hands the kernels its dropout arguments, the counters, and that
the plan's shared memory and workspace count the masks' pieces. Inputs are made with numpy
from a seed."""

import pytest
import torch
import torch.nn.functional as F

from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops.window import device_constant
from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_windows, unpack_windows
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
from test_torch_block_bwd_plan import _block_args, _kw, fake_library  # noqa: F401 (a fixture)
from test_torch_block_bwd_split import HW, block_case
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WINDOW = (7, 7)
BF16 = torch.bfloat16
SEED = 3_141_593  # < 2^24
# (C, heads, d, MLP hidden): the default model's stage 0-3 encoder blocks (stages 0-1 the fused
# route, 2-3 the split route)
GEOMETRIES = ((24, 8, 3, 96), (48, 8, 6, 192), (96, 8, 12, 384), (192, 8, 24, 768))
CASES = [(geo, shift, cross, rate) for geo in GEOMETRIES for shift in (False, True) for cross in (False, True)
         for rate in (0.1, 0.5)]
IDS = [f"c{g[0]}-shift{int(s)}-cross{int(c)}-rate{r}" for g, s, c, r in CASES]


def _mm_t(a, w):
    """Per-stream product with w transposed: (S, ..., N) @ (S, K, N)^T."""
    s, k, n = w.shape
    return (a.reshape(s, -1, n) @ w.transpose(1, 2)).reshape(*a.shape[:-1], k)


def _wgrad(a, b):
    """[A | 1]^T B per stream: the weight's (S, K, N) and the bias's (S, N) gradients."""
    s = a.shape[0]
    a2, b2 = a.reshape(s, -1, a.shape[-1]), b.reshape(s, -1, b.shape[-1])
    return a2.transpose(1, 2) @ b2, b2.sum(1)


def _ln_grads(x, scale, bias, g):
    """(x's, the scale's, the bias's) gradient of LayerNorm for the output gradient g."""
    with torch.enable_grad():
        leaves = [a.detach().requires_grad_() for a in (x, scale, bias)]
        return torch.autograd.grad(tfb._layer_norm(*leaves), leaves, g)


def drop_route_sides(gw, xw, weights, *, hw, num_heads, dims_per_head, shift, cross, rates, seed, key):
    """The routes' dropout backward on fp32 window-packed tokens (S, B, nWin, 49, C) of the
    block's geometry: (the q side g_y + LN1'(q side of g_ln), the k/v side LN1'(k/v side)
    (zeros in self mode, where g_ln is one sum), the 17 weight gradients)."""
    (ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2_s, ln2_b, w1, b1, w2, b2) = weights
    s, b, n_win, t, c = xw.shape
    heads, d = num_heads, dims_per_head
    hidden = w1.shape[-1]
    rate_a, rate_p, rate_m = rates
    table = dl.windows_table(key)

    def token_mask(site, rate, cols):
        return dl.token_keep(seed, site, rate, key, s, b, cols, table).reshape(s, b, n_win, t, cols)

    def drop(a, keep, rate):
        return a if not rate else hd.apply_mask(a, keep, rate)

    def split_heads(a):  # (S, B, nWin, T, inner) -> (S, B, nWin, heads, T, d)
        return a.reshape(s, b, n_win, t, heads, d).transpose(3, 4)

    def join_heads(a):
        return a.transpose(3, 4).reshape(s, b, n_win, t, heads * d)

    # the recompute: masked p and proj, the undropped hidden
    ln1 = tfb._layer_norm(xw, ln1_s, ln1_b)
    kv = ln1.flip(0) if cross else ln1
    q = split_heads(tfb._dense(ln1, wq, bq)) * d**-0.5
    k = split_heads(tfb._dense(kv, wk, bk))
    v = split_heads(tfb._dense(kv, wv, bv))
    scores = q @ k.transpose(-1, -2) + bias[:, None, None, None]
    if shift:
        mask = device_constant(tfb.wrap_region_mask, (tuple(hw), WINDOW), xw.device)
        scores = scores.masked_fill(mask[:, None], -1e10)
    p = twa.fast_softmax(scores)
    keep_a = dl.attention_keep(seed, rate_a, key, table, s, b, heads) if rate_a else None
    p_use = drop(p, keep_a, rate_a)
    av = join_heads(p_use @ v)
    keep_p = token_mask(hd.SITE_PROJ, rate_p, c) if rate_p else None
    y = xw + drop(tfb._dense(av, wp, bp), keep_p, rate_p)
    ln2 = tfb._layer_norm(y, ln2_s, ln2_b)
    h = F.elu(tfb._dense(ln2, w1, b1))
    keep_h = token_mask(hd.SITE_MLP_HIDDEN, rate_m, hidden) if rate_m else None
    keep_o = token_mask(hd.SITE_MLP_OUT, rate_m, c) if rate_m else None

    # the MLP backward on g_m = drop(g); w2's gradient from the dropped hidden
    g_m = drop(gw, keep_o, rate_m)
    g_pre = drop(_mm_t(g_m, w2), keep_h, rate_m) * torch.where(h > 0, torch.ones_like(h), h + 1.0)
    g_w2, g_b2 = _wgrad(drop(h, keep_h, rate_m), g_m)
    g_w1, g_b1 = _wgrad(ln2, g_pre)
    g_lny = _mm_t(g_pre, w1)
    g_y_ln, g_ln2s, g_ln2b = _ln_grads(y, ln2_s, ln2_b, g_lny)
    g_y = gw + g_y_ln  # the residual: the undropped g

    # the attention's backward on g_proj = drop(g_y)
    g_proj = drop(g_y, keep_p, rate_p)
    g_wp, g_bp = _wgrad(av, g_proj)
    g_o = split_heads(_mm_t(g_proj, wp))
    g_v = p_use.transpose(-1, -2) @ g_o
    g_p = drop(g_o @ v.transpose(-1, -2), keep_a, rate_a)
    g_s = p * (g_p - (g_p * p).sum(-1, keepdim=True))
    g_bias = g_s.sum(dim=(1, 2, 3))
    g_q = join_heads(g_s @ k) * d**-0.5
    g_k = join_heads(g_s.transpose(-1, -2) @ q)
    g_v = join_heads(g_v)
    g_wq, g_bq = _wgrad(ln1, g_q)
    g_wk, g_bk = _wgrad(kv, g_k)
    g_wv, g_bv = _wgrad(kv, g_v)
    g_lnq = _mm_t(g_q, wq)
    g_lnkv = _mm_t(g_k, wk) + _mm_t(g_v, wv)
    g_lnkv = g_lnkv.flip(0) if cross else g_lnkv  # to the rows k/v were made from

    # the LN1 backward: the residual takes the undropped g_y
    if cross:
        gxq, gsq, gbq = _ln_grads(xw, ln1_s, ln1_b, g_lnq)
        gxkv, gskv, gbkv = _ln_grads(xw, ln1_s, ln1_b, g_lnkv)
        g_ln1s, g_ln1b = gsq + gskv, gbq + gbkv
    else:
        gxq, g_ln1s, g_ln1b = _ln_grads(xw, ln1_s, ln1_b, g_lnq + g_lnkv)
        gxkv = torch.zeros_like(gxq)
    return g_y + gxq, gxkv, (g_ln1s, g_ln1b, g_wq, g_bq, g_wk, g_bk, g_wv, g_bv, g_wp, g_bp, g_bias,
                             g_ln2s, g_ln2b, g_w1, g_b1, g_w2, g_b2)


def drop_route_plain(g, x, *weights, window, num_heads, dims_per_head, shift, cross, layout, hw=None,
                     drop_rates, drop_seed, sides=False, **_):
    """(g_x, the 17 weight gradients) of the dropout block as both routes compute them, for x
    and g in ``layout`` and either dtype: fp32 inside at the upcast x and g, g_x rounded to x's
    dtype as ``test_torch_block_bwd_split.split_route_plain`` rounds it. ``sides``: return the
    fp32 q side and k/v side of g_x (in x's layout) instead."""
    h, w = tuple(x.shape[2:4]) if layout == "image" else hw
    key = tfb.block_keying(layout, (h, w), window, shift, num_heads, dims_per_head, x.device)
    if layout == "image":
        xw, gw = (pack_windows(a.float(), window, shift) for a in (x, g))
    else:
        xw, gw = x.float(), g.float()
    q, kv, wgrads = drop_route_sides(gw, xw, weights, hw=(h, w), num_heads=num_heads, dims_per_head=dims_per_head,
                                     shift=shift, cross=cross, rates=drop_rates, seed=drop_seed, key=key)
    if layout == "image":
        q, kv = (unpack_windows(a, (h, w), window, shift) for a in (q, kv))
    if sides:
        return q, kv
    if x.dtype == BF16 and cross:
        gx = (q.to(BF16).float() + kv.to(BF16).float()).to(BF16)
    else:
        gx = (q + kv).to(x.dtype)
    return (gx, *wgrads)


def _args(geo, shift, cross, rate, layout, dtype, seed):
    c, heads, d, hidden = geo
    x, weights, g = block_case(c, heads, d, hidden, seed)
    if layout == "windows":
        x, g = pack_windows(x, WINDOW, shift), pack_windows(g, WINDOW, shift)
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross, layout=layout, hw=HW,
              drop_rates=(rate, rate, rate), drop_seed=SEED + c)
    return x.to(dtype), weights, g.to(dtype), kw


def test_the_geometries_take_the_dropout_form_of_both_routes():
    """Stages 0-1 take the fused route's dropout form, stages 2-3 the split route's."""
    for c, heads, d, hidden in GEOMETRIES:
        for cross in (False, True):
            plan = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, True)
            assert plan.route == ("fused" if c <= 48 else "split")


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("geo,shift,cross,rate", CASES, ids=IDS)
def test_dropout_decomposition_matches_the_plain_backward_fp32(geo, shift, cross, rate, layout):
    x, weights, g, kw = _args(geo, shift, cross, rate, layout, torch.float32, seed=90 + geo[3] + 2 * shift + cross)
    got = drop_route_plain(g, x, *weights, **kw)
    ref = tfb.fused_block_bwd_plain(g, x, *weights, **kw)
    assert got[0].shape == x.shape and got[0].dtype == torch.float32
    assert_grads_close(got, ref, ("x", *tfb.WEIGHT_NAMES), f"{geo} {layout} shift={shift} cross={cross} rate={rate}")


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("geo,shift,cross,rate", CASES, ids=IDS)
def test_dropout_decomposition_matches_the_plain_backward_bf16(geo, shift, cross, rate, layout):
    """bf16: the weight gradients as in fp32; g_x in bf16 by the split route's rounding rule
    (``test_torch_block_bwd_split.py``): bit-equal where the two fp32 sums round alike, else one
    bf16 ulp away; under cross one ulp of each side's own magnitude (the sides are rounded
    apart, and where they cancel an ulp of a side is many of the sum's) and one of the sum's;
    plus fp32 noise of 2^-20 of g_x's largest."""
    x, weights, g, kw = _args(geo, shift, cross, rate, layout, BF16, seed=110 + geo[3] + 2 * shift + cross)
    got = drop_route_plain(g, x, *weights, **kw)
    ref = tfb.fused_block_bwd_plain(g, x, *weights, **kw)
    what = f"{geo} {layout} shift={shift} cross={cross} rate={rate}"
    assert got[0].dtype == BF16 == ref[0].dtype
    assert_grads_close(got[1:], ref[1:], tfb.WEIGHT_NAMES, what)
    a, b = got[0].float(), ref[0].float()

    def ulp(*values):  # one bf16 ulp at the largest magnitude
        return 2.0 ** (torch.floor(torch.log2(torch.stack([v.abs() for v in values]).amax(0).clamp_min(2.0**-126))) - 7)

    if cross:
        q, kv = drop_route_plain(g, x, *weights, sides=True, **kw)
        limit = ulp(q) + ulp(kv) + ulp(a, b)  # each side's rounding, then the sum's
    else:
        limit = ulp(a, b)
    limit = limit + 2.0**-20 * float(b.abs().max())
    assert bool(((a - b).abs() <= limit).all()), what
    assert float((a != b).float().mean()) < 1e-3, what


# ---- the dropout form's launch plan, with a fake library ---------------------------------


# (stage, C, d, hidden, the library function the dropout call reaches, the drop pointer's index)
STAGES = ((0, 24, 3, 96, "swin_block_bwd", 4), (1, 48, 6, 192, "swin_block_bwd", 4),
          (2, 96, 12, 384, "swin_block_bwd_split", 4), (3, 192, 24, 768, "swin_block_bwd_split", 4),
          (4, 384, 48, 1536, "swin_block_bwd_split", 4))
FUNCTIONS = ("swin_block_bwd", "swin_block_bwd_split", "swin_fused_block_bwd")


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("stage,c,d,hidden,function,at", STAGES, ids=[f"stage{s[0]}" for s in STAGES])
def test_a_dropout_call_reaches_its_route_with_its_dropout_arguments(fake_library, stage, c, d, hidden, function,
                                                                     at, dtype, layout):
    """A dropout call at stages 0-1 reaches ``swin_block_bwd`` (the fused route's dropout form),
    at stages 2-4 ``swin_block_bwd_split`` (the split route's; never ``swin_fused_block_bwd``,
    the twenty launches), each once with a non-null pointer to the call's dropout arguments (the
    keying of the layout's TPU kernel, each site's hash base, threshold and scale, a site of
    rate 0 off) and the workspace that the plan sizes with the dropout pieces; the call counts
    once in its dtype's dropout counter and nowhere else."""
    x, weights = _block_args(c, 8, d, hidden, dtype, layout)
    kw = _kw(d, layout, drop_rates=(0.1, 0.0, 0.25), drop_seed=9)
    before = (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES)
    grads = tfb._launch_bwd(torch.zeros_like(x), x, weights, kw)
    assert grads[0].dtype == dtype and all(t.dtype == torch.float32 for t in grads[1:])
    assert [name for name in FUNCTIONS if name in fake_library.calls] == [function]
    (args,) = fake_library.calls[function]
    drop = args[at].contents
    assert list(drop.on) == [1, 0, 1, 1] and drop.table != 0
    assert drop.pairs == int(layout == "windows")
    assert drop.base[0] == hd.site_base(9, hd.SITE_ATTN) and drop.base[3] == hd.site_base(9, hd.SITE_MLP_OUT)
    assert drop.threshold[2] == hd.keep_threshold(0.25) and drop.scale[2] == hd.keep_scale(0.25)
    key = tfb.block_keying(layout, HW, WINDOW, True, 8, d, "cpu")
    assert drop.units == key.units and drop.attn_mode == key.attn_mode
    plan = tfb.block_bwd_plan(c, 8, d, hidden, WINDOW, True, True)
    blocks = plan.blocks(2, 1, *HW)
    sizes = (tfb.bwd_workspace_floats(2, 1, *HW, c, 8, d, hidden, blocks, True, True) if stage < 2 else
             tfb.split_workspace_floats(2, 1, *HW, c, 8, d, hidden, plan, blocks, True))
    assert args[3] == sizes
    bf16 = dtype == BF16
    assert (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES) == (
        before[0], before[1], before[2] + 1 - bf16, before[3] + bf16)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_the_plan_counts_the_masks_shared_memory(cross):
    """The dropout form's blocks add to their shared memory: the fused route's forward the
    tokens' unit hashes at the attention and proj sites and their slots (3 x 64 x 4 bytes) and
    every head's keep words (8 heads x 49 rows x 2 words x 4 bytes), its MLP backward the unit
    hashes at three sites and the slots (4 x 64 x 4), its attention backward nothing (the keep
    words lie over the row buffer, dead during the core: stage 1 keeps two blocks an SM); the
    split route's recomputed attention the hashes and slots (2 x 64 x 4) and its group's keep
    words, its MLP backward the hashes (4 x 64 x 4), K3's block its group's keep words, the
    stepped MLP backward's LN2 epilogue the proj site's hashes and slots (2 x 64 x 4), the
    rest nothing. Every route keeps its launches and blocks an SM."""
    words = lambda heads: heads * 49 * 2 * 4
    for c, heads, d, hidden in GEOMETRIES:
        plain = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross)
        drop = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, True)
        assert (drop.route, drop.launches, drop.blocks_per_sm, drop.heads_per_block) == (
            plain.route, plain.launches, plain.blocks_per_sm, plain.heads_per_block)
        added = {kind: b - dict(plain.smem)[kind] for kind, b in drop.smem}
        if drop.route == "fused":
            assert added == {"forward": 3 * 64 * 4 + words(heads), "mlp": 4 * 64 * 4, "attention": 0}
        else:
            hg_fwd, hg_bwd = drop.heads_per_block
            assert added == {"attention": 2 * 64 * 4 + words(hg_fwd), "rows": 0, "fc1": 0, "mlp": 4 * 64 * 4,
                             "attention_bwd": words(hg_bwd), "gln": 0, "ln2": 2 * 64 * 4, "ln1": 0}


def test_the_workspace_counts_the_masks_buffers():
    """The dropout form's workspace adds g_m and g_proj of every token (C floats each) and the
    keep words of every (image, window, head) (98 words a window and head), each rounded up to
    32 floats: at stage 0 of a 224² batch-20 step, ~50 MB and ~16 MB a call."""
    m = 20 * 112 * 112
    plan = tfb.block_bwd_plan(24, 8, 3, 96, WINDOW, True, True)
    blocks = plan.blocks(2, 20, 112, 112)
    added = (tfb.bwd_workspace_floats(2, 20, 112, 112, 24, 8, 3, 96, blocks, True, True)
             - tfb.bwd_workspace_floats(2, 20, 112, 112, 24, 8, 3, 96, blocks, True))
    assert added == 2 * (2 * m * 24) + 2 * 20 * 256 * 8 * 98
    plan = tfb.block_bwd_plan(96, 8, 12, 384, WINDOW, False, True)
    blocks = plan.blocks(2, 20, 28, 28)
    added = (tfb.split_workspace_floats(2, 20, 28, 28, 96, 8, 12, 384, plan, blocks, True)
             - tfb.split_workspace_floats(2, 20, 28, 28, 96, 8, 12, 384, plan, blocks))
    assert added == 2 * (2 * 20 * 28 * 28 * 96) + 2 * 20 * 16 * 8 * 98
