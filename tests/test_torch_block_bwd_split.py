"""The arithmetic of the fused block's split backward route (K1 bwd and K4 bwd at stages 2-3,
``csrc/fused_block_bwd.cu``), on the CPU.

The route does not take autograd of the block: it recomputes the forward, runs the MLP and
LN2 backward to g_y, then K3's split backward block on the stored LN1(x) with g_y as its
output gradient, then the LN1 backward of LN1(x)'s gradient, whose q side and k/v side it
keeps apart under cross. ``split_route_plain`` states that decomposition in plain torch
from the port's own plain functions (``fused_block._layer_norm`` / ``_dense``,
``window_attention.window_attention_plain``), and these tests hold it against
``fused_block_bwd_plain`` (autograd of the whole plain block, which the card tests hold the
kernels against) at the default model's stage-2 and stage-3 widths: C = 96 (8 heads of
d = 12, MLP hidden 384 and 192) and C = 192 (d = 24, hidden 768), a 14x14 map, one image per
stream, every shift x cross case, both layouts. fp32 at ``testing.assert_grads_close``'s
tolerances; in bf16 (fp32 inside at the upcast x and g) the weight gradients the same way
and g_x by the rounding rule: rnd(g_y + LN1'(q side) + LN1'(k/v side)) in self mode and
rnd(rnd(g_y + LN1'(q side)) + rnd(LN1'(k/v side))) under cross, bit for bit wherever the two
fp32 sums round alike. Inputs are made with numpy from a seed. About 15 s in one process."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_windows, unpack_windows
from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

WINDOW = (7, 7)
HW = (14, 14)
# (C, heads, d, MLP hidden): stage 2's encoder and decoder blocks, stage 3's encoder block
GEOMETRIES = ((96, 8, 12, 384), (96, 8, 12, 192), (192, 8, 24, 768))
CASES = [(geo, shift, cross) for geo in GEOMETRIES for shift in (False, True) for cross in (False, True)]
IDS = [f"c{g[0]}-h{g[3]}-shift{int(s)}-cross{int(c)}" for g, s, c in CASES]
BF16 = torch.bfloat16


def block_case(c, heads, d, hidden, seed):
    """x (2, 1, 14, 14, C) and the 17 weights, scaled as a trained block's (LN scales near 1,
    He-scaled dense kernels, small biases), and an output gradient, from numpy."""
    rng = np.random.default_rng(seed)
    inner = heads * d

    def rand(*shape, scale=1.0, offset=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + offset).astype(np.float32))

    def dense(i, o):
        return rand(2, i, o, scale=i**-0.5), rand(2, o, scale=0.1)

    x = rand(2, 1, *HW, c)
    weights = (rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
               *dense(c, inner), *dense(c, inner), *dense(c, inner), *dense(inner, c),
               rand(2, 49, 49), rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
               *dense(c, hidden), *dense(hidden, c))
    return x, weights, rand(2, 1, *HW, c)


def _grad(out, inputs, g, retain=False):
    return torch.autograd.grad(out, inputs, g, retain_graph=retain)


def split_route_sides(g, x, weights, *, window, num_heads, dims_per_head, shift, cross):
    """The split route's decomposition on an fp32 image-layout x and g: returns (the q side
    g_y + LN1'(q side of g_ln), the k/v side LN1'(k/v side of g_ln) (zeros in self mode, where
    g_ln is one sum), the 17 weight gradients)."""
    (ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wp, bp, bias, ln2_s, ln2_b, w1, b1, w2, b2) = weights
    att_w = (wq, bq, wk, bk, wv, bv, wp, bp, bias)
    att_kw = dict(window=window, num_heads=num_heads, dims_per_head=dims_per_head, shift=shift, cross=cross)
    with torch.enable_grad():
        # the forward, recomputed: LN1(x), y = x + attention(LN1(x))
        ln1 = tfb._layer_norm(x, ln1_s, ln1_b)
        y = x + twa.window_attention_plain(ln1, *att_w, **att_kw)
        # the MLP and LN2 backward: g_y and the MLP's weight gradients
        yl = y.detach().requires_grad_()
        mlp_w = [a.detach().requires_grad_() for a in (ln2_s, ln2_b, w1, b1, w2, b2)]
        hidden = F.elu(tfb._dense(tfb._layer_norm(yl, mlp_w[0], mlp_w[1]), mlp_w[2], mlp_w[3]))
        g_y, *g_mlp = _grad(yl + tfb._dense(hidden, mlp_w[4], mlp_w[5]), [yl, *mlp_w], g)
        # K3's plain backward on (LN1(x), g_y), LN1(x)'s gradient's q and k/v sides apart
        lq = ln1.detach().requires_grad_()
        lkv = ln1.detach().requires_grad_() if cross else None
        leaves = [a.detach().requires_grad_() for a in att_w]
        att = twa.window_attention_plain(lq, *leaves, kv=lkv, **att_kw)
        if cross:
            g_lnq, g_lnkv, *g_att = _grad(att, [lq, lkv, *leaves], g_y)
        else:
            g_lnq, *g_att = _grad(att, [lq, *leaves], g_y)
        # the LN1 backward of each side
        xl = x.detach().requires_grad_()
        ln_w = [a.detach().requires_grad_() for a in (ln1_s, ln1_b)]
        ln = tfb._layer_norm(xl, *ln_w)
        gxq, gsq, gbq = _grad(ln, [xl, *ln_w], g_lnq, retain=cross)
        if cross:
            gxkv, gskv, gbkv = _grad(ln, [xl, *ln_w], g_lnkv)
        else:
            gxkv, gskv, gbkv = torch.zeros_like(x), torch.zeros_like(gsq), torch.zeros_like(gbq)
    return g_y + gxq, gxkv, (gsq + gskv, gbq + gbkv, *g_att, *g_mlp)


def split_route_plain(g, x, *weights, window, num_heads, dims_per_head, shift, cross, layout, hw=None, **_):
    """(g_x, the 17 weight gradients) of the block as the split route computes them, for x
    and g in ``layout`` and either dtype: fp32 inside at the upcast x and g, g_x rounded to
    x's dtype by the rule of the module docstring."""
    if layout == "windows":
        xi, gi = (unpack_windows(a.float(), hw, window, shift) for a in (x, g))
    else:
        xi, gi = x.float(), g.float()
    q, kv, wgrads = split_route_sides(gi, xi, weights, window=window, num_heads=num_heads,
                                      dims_per_head=dims_per_head, shift=shift, cross=cross)
    if x.dtype == BF16 and cross:
        gx = (q.to(BF16).float() + kv.to(BF16).float()).to(BF16)
    else:
        gx = (q + kv).to(x.dtype)
    if layout == "windows":
        gx = pack_windows(gx, window, shift)
    return (gx, *wgrads)


def _args(geo, shift, cross, layout, dtype, seed):
    c, heads, d, hidden = geo
    x, weights, g = block_case(c, heads, d, hidden, seed)
    if layout == "windows":
        x, g = pack_windows(x, WINDOW, shift), pack_windows(g, WINDOW, shift)
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross, layout=layout, hw=HW)
    return x.to(dtype), weights, g.to(dtype), kw


def test_the_geometries_take_the_split_route():
    """The three geometries are the ones the split route serves (at any map size)."""
    for c, heads, d, hidden in GEOMETRIES:
        for cross in (False, True):
            assert tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross).route == "split"


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("geo,shift,cross", CASES, ids=IDS)
def test_split_decomposition_matches_the_plain_backward_fp32(geo, shift, cross, layout):
    x, weights, g, kw = _args(geo, shift, cross, layout, torch.float32, seed=50 + geo[3] + 2 * shift + cross)
    got = split_route_plain(g, x, *weights, **kw)
    ref = tfb.fused_block_bwd_plain(g, x, *weights, **kw)
    assert got[0].shape == x.shape and got[0].dtype == torch.float32
    assert_grads_close(got, ref, ("x", *tfb.WEIGHT_NAMES), f"{geo} {layout} shift={shift} cross={cross}")


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("geo,shift,cross", CASES, ids=IDS)
def test_split_decomposition_matches_the_plain_backward_bf16(geo, shift, cross, layout):
    """bf16: the weight gradients as in fp32; g_x in bf16, rounded once in self mode and under
    cross its two sides rounded apart and added in bf16. The decomposition's fp32 sums and the
    plain backward's agree to fp32 rounding, so g_x is bit-equal to the plain backward's
    wherever those sums round to the same bf16 value (all but 0.003-0.008% of the elements
    here), and elsewhere one bf16 ulp away (two under cross, one a side), plus, where the sum
    cancels to near 0, fp32 noise of 2^-20 of g_x's largest magnitude."""
    x, weights, g, kw = _args(geo, shift, cross, layout, BF16, seed=70 + geo[3] + 2 * shift + cross)
    got = split_route_plain(g, x, *weights, **kw)
    ref = tfb.fused_block_bwd_plain(g, x, *weights, **kw)
    what = f"{geo} {layout} shift={shift} cross={cross}"
    assert got[0].dtype == BF16 == ref[0].dtype
    assert_grads_close(got[1:], ref[1:], tfb.WEIGHT_NAMES, what)
    a, b = got[0].float(), ref[0].float()
    differ = a != b
    ulp = torch.maximum(a.abs(), b.abs()).clamp_min(2.0**-126)
    ulp = 2.0 ** (torch.floor(torch.log2(ulp)) - 7)  # one bf16 ulp at the larger magnitude
    limit = (2 * ulp if cross else ulp) + 2.0**-20 * float(b.abs().max())
    assert bool(((a - b).abs() <= limit).all()), what
    assert float(differ.float().mean()) < 1e-3, what
