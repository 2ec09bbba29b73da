"""K3 at windows other than 7x7 (``csrc/window_attention_fwd_any.cu`` and ``_bwd_any.cu``, the
any-window build of the window-attention kernels), on the CPU.

A window of T <= 64 tokens other than 7x7 runs the any-window build: T, wh and ww at run time,
64 rows a block (eight fp32 row groups of 8 x 8 register tiles, A rows pitched 68 floats; the
backward's rows pass 16 keys a lane, the tiled core's P rows pitched 65). These tests hold the
launch plans, ``fwd_plan`` and ``bwd_plan``, at 8x8, 4x4 and 7x8 windows and every stage of the
default model, against a transcription of the any-window build's layout arithmetic bound as a
fake library's ``swin_k3_fwd_smem``, ``swin_k3_bwd_smem`` and ``swin_k3_bwd_workspace``; that a
window of more than 64 tokens raises; that a call at 8x8 reaches ``swin_k3_fwd`` and
``swin_k3_bwd`` of the any-window libraries with its window, never the three-launch library;
and the plain K3 (what the kernels are held against on the card), forward and gradients,
against the JAX package's ``pallas_window_attention`` in interpret mode and its VJP at those
windows, the dropout forward at 8x8 with the kernel's seed pinned. Inputs are made with numpy
from a seed. About a minute in one process."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables_like, variables_from_jax
from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_to_jax
from swin_unet_image_fusion_tpu_torch.models.layers import DualWindowAttention
from swin_unet_image_fusion_tpu_torch.ops import _build
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from test_torch_attention import JaxAttention
from test_torch_dropout import pinned_seed
from test_torch_k3_plan import _FakeFunction, fake_library  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL, RTOL = 2e-5, 1e-4  # test_torch_attention.py's
WINDOWS = ((8, 8), (4, 4), (7, 8))
WINDOW_IDS = ["8x8", "4x4", "7x8"]
STAGE_C = (24, 48, 96, 192, 384)  # the default model's stages: 8 heads of d = C / 8
HEADS = 8
SEED = 9_437_189  # < 2^24


def _align16(v):
    return -(-v // 16) * 16


def _round_up(v, m):
    return -(-v // m) * m


# ---- the any-window build's layouts, transcribed line by line ---------------------------------
# window_fwd.cuh with SWIN_ANY_WINDOW: kT = 64, kRowGroups = 8, kPitchF = 68, kTileN = 8; the rest
# as the 7x7 build (256 threads, kRowsB = 64, kKc = 16, kStrideB = 24, kPStride = 72, kColTable =
# 192, three-deep rings, six-deep in the projection); window_bwd.cuh: kMaxCols = 144, kPP = 65.
PITCH_F, ROW_GROUPS, TILE_N, PP = 68, 8, 8, 65


def _f32_tiles(nb):
    return ROW_GROUPS * (nb // TILE_N)


def _takes_window(wh, ww):
    return wh >= 1 and ww >= 1 and wh * ww <= 64


def source_fwd_smem(bf16, fused, cross, c, inner, heads, d, hg, proj, drop, wh, ww):
    """``swin_k3_fwd_smem`` of ``csrc/window_attention_fwd.cu`` in the any-window build:
    ``takes_window`` and ``supported``, then ``proj_layout`` or ``attention_layout`` (t = wh * ww)
    + ``drop_attention_bytes(hg, bf16, t)``; 0 where the kernels do not take the shape."""
    t = wh * ww
    dp = next((p for p in (4, 8, 12, 16, 24, 32, 48) if d <= p), 0)
    n, cols = hg * d, 3 * 8 * 8
    if not _takes_window(wh, ww) or dp == 0 or hg < 1 or heads % hg or (fused and hg != heads):
        return 0
    if c % 8 or inner % 8 or inner != heads * d or n % 8 or 3 * n > cols or _f32_tiles(3 * n) > 256:
        return 0
    if fused and (c > cols or _f32_tiles(c) > 256):
        return 0
    if proj:
        ring = 6 * (64 * 24 * 2 if bf16 else 16 * PITCH_F * 4) + 6 * 16 * ((48 + 4) if bf16 else 48) * 4
        return _align16(ring) + _align16(2 * 64 * 4)
    parts, ki = (2 if cross else 1), _round_up(inner, 16)
    p_bytes = 8 * 32 * 72 * 2 if bf16 else 0
    wp_bytes = ki * (c + 4 if bf16 else c) * 4 if fused else 0
    ring = 3 * parts * (64 * 24 * 2 if bf16 else 16 * PITCH_F * 4) + 3 * 16 * (3 * n + (4 if bf16 else 0)) * 4
    off = _align16(max(ring, p_bytes + wp_bytes))
    off += 2 * _align16(hg * t * dp * 4)  # q, k
    off += _align16(hg * _round_up(d, 8) * 72 * 2 if bf16 else hg * t * dp * 4)  # v (bf16: v^T)
    if fused:
        off += _align16(64 * (ki + 8) * 2 if bf16 else ki * PITCH_F * 4)  # AV
    off += _align16(t * t * 4) + _align16((2 * 64 + 3 * 192) * 4)  # bias table; rows, columns, biases
    if drop:
        off += _align16(2 * 64 * 4) + (_align16(hg * t * 2 * 4) if bf16 else 0)
    return off


def _bwd_pitch(d, fused):
    if fused:
        return 4 if d <= 4 else 8 if d <= 8 else 0
    return next((p for p in (4, 8, 12, 16, 24, 32, 48) if d <= p), 0)


def _gx_width(c):
    groups = -(-c // 144)
    return _round_up(-(-c // groups), 4)


def _gx_layout(width, t):
    rowbuf = _align16(2 * 16 * PITCH_F * 4 + 2 * 16 * width * 4)
    return rowbuf + _align16(t * width * 4) + _align16(64 * 4)


def _bwd_layout(fused, cross, c, inner, hg, d, dp, drop, t):
    n = hg * d
    qkv = _align16(hg * t * dp * 4)
    ring = 2 * (2 if cross else 1) * 16 * PITCH_F * 4 + 2 * 16 * 3 * n * 4
    off = _align16(max(ring, _round_up(3 * inner, 16) * PITCH_F * 4 if fused else 0))
    off += max(4 * qkv, _align16(2 * 16 * c * 4) + _align16(t * c * 4) if fused else 0)
    off += _align16(hg * t * 8) + _align16(t * t * 4) + _align16((3 * 64 + 2 * 192) * 4)
    if drop:
        off += _align16(hg * t * 2 * 4)
    if dp > 24:
        off += _align16(2 * 64 * PP * 4)  # the tiled core's P and g_S, 64 rows each
    return off


def source_bwd_smem(kind, fused, cross, c, heads, d, hg, drop, wh, ww):
    """``swin_k3_bwd_smem`` of ``csrc/window_attention_bwd.cu`` in the any-window build:
    ``takes_window`` and ``supported``, then ``bwd_layout`` (kind 0) or ``gx_layout`` (kind 1) at
    t = wh * ww; 0 where the route does not take the shape."""
    inner, n, t = heads * d, hg * d, wh * ww
    dp = _bwd_pitch(d, fused)
    if kind not in (0, 1) or not _takes_window(wh, ww) or dp == 0 or hg < 1 or heads % hg or c % 8 or inner % 8:
        return 0
    if n % 8 or 3 * n > 144 or (fused and (hg != heads or c > 144)):
        return 0
    block = _bwd_layout(fused, cross, c, inner, hg, d, dp, drop, t)
    gx = _gx_layout(_gx_width(c), t)
    if max(block, gx) > 232_448:
        return 0
    return gx if kind == 1 else block


def source_bwd_workspace(s, b, h, w, c, heads, d, hg, fused, blocks, cross, wh, ww):
    """``swin_k3_bwd_workspace``: ``carve``'s pieces, each rounded up to 32 floats: wp^T and
    [wq | wk | wv]^T, AV, g_q, g_k, g_v, under the fused route's cross g_x's two sides, the T x T
    bias-table partials of every block, the weight gradients' chunks (``wg_chunk_rows``)."""
    inner, m, t = heads * d, b * h * w, wh * ww

    def wg_groups(ka, nb):
        ta, tb = (ka + 4) // 4, (nb + 3) // 4
        if ta > 16 and tb > 16:
            return -(-ta // 16) * -(-tb // 16)
        return -(-(ta * tb) // 256)

    jobs = 4 * s * max(wg_groups(c, inner), wg_groups(inner, c))
    slabs = -(-m // 64)
    chunks = max(1, min(slabs, 132 * 8 // jobs))
    chunk_rows = _round_up(-(-m // chunks), 64)
    chunks = -(-m // chunk_rows)
    pieces = [s * c * inner, s * 3 * inner * c] + [s * m * inner] * 4
    pieces += [s * m * c] * 2 if fused and cross else []
    pieces += [s * (heads // hg) * blocks * t * t, s * chunks * (3 * (c + 1) * inner + (inner + 1) * c)]
    return sum(_round_up(p, 32) for p in pieces)


class _Source(_FakeFunction):
    def __init__(self, calls, name, fn):
        super().__init__(calls, name)
        self.fn = fn

    def __call__(self, *args):
        super().__call__(*args)
        return self.fn(*args)


def _bind_sources(lib):
    for name, fn in (("swin_k3_fwd_smem", source_fwd_smem), ("swin_k3_bwd_smem", source_bwd_smem),
                     ("swin_k3_bwd_workspace", source_bwd_workspace)):
        setattr(lib, name, _Source(lib.calls, name, fn))


# the routes the plans give (fwd fp32, fwd bf16, fwd fp32 drop, fwd bf16 drop, bwd) at each
# stage under cross: 8x8 moves stage 1's forward to the split route but for its bf16 form without
# dropout (the 64-row blocks outgrow two an SM), and keeps every backward route
CROSS_ROUTES = {
    (8, 8): ("FFFFf", "SFSSf", "SSSSs", "SSSSs", "SSSSs"),
    (4, 4): ("FFFFf", "FFFFf", "SSSSs", "SSSSs", "SSSSs"),
    (7, 8): ("FFFFf", "SFSFf", "SSSSs", "SSSSs", "SSSSs"),
}


@pytest.mark.parametrize("window", WINDOWS, ids=WINDOW_IDS)
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("c", STAGE_C, ids=[f"C{c}" for c in STAGE_C])
def test_plans_match_the_any_window_source(fake_library, window, c, drop, bf16, cross):
    """``fwd_plan`` and ``bwd_plan`` at every stage of the default model: the any-window
    library, every block's shared memory (the attention block, the projection block, the
    backward's block and g_x kernel) and the backward's workspace at a 224² batch-20 stage map
    are the source's layout arithmetic at the window's T; every block within what a block may
    use, a one-launch forward within two an SM; the routes under cross as CROSS_ROUTES pins."""
    d = c // HEADS
    _bind_sources(fake_library)
    fwd = twa.fwd_plan(c, HEADS, d, window, cross, bf16, drop)
    bwd = twa.bwd_plan(c, HEADS, d, window, cross, bf16, drop)
    assert twa.window_class(window).build == "_any" and bwd.window == window
    flib, blib = twa._fwd_library("_any"), twa._bwd_library(twa.window_class(window).bwd_build(drop))
    args = (int(bf16), int(fwd.route == "fused"), int(cross), c, HEADS * d, HEADS, d, fwd.heads_per_block)
    assert flib.swin_k3_fwd_smem(*args, 0, int(drop), *window) == fwd.smem <= twa.SMEM_LIMIT_BYTES
    if fwd.route == "fused":
        assert fwd.smem <= twa.FUSED_SMEM_MAX and fwd.proj_smem == 0 and fwd.launches == 1
    else:
        assert flib.swin_k3_fwd_smem(*args, 1, int(drop), *window) == fwd.proj_smem and fwd.launches == 2
    fused, hg = int(bwd.route == "fused"), bwd.heads_per_block
    for kind, (_, smem) in enumerate(bwd.smem):
        assert blib.swin_k3_bwd_smem(kind, fused, int(cross), c, HEADS, d, hg, int(drop), *window) == smem
        assert 0 < smem <= twa.SMEM_LIMIT_BYTES
    k = STAGE_C.index(c)
    h = w = 112 // 2**k
    h, w = _round_up(h, window[0]), _round_up(w, window[1])
    blocks = bwd.blocks(2, 20, h, w, HEADS)
    assert 1 <= blocks <= 20 * (h // window[0]) * (w // window[1])
    assert blib.swin_k3_bwd_workspace(2, 20, h, w, c, HEADS, d, hg, fused, blocks, int(cross), *window) == \
        twa.bwd_workspace_floats(2, 20, h, w, c, HEADS, d, bwd, blocks, cross)
    if cross:
        routes = CROSS_ROUTES[window][k]
        got = "".join("F" if p.route == "fused" else "S" for p in (
            twa.fwd_plan(c, HEADS, d, window, True, False), twa.fwd_plan(c, HEADS, d, window, True, True),
            twa.fwd_plan(c, HEADS, d, window, True, False, True), twa.fwd_plan(c, HEADS, d, window, True, True, True)))
        assert got + bwd.route[0] == routes


def test_the_tightest_blocks_at_8x8():
    """Stage 1 under cross at 8x8: the one-launch block of 64 rows (fp32 135,168 bytes; bf16
    with dropout 119,808) outgrows two an SM (115,712 bytes each) and the forward takes the
    split route with every head in a group (fp32 122,112 bytes); the bf16 block without dropout
    (115,200) still fits. The backward keeps its fused route, one block an SM (127,488 bytes)."""
    fp32 = twa.fwd_plan(48, 8, 6, (8, 8), True, False)
    assert twa.attention_smem(False, True, True, 48, 48, 8, 6, 8, window=(8, 8)) == 135_168
    assert twa.attention_smem(True, True, True, 48, 48, 8, 6, 8, True, (8, 8)) == 119_808
    assert (fp32.route, fp32.heads_per_block, fp32.smem) == ("split", 8, 122_112)
    bf16 = twa.fwd_plan(48, 8, 6, (8, 8), True, True)
    assert (bf16.route, bf16.smem) == ("fused", 115_200) and bf16.smem <= twa.SMEM_TWO_PER_SM
    bwd = twa.bwd_plan(48, 8, 6, (8, 8), True, False)
    assert bwd.route == "fused" and bwd.smem == (("attention", 127_488),) and bwd.blocks_per_sm == 1


def test_the_7x7_plans_keep_their_build_and_layout():
    """7x7 stays on the 7x7 build, whose layouts the window's default leaves as they were."""
    assert twa.window_class((7, 7)).build == "" and twa.window_class((7, 7)).t == 49
    assert twa.attention_smem(False, True, True, 48, 48, 8, 6, 8) == \
        twa.attention_smem(False, True, True, 48, 48, 8, 6, 8, window=(7, 7)) == 112_272
    assert twa.bwd_plan(48, 8, 6, (7, 7), True, False).smem == (("attention", 99_792),)


@pytest.mark.parametrize("window", [(9, 8), (12, 12), (16, 16), (65, 1)], ids=["9x8", "12x12", "16x16", "65x1"])
def test_windows_of_more_than_64_tokens_raise(fake_library, window):
    """No build takes a window of more than 64 tokens: the plans, and a call, raise naming
    "windows" before any launch."""
    for plan in (twa.fwd_plan, twa.bwd_plan):
        with pytest.raises(ValueError, match="windows"):
            plan(24, 8, 3, window, False, False)
    x = torch.zeros(2, 1, 2 * window[0], 2 * window[1], 24)
    w, b, t = torch.zeros(2, 24, 24), torch.zeros(2, 24), window[0] * window[1]
    kw = dict(window=window, num_heads=8, dims_per_head=3, shift=False, cross=False)
    with pytest.raises(ValueError, match="windows"):
        twa._launch_fwd(x, (w, b, w, b, w, b, w, b, torch.zeros(2, t, t)), kw)
    assert not fake_library.calls


@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_a_call_at_8x8_reaches_the_any_window_build(fake_library, monkeypatch, dtype, drop):
    """A forward and a backward at 8x8 (stage 2's C = 96, split routes) load the any-window
    libraries (the backward's dropout form its own) and reach ``swin_k3_fwd`` and ``swin_k3_bwd`` once each with the window (8, 8) as
    their last arguments before the stream (the kernels' T = 64), the plan's head group, route
    and blocks, the bias (S, 64, 64) and the workspace the plan sizes; never the three-launch
    library (``window_attention``); each counts once in its form's counter."""
    loaded = []
    monkeypatch.setattr(_build, "load", lambda name: loaded.append(name) or fake_library)
    c, d = 96, 12
    x = torch.zeros(2, 1, 16, 16, c, dtype=dtype)
    w, b = torch.zeros(2, c, c), torch.zeros(2, c)
    weights = (w, b, w, b, w, b, w, b, torch.zeros(2, 64, 64))
    kw = dict(window=(8, 8), num_heads=8, dims_per_head=d, shift=True, cross=True)
    if drop:
        kw.update(attn_drop_rate=0.25, drop_seed=7)
    names = ("LAUNCHES", "BF16_LAUNCHES", "DROP_LAUNCHES", "BF16_DROP_LAUNCHES", "BWD_LAUNCHES",
             "BF16_BWD_LAUNCHES", "DROP_BWD_LAUNCHES", "BF16_DROP_BWD_LAUNCHES")
    before = {n: getattr(twa, n) for n in names}
    out = twa._launch_fwd(x, weights, kw)
    grads = twa._launch_bwd(torch.zeros_like(x), x, weights, kw)
    assert out.shape == x.shape and grads[0].dtype == dtype and grads[-1].shape == (2, 64, 64)
    assert sorted(set(loaded)) == [f"window_attention_bwd_any{'_drop' if drop else ''}", "window_attention_fwd_any"]
    (fwd,) = fake_library.calls["swin_k3_fwd"]
    (bwd,) = fake_library.calls["swin_k3_bwd"]
    assert "swin_window_attention_fwd" not in fake_library.calls
    assert "swin_window_attention_bwd" not in fake_library.calls
    bf16 = dtype == torch.bfloat16
    fplan = twa.fwd_plan(c, 8, d, (8, 8), True, bf16, drop)
    bplan = twa.bwd_plan(c, 8, d, (8, 8), True, bf16, drop)
    # S, B, H, W, C, heads, d, head group, fused, shift, cross, bf16, scale, wh, ww
    assert fwd[13:25] == (2, 1, 16, 16, c, 8, d, fplan.heads_per_block, int(fplan.route == "fused"), 1, 1, int(bf16))
    assert fwd[25] == pytest.approx(d**-0.5) and fwd[26:28] == (8, 8)
    assert (fwd[12] is not None) == drop and (bwd[4] is not None) == drop
    blocks = bplan.blocks(2, 1, 16, 16, 8)
    assert bwd[5:18] == (2, 1, 16, 16, c, 8, d, bplan.heads_per_block, int(bplan.route == "fused"), blocks, 1, 1,
                         int(bf16))
    assert bwd[18] == pytest.approx(d**-0.5) and bwd[19:21] == (8, 8)
    assert bwd[3] == twa.bwd_workspace_floats(2, 1, 16, 16, c, 8, d, bplan, blocks, True)
    if drop:
        key = twa.attention_keying((16, 16), (8, 8), True, 8, d, "cpu")
        assert (bwd[4].contents.units, bwd[4].contents.t_pad) == (key.units, 64)
    form = ("BF16_" if bf16 else "") + ("DROP_" if drop else "")
    assert {n: getattr(twa, n) - before[n] for n in names} == \
        {n: int(n in (f"{form}LAUNCHES", f"{form}BWD_LAUNCHES")) for n in names}


# ---- the plain K3 against the interpret-mode TPU kernel ----------------------------------------
# (C, heads, d) of stage 0 of the default model; maps of two windows by three
GEOMETRY = (24, 8, 3)


def _case(window, shift, cross, seed, c=GEOMETRY[0], heads=GEOMETRY[1], d=GEOMETRY[2], batch=2):
    """x (2, batch, 2 wh, 3 ww, C), the JAX module's arguments and variables, and the port's module
    with the same weights."""
    rng = np.random.default_rng(seed)
    h, w = 2 * window[0], 3 * window[1]
    x = rng.standard_normal((2, batch, h, w, c)).astype(np.float32)
    kw = dict(streams=2, dims=c, num_heads=heads, dims_per_head=d, window_size=window, shift=shift, cross=cross)
    abstract = jax.eval_shape(JaxAttention(**kw, impl="jnp").init, jax.random.PRNGKey(0), jnp.asarray(x))
    shapes = {k: v.shape for k, v in flatten_dict(abstract, sep="/").items()}
    flat = random_variables_like(shapes, seed + 1)
    port = DualWindowAttention(2, c, heads, d, window, shift, cross)
    port.load_state_dict(variables_from_jax(flat))
    return x, kw, unflatten_dict(flat, sep="/"), port


@pytest.mark.parametrize("window", WINDOWS, ids=WINDOW_IDS)
@pytest.mark.parametrize("shift,cross", [(False, False), (True, False), (False, True), (True, True)],
                         ids=["normal", "shifted", "cross", "shifted-cross"])
def test_plain_k3_matches_jax_pallas_attention_forward_and_gradients(window, shift, cross):
    """``DualWindowAttention`` under ``cuda`` on the CPU (the plain K3 and, through autograd, its
    plain backward) against ``pallas_window_attention`` in interpret mode and ``jax.vjp`` of it:
    the output within atol 2e-5 and rtol 1e-4; g_x and every weight gradient (by flax name) within
    rtol 1e-4 and atol 2e-5 times its own largest magnitude, the key bias's (exactly 0 by
    construction, so both sides are rounding noise) times the call's largest
    (``test_torch_dropout.py``'s rule)."""
    x, kw, variables, port = _case(window, shift, cross, seed=17)
    g = np.random.default_rng(18).standard_normal(x.shape).astype(np.float32)
    apply = jax.jit(JaxAttention(**kw, impl="pallas_interpret").apply)
    ref, vjp = jax.vjp(apply, variables, jnp.asarray(x))
    d_vars, d_x = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    launches = (twa.LAUNCHES, twa.BWD_LAUNCHES)
    out = port(xt, "cuda")
    out.backward(torch.from_numpy(g))
    assert (twa.LAUNCHES, twa.BWD_LAUNCHES) == launches, "the plain versions count no launch"
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    d_x = np.asarray(d_x)
    np.testing.assert_allclose(xt.grad.numpy(), d_x, atol=ATOL * np.abs(d_x).max(), rtol=RTOL)
    got = variables_to_jax({n: p.grad for n, p in port.named_parameters()})
    ref_params = {k: np.asarray(v) for k, v in flatten_dict(d_vars, sep="/").items()}
    assert set(got) == set(ref_params)
    call = max(np.abs(v).max() for v in ref_params.values())
    for name, value in ref_params.items():
        scale = call if name == "params/k/bias" else np.abs(value).max()
        np.testing.assert_allclose(got[name], value, atol=ATOL * scale, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("shift,cross", [(False, False), (True, True)], ids=["normal", "shifted-cross"])
def test_plain_k3_dropout_forward_matches_jax_at_8x8(shift, cross):
    """The plain dropout forward at 8x8 (K3's keying, tp = 64) against the interpret-mode
    ``pallas_window_attention`` with the kernel's seed pinned, attention dropout at rate 0.5, at
    C = 48, 8 heads of d = 6 (stage 1) and one image a stream: each element within 2e-5 of the
    output's largest magnitude and rtol 1e-4."""
    rate = 0.5
    x, kw, variables, port = _case((8, 8), shift, cross, seed=21, c=48, heads=8, d=6, batch=1)
    module = JaxAttention(**kw, attention_drop_ratio=rate, impl="pallas_interpret")
    apply = jax.jit(lambda v, a: module.apply(v, a, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))
    with pinned_seed(jpa, "pallas_window_attention", SEED) as calls:
        ref = np.asarray(apply(variables, jnp.asarray(x)))
    assert calls == [SEED]
    key = dl.keying("k3", x.shape[2:4], (8, 8), shift, 8, 6, "cpu")
    assert key.t_pad == 64
    port.attention_drop_ratio = rate
    launches = twa.DROP_LAUNCHES
    with torch.no_grad():
        out = port(torch.from_numpy(x), "cuda", (SEED, key)).numpy()
        undropped = port(torch.from_numpy(x), "cuda").numpy()
    assert twa.DROP_LAUNCHES == launches, "the plain version counts no launch"
    assert not np.allclose(out, undropped, atol=1e-3), "the mask changed nothing"
    np.testing.assert_allclose(out, ref, atol=2e-5 * np.abs(ref).max(), rtol=RTOL)
