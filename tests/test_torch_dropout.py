"""The port's hash dropout against the JAX package's: the hash functions bit for bit, the
keying tables against the TPU kernels' geometry, and the plain K3, K1 and K4 with dropout
on against the Pallas kernels in interpret mode.

The masks are a pure function of (seed, site, global position), so with the same seed the
plain versions must make the TPU kernels' masks exactly; at rate 0.5 a mask that differs
in one element moves the output far outside any tolerance. The JAX layers draw each
block's seed from flax's rng inside the kernel's caller; the tests pin it by wrapping the
kernel's entry point, which ``models/layers.py`` imports at call time, so that the port is
given the same seed. Forward and gradients (``jax.vjp`` against torch autograd) at rtol
1e-4 and atol 2e-5 times each tensor's largest magnitude: the block tolerance of
``test_torch_fused_block.py``, made relative because at rate 0.5 every kept element is
doubled at up to three sites in a row and the outputs reach 30 (the largest error seen is
~1e-6 of that). About 100 s in one process.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from swin_unet_image_fusion_tpu.models.layers import BasicBlock as JaxBlock
from swin_unet_image_fusion_tpu.ops import hash_dropout as jhd
from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu.ops import pallas_block as jpb
from swin_unet_image_fusion_tpu.ops import pallas_pack as jpp
from swin_unet_image_fusion_tpu.ops.window import window_partition as jax_window_partition
from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_to_jax
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
from swin_unet_image_fusion_tpu_torch.testing import exact_zero
from test_torch_attention import JaxAttention
from test_torch_attention import _case as attention_case
from test_torch_fused_block import CASES, _block_case
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL, RTOL = 2e-5, 1e-4
WINDOW = (7, 7)
RATE = 0.5
SEED = 7_340_033  # < 2^24
EDGES = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**24 - 1, 2**24, 2**24 + 1, 123456789,
                  -987654321], dtype=np.int32)


# ---------------------------------------------------------------- hash, bit for bit


def test_finalize_and_threshold_equal_jax():
    ints = np.concatenate([EDGES, np.random.default_rng(0).integers(-2**31, 2**31, 4096,
                                                                     dtype=np.int64).astype(np.int32)])
    np.testing.assert_array_equal(hd.finalize(ints).numpy(), np.asarray(jhd.finalize(jnp.asarray(ints))))
    for rate in (0.0, 0.1, 0.25, 0.5, 0.9, 1 - 2**-24, 1.0):
        assert hd.keep_threshold(rate) == jhd.keep_threshold(rate)
        if rate < 1.0:
            assert hd.keep_scale(rate) == float(np.float32(1.0 / (1.0 - rate)))


@pytest.mark.parametrize("seed", [0, 1, 2**24 - 1, 99_991])
@pytest.mark.parametrize("site", jhd.SITE_ATTN + np.arange(4))
def test_pair_hash_and_keep_equal_jax(seed, site):
    units = np.concatenate([EDGES, np.arange(300, dtype=np.int32)])
    ph = hd.pair_hash(seed, int(site), units)
    ref = jhd.pair_hash(jnp.int32(seed), int(site), jnp.asarray(units))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(ref))
    intra = np.arange(0, 1 << 17, 97, dtype=np.int32)
    for rate in (0.1, 0.5, 0.9):
        got = hd.keep_from_hash(ph[:, None], intra[None], rate).numpy()
        want = jhd.keep_from_hash(ref[:, None], jnp.asarray(intra)[None], rate)
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_tile_keep_mask_equals_jax(rate):
    for seed, site, pair0, tile, inner, base in ((5, 1, 0, 4, (24, 128), 0),
                                                 (2**24 - 1, 3, 1000, 3, (56, 56), 2 * 56 * 56),
                                                 (77, 4, 2**31 - 2, 2, (8, 128), 0)):
        got = hd.tile_keep_mask(seed, site, pair0, tile, inner, rate, intra_base=base)
        want = jhd.tile_keep_mask(jnp.int32(seed), site, jnp.int32(pair0), tile, inner, rate,
                                  intra_base=base)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- keying tables


def _iota_map(hw):
    """(1, 1, H, W, 1) pixel ids + 1 (0 stays free for padding)."""
    return np.arange(1, hw[0] * hw[1] + 1, dtype=np.float32).reshape(1, 1, *hw, 1)


def _pixel_of_port_windows(hw, shift):
    """(nWin * T,) pixel id + 1 of each token of the port's windows layout."""
    return twp.pack_windows(torch.from_numpy(_iota_map(hw)), WINDOW, shift).reshape(-1).long().numpy()


def _table_by_pixel(ids, units, slots):
    """{pixel id + 1: (unit, slot)} of the real tokens of a JAX layout."""
    real = ids > 0
    return dict(zip(ids[real].tolist(), zip(units[real].tolist(), slots[real].tolist())))


@pytest.mark.parametrize("hw", [(14, 28), (21, 21), (21, 35), (28, 14)])
@pytest.mark.parametrize("shift", [False, True])
def test_k1_table_equals_the_packed_strips(hw, shift):
    """Each token's pair unit and lane, as ``pack_windows_cmajor`` places its pixel, in
    wrap and in zero-padded shifted geometries (``use_wrap`` is False at (21, 21))."""
    strips, (nh, np_w, _) = jpp.pack_windows_cmajor(jnp.moveaxis(jnp.asarray(_iota_map(hw)), -1, 2),
                                                    WINDOW, shift)
    ids = np.asarray(strips).reshape(nh * np_w, 128).astype(np.int64)
    units, lanes = np.meshgrid(np.arange(nh * np_w), np.arange(128), indexing="ij")
    want = _table_by_pixel(ids.reshape(-1), units.reshape(-1), lanes.reshape(-1))
    table, n_units = dl.keying_table("k1", hw, WINDOW, shift)
    got = dict(zip(_pixel_of_port_windows(hw, shift).tolist(), map(tuple, table.tolist())))
    assert got == want and n_units == nh * np_w
    if shift:
        assert dl.use_wrap(hw, WINDOW, True) == jpp.use_wrap(hw, WINDOW, True)


@pytest.mark.parametrize("hw", [(14, 28), (21, 35)])
@pytest.mark.parametrize("shift", [False, True])
def test_k4_table_equals_the_padded_partition(hw, shift):
    """Each pixel's window and slot in ``window_partition`` of the map zero-padded by
    ``shift_pad_geometry`` (K4's shifted partition)."""
    top, left, hp, wp, nh, nw = jpa.shift_pad_geometry(hw, WINDOW, shift)
    padded = np.zeros((1, hp, wp, 1), np.float32)
    padded[0, top:top + hw[0], left:left + hw[1]] = _iota_map(hw)[0]
    ids = np.asarray(jax_window_partition(jnp.asarray(padded), WINDOW)).reshape(nh * nw, 49)
    units, slots = np.meshgrid(np.arange(nh * nw), np.arange(49), indexing="ij")
    want = _table_by_pixel(ids.reshape(-1).astype(np.int64), units.reshape(-1), slots.reshape(-1))
    table, n_units = dl.keying_table("k4", hw, WINDOW, shift)
    assert dict(zip(range(1, hw[0] * hw[1] + 1), map(tuple, table.tolist()))) == want
    assert n_units == nh * nw


@pytest.mark.parametrize("shift", [False, True])
def test_k3_table_equals_the_wrap_windows(shift):
    """Each pixel's window and slot in ``window_partition`` of the map rolled by
    (top, left), as ``pallas_window_attention`` partitions it."""
    hw = (21, 35)
    top, left = (4, 4) if shift else (0, 0)
    rolled = np.roll(_iota_map(hw)[0], (top, left), axis=(1, 2))
    ids = np.asarray(jax_window_partition(jnp.asarray(rolled), WINDOW)).reshape(-1, 49)
    units, slots = np.meshgrid(np.arange(ids.shape[0]), np.arange(49), indexing="ij")
    want = _table_by_pixel(ids.reshape(-1).astype(np.int64), units.reshape(-1), slots.reshape(-1))
    table, n_units = dl.keying_table("k3", hw, WINDOW, shift)
    assert dict(zip(range(1, hw[0] * hw[1] + 1), map(tuple, table.tolist()))) == want
    assert n_units == 15


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("site", ["tokens", "attention"])
def test_mask_kernel_addressing_equals_the_plain_masks(shift, site):
    """The element-to-(unit, offset) arithmetic of ``csrc/dropout_mask.cu`` (flat index of
    one stream -> row and column for a token site; -> image, window, head, query and key
    for the attention weights), written out here on int64 tensors, gives the plain
    versions' masks of the composition."""
    s, b, hw, heads, cols, rate = 2, 2, (14, 21), 2, 5, 0.5
    key = dl.keying("k4", hw, WINDOW, shift, heads, 4, "cpu")
    table = key.table.long()
    z = torch.arange(s).reshape(s, 1)
    if site == "tokens":
        i = torch.arange(b * hw[0] * hw[1] * cols).reshape(1, -1)
        gr, gn = i // cols, i % cols
        img = gr // (hw[0] * hw[1])
        e = table[gr - img * hw[0] * hw[1]]
        keep = hd.keep_mask(SEED, hd.SITE_MLP_HIDDEN, rate, (z * b + img) * key.units + e[..., 0],
                            e[..., 1] * cols + gn)
        want = dl.token_keep(SEED, hd.SITE_MLP_HIDDEN, rate, key, s, b, cols)
    else:
        windows = dl.composition_windows(key).long()
        n_win, t = windows.shape[:2]
        i = torch.arange(b * n_win * heads * t * t).reshape(1, -1)
        tk, row = i % t, i // t
        tq, bwh = row % t, row // t
        h, bw = bwh % heads, bwh // heads
        img, w = bw // n_win, bw % n_win
        eq, ek = windows[w, tq], windows[w, tk]
        keep = hd.keep_mask(SEED, hd.SITE_ATTN, rate, (z * b + img) * key.units + eq[..., 0],
                            (h * key.t_pad + eq[..., 1]) * key.t_pad + ek[..., 1])
        want = dl.attention_keep(SEED, rate, key, windows, s, b, heads)
    assert torch.equal(keep.reshape(-1), want.reshape(-1))
    assert 0.4 < keep.float().mean() < 0.6


def test_mask_wrappers_take_the_plain_version_on_the_cpu():
    """On a CPU tensor the composition's masks are their plain versions, gradient
    included, and never count as kernel launches."""
    key = dl.keying("k4", (14, 14), WINDOW, True, 2, 4, "cpu")
    gen = torch.Generator().manual_seed(62)
    x = torch.randn(2, 1, 14, 14, 6, generator=gen).requires_grad_()
    weights = torch.randn(2, 4, 2, 49, 49, generator=gen).requires_grad_()
    before = (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES, dm.ATTN_LAUNCHES, dm.ATTN_BWD_LAUNCHES)
    out = dm.token_dropout(x, SEED, hd.SITE_PROJ, RATE, key)
    keep = dl.token_keep(SEED, hd.SITE_PROJ, RATE, key, 2, 1, 6).reshape(x.shape)
    assert torch.equal(out, torch.where(keep, x * 2.0, torch.zeros(())))
    (g,) = torch.autograd.grad(out.sum(), x)
    assert torch.equal(g, keep.float() * 2.0)
    attn = dm.attention_dropout(weights, SEED, RATE, key)
    assert torch.equal(attn, dm.attention_dropout_plain(weights, SEED, RATE, key))
    assert (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES, dm.ATTN_LAUNCHES, dm.ATTN_BWD_LAUNCHES) == before


# ---------------------------------------------------------------- plain kernels vs interpret


@contextlib.contextmanager
def pinned_seeds(targets, seeds):
    """Call each ``(module, name)`` entry point with its ``drop_seed`` replaced by the
    next of ``seeds`` (the JAX layers pass one drawn from flax's rng), in call order;
    yields the list of seeds taken."""
    originals = [(module, name, getattr(module, name)) for module, name in targets]
    taken = []

    def pin(original):
        def wrapper(*args, drop_seed=None, **kwargs):
            if drop_seed is not None:
                taken.append(seeds[len(taken)])
                drop_seed = jnp.float32(taken[-1])
            return original(*args, drop_seed=drop_seed, **kwargs)
        return wrapper

    for module, name, original in originals:
        setattr(module, name, pin(original))
    try:
        yield taken
    finally:
        for module, name, original in originals:
            setattr(module, name, original)


def pinned_seed(module, name, seed):
    return pinned_seeds([(module, name)], [seed])


def _cotangent(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_vjp(apply, variables, x, g):
    """(out, d x, flat d params) of ``apply(variables, x)`` for the cotangent g."""
    out, vjp = jax.vjp(apply, variables, jnp.asarray(x))
    d_vars, d_x = vjp(jnp.asarray(g))
    return (np.asarray(out), np.asarray(d_x),
            {k: np.asarray(v) for k, v in flatten_dict(d_vars, sep="/").items()})


def _close(got, ref, scale, what):
    np.testing.assert_allclose(got, ref, atol=ATOL * scale, rtol=RTOL, err_msg=what)


def _assert_matches(out, xt, module, ref):
    """Output, input gradient and every parameter gradient, each at atol 2e-5 times its
    own largest magnitude (a key bias's, exactly 0 by construction, at the call's)."""
    ref_out, ref_x, ref_params = ref
    _close(out.detach().numpy(), ref_out, np.abs(ref_out).max(), "output")
    _close(xt.grad.numpy(), ref_x, np.abs(ref_x).max(), "x")
    got = variables_to_jax({n: p.grad for n, p in module.named_parameters()})
    assert set(got) == set(ref_params)
    call = max(np.abs(v).max() for v in ref_params.values())
    for name, value in ref_params.items():
        zero = exact_zero(name) or name == "params/k/bias"  # the attention module's own
        _close(got[name], value, call if zero else np.abs(value).max(), name)


def _set_block_rates(port, rates):
    port.attn.attention_drop_ratio, port.attn.proj_drop_ratio, port.mlp.drop_ratio = rates


# stage 0 of the full model (C=24, 8 heads, d=3) without and with shift and cross, both
# together, forward and gradients (~9 s each); shift alone and cross alone forward only
# (test_dropout_forward_of_the_other_variants): shift changes the keying's geometry,
# cross the stream whose units key a mask
BLOCK_CASES = {k: v for k, v in CASES.items()
               if k.startswith("c24_stage0") and k.endswith(("shift0-cross0", "shift1-cross1"))}
OTHER_CASES = {k: v for k, v in CASES.items()
               if k.startswith("c24_stage0") and k.endswith(("shift1-cross0", "shift0-cross1"))}
RATES = (RATE, RATE, RATE)


def _jax_block(kw, impl, **extra):
    rates = dict(attention_drop_ratio=RATE, proj_drop_ratio=RATE, mlp_drop_ratio=RATE)
    block = JaxBlock(**kw, **rates, impl=impl, **extra)
    return lambda v, x: block.apply(v, x, deterministic=False,
                                    rngs={"dropout": jax.random.PRNGKey(0)})


@pytest.mark.parametrize("case", BLOCK_CASES.values(), ids=BLOCK_CASES.keys())
def test_k4_plain_with_dropout_equals_pallas_block(case):
    """K4's plain version (the image layout) with every site at rate 0.5, forward and
    gradients, against ``pallas_fused_block`` in interpret mode with the same seed."""
    x, kw, variables, port = _block_case(case, seed=31)
    g = _cotangent(x.shape, 32)
    with pinned_seed(jpb, "pallas_fused_block", SEED) as calls:
        ref = _jax_vjp(jax.jit(_jax_block(kw, "pallas_block_interpret")), variables, x, g)
    assert calls == [SEED]
    _set_block_rates(port, RATES)
    xt = torch.from_numpy(x).requires_grad_()
    launches = tfb.DROP_LAUNCHES, tfb.DROP_BWD_LAUNCHES
    out = port.fused(xt, "image", seed=SEED)
    out.backward(torch.from_numpy(g))
    assert (tfb.DROP_LAUNCHES, tfb.DROP_BWD_LAUNCHES) == launches
    _assert_matches(out, xt, port, ref)


@pytest.mark.parametrize("case", BLOCK_CASES.values(), ids=BLOCK_CASES.keys())
def test_k1_plain_with_dropout_equals_pallas_pack(case):
    """K1's plain version (pack -> windows layout -> unpack) with every site at rate 0.5,
    forward and gradients, against ``pallas_packed_block`` in interpret mode on C-major
    input with the same seed."""
    x, kw, variables, port = _block_case(case, seed=33)
    shift, hw = kw["shift"], x.shape[2:4]
    g = _cotangent(x.shape, 34)
    apply = _jax_block(kw, "pallas_pack_interpret", packed=True)
    cmajor = jax.jit(lambda v, a: jnp.moveaxis(apply(v, jnp.moveaxis(a, -1, 2)), 2, -1))
    with pinned_seed(jpp, "pallas_packed_block_strips", SEED) as calls:
        ref = _jax_vjp(cmajor, variables, x, g)
    assert calls == [SEED]
    _set_block_rates(port, RATES)
    xt = torch.from_numpy(x).requires_grad_()
    xw = twp.pack_windows(xt, WINDOW, shift)
    out = twp.unpack_windows(port.fused(xw, "windows", hw, seed=SEED), hw, WINDOW, shift)
    out.backward(torch.from_numpy(g))
    _assert_matches(out, xt, port, ref)


@pytest.mark.parametrize("kernel", ["K4", "K1", "K3"])
@pytest.mark.parametrize("case", OTHER_CASES.values(), ids=OTHER_CASES.keys())
def test_dropout_forward_of_the_other_variants(case, kernel):
    """Shift alone and cross alone: each plain version's dropout forward (every site at
    rate 0.5; K3 its attention site) against the interpret kernel with the same seed."""
    *_, shift, cross = case
    if kernel == "K3":
        x, kw, variables, port = attention_case((24, 8, 3, 14, 28), shift, cross, seed=41)
        module = JaxAttention(**kw, attention_drop_ratio=RATE, impl="pallas_interpret")
        apply = lambda v, a: module.apply(v, a, deterministic=False,
                                          rngs={"dropout": jax.random.PRNGKey(0)})
        target, port.attention_drop_ratio = (jpa, "pallas_window_attention"), RATE
        key = dl.keying("k4", x.shape[2:4], WINDOW, shift, 8, 3, "cpu")
        run = lambda xt: port(xt, "cuda", (SEED, key))
    else:
        x, kw, variables, port = _block_case(case, seed=43)
        _set_block_rates(port, RATES)
        if kernel == "K4":
            apply = _jax_block(kw, "pallas_block_interpret")
            target = (jpb, "pallas_fused_block")
            run = lambda xt: port.fused(xt, "image", seed=SEED)
        else:
            packed = _jax_block(kw, "pallas_pack_interpret", packed=True)
            apply = lambda v, a: jnp.moveaxis(packed(v, jnp.moveaxis(a, -1, 2)), 2, -1)
            target = (jpp, "pallas_packed_block_strips")
            hw = x.shape[2:4]
            run = lambda xt: twp.unpack_windows(
                port.fused(twp.pack_windows(xt, WINDOW, shift), "windows", hw, seed=SEED),
                hw, WINDOW, shift)
    with pinned_seed(*target, SEED) as calls:
        ref = np.asarray(jax.jit(apply)(variables, jnp.asarray(x)))
    assert calls == [SEED]
    with torch.no_grad():
        out = run(torch.from_numpy(x)).numpy()
    _close(out, ref, np.abs(ref).max(), f"{kernel} output")


def test_k1_padded_geometry_and_head_batched_keying_equal_pallas_pack():
    """A 21x21 map, whose shifted packed geometry is zero-padded (``use_wrap`` is False),
    with heads * d = 6, not a multiple of 8: the packed kernel's head-batched score map
    keys the attention weights (``ATTN_HEADBATCHED``). Forward only."""
    hw = (21, 21)
    x, kw, variables, port = _block_case((12, 2, 3, 24, *hw, True, True), seed=35)
    apply = _jax_block(kw, "pallas_pack_interpret", packed=True)
    with pinned_seed(jpp, "pallas_packed_block_strips", SEED):
        ref = jax.jit(lambda v, a: jnp.moveaxis(apply(v, jnp.moveaxis(a, -1, 2)), 2, -1))(
            variables, jnp.asarray(x))
    _set_block_rates(port, RATES)
    with torch.no_grad():
        xw = twp.pack_windows(torch.from_numpy(x), WINDOW, True)
        out = twp.unpack_windows(port.fused(xw, "windows", hw, seed=SEED), hw, WINDOW, True)
    assert not dl.use_wrap(hw, WINDOW, True)
    assert dl.attention_mode("k1", 2, 3) == dl.ATTN_HEADBATCHED
    _close(out.numpy(), np.asarray(ref), np.abs(np.asarray(ref)).max(), "output")


@pytest.mark.parametrize("shift,cross", [(False, False), (True, True)], ids=["shift0-cross0", "shift1-cross1"])
def test_k3_plain_with_dropout_equals_pallas_attention(shift, cross):
    """K3's plain version with the attention weights at rate 0.5 (the projection's
    dropout is the caller's), forward and gradients, against ``pallas_window_attention``
    in interpret mode with the same seed."""
    x, kw, variables, port = attention_case((24, 8, 3, 14, 21), shift, cross, seed=37)
    g = _cotangent(x.shape, 38)
    module = JaxAttention(**kw, attention_drop_ratio=RATE, impl="pallas_interpret")
    apply = jax.jit(lambda v, a: module.apply(v, a, deterministic=False,
                                              rngs={"dropout": jax.random.PRNGKey(0)}))
    with pinned_seed(jpa, "pallas_window_attention", SEED) as calls:
        ref = _jax_vjp(apply, variables, x, g)
    assert calls == [SEED]
    port.attention_drop_ratio = RATE
    xt = torch.from_numpy(x).requires_grad_()
    launches = twa.DROP_LAUNCHES, twa.DROP_BWD_LAUNCHES
    out = port(xt, "cuda", (SEED, dl.keying("k4", x.shape[2:4], WINDOW, shift, 8, 3, "cpu")))
    out.backward(torch.from_numpy(g))
    assert (twa.DROP_LAUNCHES, twa.DROP_BWD_LAUNCHES) == launches
    _assert_matches(out, xt, port, ref)


def test_rates_zero_are_the_code_without_dropout():
    """A zero rate draws no mask: bit-identical to a call without dropout arguments."""
    x, kw, _, port = _block_case(CASES["c24_stage0-shift1-cross1"], seed=39)
    args = [torch.from_numpy(x)]
    attn = port.attn
    weights = [t for layer in (attn.q, attn.k, attn.v, attn.proj) for t in layer.weights()]
    with torch.no_grad():
        for layout, xl in (("image", args[0]), ("windows", twp.pack_windows(args[0], WINDOW, True))):
            base = port.fused(xl, layout, (14, 28))
            _set_block_rates(port, RATES)
            assert not torch.equal(port.fused(xl, layout, (14, 28), seed=SEED), base)
            _set_block_rates(port, (0.0, 0.0, 0.0))
            assert torch.equal(port.fused(xl, layout, (14, 28), seed=SEED), base)
        plain = twa.window_attention_plain(args[0], *weights, torch.zeros(2, 49, 49), window=WINDOW,
                                           num_heads=8, dims_per_head=3, shift=True, cross=True)
        zero = twa.window_attention_plain(args[0], *weights, torch.zeros(2, 49, 49), window=WINDOW,
                                          num_heads=8, dims_per_head=3, shift=True, cross=True,
                                          attn_drop_rate=0.0, drop_seed=SEED)
    assert torch.equal(plain, zero)


def test_dropout_arguments_are_checked():
    x, _, _, port = _block_case(CASES["c8-shift0-cross0"])
    _set_block_rates(port, (0.1, 0.0, 0.0))
    with pytest.raises(ValueError, match="seed"):
        port.fused(torch.from_numpy(x), "image", seed=1 << 24)
    _set_block_rates(port, (1.0, 0.0, 0.0))
    with pytest.raises(ValueError, match="rates"):
        port.fused(torch.from_numpy(x), "image", seed=1)
