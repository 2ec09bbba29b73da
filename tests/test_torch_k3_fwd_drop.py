"""The dropout form of K3's redesigned forward (``csrc/window_attention_fwd.cu``: the one-launch
block at stages 0-1, the split route's attention block and projection at stages 2-4, the
attention block in its ``kDrop`` form), on the CPU.

The dropout form keeps the route of the form without dropout at every width of the default
model; its attention block adds the tokens' unit hashes and slots after its layout (2 x 64
32-bit words) and, in bf16, whose core reads keep words, two words a query row of every head it
holds (the fp32 core hashes each weight's bit where it uses it). These tests hold the launch
plan, ``fwd_plan(..., drop=True)``, against a transcription of the source's layout arithmetic
(``attention_layout`` + ``drop_attention_bytes``) bound as a fake library's
``swin_k3_fwd_smem``; that a dropout call reaches ``swin_k3_fwd`` with its dropout arguments and
never the three launches of ``csrc/window_attention.cu``; the counters; that a shape the plan
does not take raises before any launch; and the plain dropout forward, which the card tests
hold the kernels against, against the interpret-mode ``pallas_window_attention`` with the
kernel's seed pinned at the one-launch route's geometry (C = 48, 8 heads of d = 6). Inputs are
made with numpy from a seed. About 30 s in one process."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swin_unet_image_fusion_tpu.ops import pallas_attention as jpa
from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan
from test_torch_attention import JaxAttention
from test_torch_attention import _case as attention_case
from test_torch_dropout import pinned_seed
from test_torch_k3_plan import _attention_args, _FakeFunction, fake_library  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (an autouse fixture)

CFG = ModelConfig()
WINDOW = (7, 7)
T = 49
BF16 = torch.bfloat16
SEED = 5_767_169  # < 2^24
# (C, heads, d, route, heads per block) of the default model's five stages
STAGES = ((24, 8, 3, "fused", 8), (48, 8, 6, "fused", 8), (96, 8, 12, "split", 4), (192, 8, 24, "split", 2),
          (384, 8, 48, "split", 1))
STAGE_IDS = [f"C{s[0]}" for s in STAGES]


def _align16(v):
    return -(-v // 16) * 16


def _round_up(v, m):
    return -(-v // m) * m


def source_smem(bf16, fused, cross, c, inner, heads, d, hg, proj, drop, wh, ww):
    """``swin_k3_fwd_smem`` of ``csrc/window_attention_fwd.cu`` transcribed line by line for the
    shapes these tests take (the pitches of ``kPitches``; ``supported`` holds; 7x7 windows):
    ``proj_layout`` or ``attention_layout`` (window_fwd.cuh) + ``drop_attention_bytes(hg, bf16)``."""
    del heads  # only supported() reads it
    assert (wh, ww) == WINDOW
    if proj:
        ring = 6 * (64 * 24 * 2 if bf16 else 16 * 60 * 4) + 6 * 16 * ((48 + 4) if bf16 else 48) * 4
        return _align16(ring) + _align16(2 * 64 * 4)
    dp = next(p for p in (4, 8, 12, 16, 24, 32, 48) if d <= p)
    parts, ki = (2 if cross else 1), _round_up(inner, 16)
    p_bytes = 8 * 32 * 72 * 2 if bf16 else 0
    wp_bytes = ki * (c + 4 if bf16 else c) * 4 if fused else 0
    ring = 3 * parts * (64 * 24 * 2 if bf16 else 16 * 60 * 4) + 3 * 16 * (3 * hg * d + (4 if bf16 else 0)) * 4
    off = _align16(max(ring, p_bytes + wp_bytes))
    off += 2 * _align16(hg * T * dp * 4)  # q, k
    off += _align16(hg * _round_up(d, 8) * 72 * 2 if bf16 else hg * T * dp * 4)  # v (bf16: v^T)
    if fused:
        off += _align16(64 * (ki + 8) * 2 if bf16 else ki * 60 * 4)  # AV
    off += _align16(T * T * 4) + _align16((2 * 64 + 3 * 192) * 4)  # bias table; rows, columns, biases
    if drop:
        off += _align16(2 * 64 * 4) + (_align16(hg * T * 2 * 4) if bf16 else 0)
    return off


class _SourceSmem(_FakeFunction):
    def __call__(self, *args):
        super().__call__(*args)
        return source_smem(*args)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,heads,d,route,hg", STAGES, ids=STAGE_IDS)
def test_the_dropout_plan_keeps_each_stage_route_and_counts_its_masks(fake_library, c, heads, d, route, hg, bf16,
                                                                      cross):
    """``fwd_plan(..., drop=True)`` at every stage of the default model (the plan depends on C,
    heads and d alone, so a 224² and a 512² step share it; stage 4 is the C = 384 shape): the
    route, launches, head group and pitch of the form without dropout; its attention block's
    shared memory that of the source's layout (the bound ``swin_k3_fwd_smem``, twelve arguments),
    the form without dropout's plus 512 bytes of unit hashes and slots and, in bf16, the keep
    words of its heads; the one-launch block still two an SM."""
    fake_library.swin_k3_fwd_smem = _SourceSmem(fake_library.calls, "swin_k3_fwd_smem")
    lib = twa._fwd_library()
    plain = twa.fwd_plan(c, heads, d, WINDOW, cross, bf16)
    drop = twa.fwd_plan(c, heads, d, WINDOW, cross, bf16, True)
    assert (drop.route, drop.heads_per_block) == (plain.route, plain.heads_per_block) == (route, hg)
    assert (drop.launches, drop.pitch, drop.proj_smem) == (plain.launches, plain.pitch, plain.proj_smem)
    assert drop.smem - plain.smem == 512 + (twa.keep_words_bytes(hg) if bf16 else 0)
    args = (int(bf16), int(route == "fused"), int(cross), c, heads * d, heads, d, hg)
    assert lib.swin_k3_fwd_smem(*args, 0, 1, *WINDOW) == drop.smem and lib.swin_k3_fwd_smem(*args, 0, 0, *WINDOW) == \
        plain.smem
    if route == "fused":
        assert drop.smem <= twa.SMEM_TWO_PER_SM and drop.proj_smem == 0
    else:
        assert lib.swin_k3_fwd_smem(*args, 1, 1, *WINDOW) == drop.proj_smem and drop.smem <= twa.SMEM_LIMIT_BYTES


def test_the_tightest_one_launch_block_still_fits_two_an_sm():
    """Stage 1 under cross, the largest one-launch block: fp32 112,272 + 512 bytes (its core
    hashes each weight's bit, so no keep words), bf16 100,752 + 512 + 3,136 (8 heads x 49 rows
    x 2 words x 4 bytes); both within two blocks an SM (115,712 bytes each)."""
    fp32 = twa.fwd_plan(48, 8, 6, WINDOW, True, False, True)
    bf16 = twa.fwd_plan(48, 8, 6, WINDOW, True, True, True)
    assert (fp32.route, fp32.smem) == ("fused", 112_784) and (bf16.route, bf16.smem) == ("fused", 104_400)
    assert max(fp32.smem, bf16.smem) <= twa.SMEM_TWO_PER_SM


def _stage_maps(hw):
    plan = make_plan(*hw, CFG.num_stages, CFG.merging_size, CFG.window_size)
    return [(k, *p.att_hw) for k, p in enumerate(plan)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("stage", range(5))
@pytest.mark.parametrize("hw", [(224, 224), (512, 512)], ids=["224", "512"])
def test_a_dropout_call_reaches_swin_k3_fwd_with_its_dropout_arguments(fake_library, hw, stage, dtype):
    """A dropout forward at each stage map of a 224² and a 512² input (one image a stream)
    reaches ``swin_k3_fwd`` once, never ``swin_window_attention_fwd``, with a pointer to the
    call's dropout arguments (K3's keying of the map: its units, the slots' attention offsets
    with tp = 56; the attention site on at the call's rate and seed, the others off), the
    dropout plan's head group and route, an AV scratch only on the split route, the dtype
    form; it counts once in its dtype's dropout counter and nowhere else."""
    k, h, w = _stage_maps(hw)[stage]
    c, heads, d, route, hg = STAGES[stage]
    x, weights = _attention_args(c, heads, d, hw=(h, w), dtype=dtype)
    kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=True, cross=True, attn_drop_rate=0.25,
              drop_seed=11)
    counters = ("LAUNCHES", "BF16_LAUNCHES", "DROP_LAUNCHES", "BF16_DROP_LAUNCHES")
    before = [getattr(twa, n) for n in counters]
    out = twa._launch_fwd(x, weights, kw)
    assert out.dtype == dtype and out.shape == x.shape
    (args,) = fake_library.calls["swin_k3_fwd"]
    assert "swin_window_attention_fwd" not in fake_library.calls
    drop = args[12].contents
    key = twa.attention_keying((h, w), WINDOW, True, heads, d, "cpu")
    assert (drop.units, drop.pairs, drop.attn_mode, drop.t_pad) == (key.units, 0, dl.ATTN_SLOTS, 56)
    assert list(drop.on) == [1, 0, 0, 0] and drop.table != 0
    assert (drop.base[0], drop.threshold[0]) == (hd.site_base(11, hd.SITE_ATTN), hd.keep_threshold(0.25))
    assert drop.scale[0] == hd.keep_scale(0.25)
    bf16 = dtype == BF16
    plan = twa.fwd_plan(c, heads, d, WINDOW, True, bf16, True)
    assert plan.route == route
    # S, B, H, W, C, heads, d, head group, fused, shift, cross, bf16
    assert args[13:25] == (2, 1, h, w, c, heads, d, hg, int(route == "fused"), 1, 1, int(bf16))
    assert (args[11] is None) == (route == "fused")
    assert [getattr(twa, n) - b for n, b in zip(counters, before)] == [0, 0, 1 - bf16, bf16]


@pytest.mark.parametrize("what,c,heads,d,window", [
    ("windows", 24, 8, 3, (12, 12)),
    ("dims per head", 512, 8, 64, (7, 7)),
    ("multiples of 8", 20, 4, 5, (7, 7)),
])
def test_a_dropout_call_on_a_shape_the_plan_does_not_take_raises_before_any_launch(fake_library, what, c, heads,
                                                                                  d, window):
    """Nothing falls back to the three launches: a dropout call that the plan does not take
    raises before any launcher is called."""
    x, weights = _attention_args(c, heads, d, hw=(24, 24) if window == (12, 12) else (14, 14))
    kw = dict(window=window, num_heads=heads, dims_per_head=d, shift=False, cross=False, attn_drop_rate=0.1,
              drop_seed=3)
    with pytest.raises(ValueError, match=what):
        twa._launch_fwd(x, weights, kw)
    assert not fake_library.calls


# ---- the plain dropout forward against JAX at the one-launch route's geometry ---------------


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("shift", [False, True], ids=["normal", "shifted"])
def test_k3_dropout_forward_matches_jax_pallas_attention_at_the_fused_geometry(shift, cross):
    """The port's ``DualWindowAttention`` under ``cuda`` with the attention weights at rate 0.5
    runs, on the CPU, the plain dropout forward that the one-launch block's dropout form
    reproduces on the card; held against the interpret-mode ``pallas_window_attention`` with
    the kernel's seed pinned, at C = 48, 8 heads of d = 6 (stage 1, the one-launch route), a
    14x14 map and one image per stream, each element within 2e-5 of the output's largest
    magnitude and rtol 1e-4, as ``test_torch_dropout.py`` holds K3 at C = 24."""
    rate = 0.5
    x, kw, variables, port = attention_case((48, 8, 6, 14, 14), shift, cross, seed=81)
    x = np.ascontiguousarray(x[:, :1])
    module = JaxAttention(**kw, attention_drop_ratio=rate, impl="pallas_interpret")
    apply = jax.jit(lambda v, a: module.apply(v, a, deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))
    with pinned_seed(jpa, "pallas_window_attention", SEED) as calls:
        ref = np.asarray(apply(variables, jnp.asarray(x)))
    assert calls == [SEED]
    assert twa.fwd_plan(48, 8, 6, WINDOW, cross, False, True).route == "fused"
    port.attention_drop_ratio = rate
    launches = twa.DROP_LAUNCHES
    with torch.no_grad():
        out = port(torch.from_numpy(x), "cuda", (SEED, dl.keying("k4", (14, 14), WINDOW, shift, 8, 6, "cpu")))
    assert twa.DROP_LAUNCHES == launches, "the plain version counts no launch"
    with torch.no_grad():
        undropped = port(torch.from_numpy(x), "cuda")
    assert not np.allclose(out.numpy(), undropped.numpy(), atol=1e-3), "the mask changed nothing"
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5 * np.abs(ref).max(), rtol=1e-4)
