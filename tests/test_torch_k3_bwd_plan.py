"""The launch plan of K3's backward without dropout (``csrc/window_attention_bwd.cu``), on the
CPU: ``bwd_plan``'s route, head grouping, launches, shared memory and workspace at every stage
of the default model at 224² batch 20 and 512² (the "fused" route, every head in a block that
also forms g_x, at stages 0-1; the "split" route, a block per group of heads and a g_x kernel,
at stages 2-4), one plan for both dtypes, what ``_launch_bwd`` hands ``swin_k3_bwd`` (a fake
library that checks ctypes' argument counts), that a dropout backward runs the same entry
point with its dropout arguments (not ``swin_window_attention_bwd`` of
``csrc/window_attention.cu``), and that shapes the kernels do not take raise before any
launch. The kernels themselves run in
``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``."""

import pytest
import torch

from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan
from test_torch_k3_plan import _attention_args, fake_library  # noqa: F401 (a fixture)

CFG = ModelConfig()
# (stage, C, route, heads per block, q/k row pitch) of the default model's five stages
STAGES = ((0, 24, "fused", 8, 4), (1, 48, "fused", 8, 8), (2, 96, "split", 4, 12), (3, 192, "split", 2, 24),
          (4, 384, "split", 1, 48))
# (input map, batch): the training step's and a 512² request
MAPS = (((224, 224), 20), ((512, 512), 1))


def _stage_map(hw, k):
    return make_plan(*hw, CFG.num_stages, CFG.merging_size, CFG.window_size)[k].att_hw


@pytest.mark.parametrize("hw,batch", MAPS, ids=["224x224x20", "512x512"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("k,c,route,hg,pitch", STAGES, ids=[f"s{k}-C{c}" for k, c, *_ in STAGES])
def test_plan_of_each_stage(k, c, route, hg, pitch, cross, dtype, hw, batch):
    """Stages 0-1 (d = 3, 6) take the fused route: every head in a block, one block kernel
    (and under cross the sum of g_x's two sides) between the transposed weights and the weight
    gradients and their reduction, two blocks an SM. Stages 2-4 (d = 12, 24, 48) the split
    route: 48 q/k/v columns a part, as the forward's split route, and a g_x kernel; two blocks
    an SM below a row pitch of 24. Every block within the 227 KB a block may use; the blocks
    per stream and head group fill one wave of the card and take at most one per window."""
    d = CFG.dims_per_head(c)
    heads = CFG.att_num_heads
    plan = twa.bwd_plan(c, heads, d, CFG.window_size, cross, dtype == "bf16")
    assert (plan.route, plan.heads_per_block, plan.pitch) == (route, hg, pitch)
    assert [kernel for kernel, _ in plan.smem] == (["attention"] if route == "fused" else list(twa.BWD_KERNELS))
    assert plan.smem[0][1] == twa.bwd_smem(route == "fused", cross, c, heads * d, hg, d, pitch)
    assert all(0 < smem <= twa.SMEM_LIMIT_BYTES for _, smem in plan.smem)
    assert plan.launches(cross) == (4 if route == "fused" and not cross else 5)
    assert plan.blocks_per_sm == (2 if pitch < 24 else 1)
    if plan.blocks_per_sm == 2:
        assert plan.smem[0][1] <= twa.SMEM_TWO_PER_SM
    if route == "split":
        assert hg * d == twa.GROUP_COLS and plan.smem[1][1] == twa.gx_smem(c)
    h, w = _stage_map(hw, k)
    windows = batch * (h // 7) * (w // 7)
    blocks = plan.blocks(2, batch, h, w, heads)
    assert 1 <= blocks <= windows
    assert blocks * 2 * (heads // hg) <= twa.DEFAULT_SMS * plan.blocks_per_sm
    floats = twa.bwd_workspace_floats(2, batch, h, w, c, heads, d, plan, blocks, cross)
    per_token = 4 * heads * d + (2 * c if route == "fused" and cross else 0)  # AV, g_q, g_k, g_v; g_x's sides
    assert 0 <= floats - 2 * batch * h * w * per_token < 16 * 2**20


def test_shared_memory_counts_every_buffer():
    """Stage 1, cross, fused: max(the rings (x of both streams, 2 slots x 16 channels x 60
    floats; w, 2 x 16 x 144 columns), g_q | g_k | g_v resident after the core (144 x 60)),
    max(q, k, v, g_o of 8 heads x 49 x pitch 8, the g_x product's ring (2 x 16 x 48) and row
    buffer (49 x 48)), the rows pass's (1/sum, dot) per head and row, the bias table, and the
    row, region and token tables, the column offsets and biases. Stage 2, cross, split: the
    rings, q/k/v/g_o of 4 heads at pitch 12 and the same tail; its g_x kernel a one-part A ring,
    a 96-column weight ring, a row buffer (49 x 96) and the row table."""
    tail = 9616 + (3 * 64 + 2 * 192) * 4
    fused = max(2 * 2 * 16 * 60 * 4 + 2 * 16 * 144 * 4, 144 * 60 * 4) \
        + max(4 * 8 * 49 * 8 * 4, 2 * 16 * 48 * 4 + 49 * 48 * 4) + 8 * 49 * 8 + tail
    split = 2 * 2 * 16 * 60 * 4 + 2 * 16 * 144 * 4 + 4 * 4 * 49 * 12 * 4 + 4 * 49 * 8 + tail
    gx = 2 * 16 * 60 * 4 + 2 * 16 * 96 * 4 + 49 * 96 * 4 + 64 * 4
    assert twa.bwd_plan(48, 8, 6, (7, 7), True, False).smem == (("attention", fused),)
    assert twa.bwd_plan(96, 8, 12, (7, 7), True, False).smem == (("attention", split), ("gx", gx))
    assert (fused, split, gx) == (99_792, 84_912, 39_040)


def test_workspace_counts_every_buffer():
    """Stage 0, cross, at 224² batch 20 on a 132-SM card: 132 blocks per stream; the
    transposed weights (wp^T, [wq | wk | wv]^T), AV, g_q, g_k, g_v and both sides of g_x per
    token, the bias-table partials per block, and the weight gradients' chunks (8 jobs of one
    tile group: 131 chunks of 1,920 rows, as window_bwd.cuh's wg_chunk_rows cuts them)."""
    plan = twa.bwd_plan(24, 8, 3, (7, 7), True, False)
    m = 20 * 112 * 112
    blocks = plan.blocks(2, 20, 112, 112, 8)
    assert blocks == 132 and twa._wgrad_chunks(m, 8) == 131
    expected = 2 * 24 * 24 * 4 + 2 * m * (4 * 24 + 2 * 24) + 2 * 132 * 49 * 49 \
        + 2 * 131 * (3 * 25 * 24 + 25 * 24)
    floats = twa.bwd_workspace_floats(2, 20, 112, 112, 24, 8, 3, plan, blocks, True)
    assert expected <= floats < expected + 32 * 11  # every piece rounded up to 32 floats


def test_the_plan_is_one_for_both_dtypes():
    """The backward is fp32 inside in either dtype: one plan per shape."""
    for c in CFG.out_dims_list:
        for cross in (False, True):
            d = CFG.dims_per_head(c)
            assert twa.bwd_plan(c, 8, d, (7, 7), cross, True) == twa.bwd_plan(c, 8, d, (7, 7), cross, False)


@pytest.mark.parametrize("what,c,heads,d,window", [
    ("windows", 24, 8, 3, (12, 12)),
    ("dims per head", 512, 8, 64, (7, 7)),
    ("multiples of 8", 20, 4, 5, (7, 7)),
    ("head grouping", 72, 2, 36, (7, 7)),
    ("shared memory", 8, 24, 40, (7, 7)),
])
def test_plan_raises_on_shapes_the_kernels_do_not_take(what, c, heads, d, window):
    with pytest.raises(ValueError, match=what):
        twa.bwd_plan(c, heads, d, window, False, False)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k,c,route,hg,pitch", [STAGES[0], STAGES[2]], ids=["s0-C24", "s2-C96"])
def test_backward_without_dropout_launches_swin_k3_bwd(fake_library, k, c, route, hg, pitch, dtype, cross):
    """A call without dropout launches ``swin_k3_bwd`` once with x, the nine weights and g as
    handed in, g_x in x's dtype and every weight gradient fp32, the workspace the plan sizes
    (fp32), the plan's head group, route and blocks, the shift, cross and dtype flags and the
    scale d^-1/2, and counts once in its dtype's counter; the three-launch backward is not
    called."""
    d = CFG.dims_per_head(c)
    x, weights = _attention_args(c, 8, d, dtype=dtype)
    g = torch.zeros_like(x)
    before = (twa.BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES, twa.DROP_BWD_LAUNCHES, twa.BF16_DROP_BWD_LAUNCHES)
    new_empty = torch.Tensor.new_empty
    made = {}

    def recording_new_empty(self, *args, **kwargs):
        t = new_empty(self, *args, **kwargs)
        made[t.data_ptr()] = t
        return t

    kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=True, cross=cross)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "new_empty", recording_new_empty)
        grads = twa._launch_bwd(g, x, weights, kw)
    (args,) = fake_library.calls["swin_k3_bwd"]
    ins, outs, ws, floats, drop = args[:5]
    assert drop is None
    assert list(ins) == [a.data_ptr() for a in (x, *weights, g)]
    assert list(outs) == [t.data_ptr() for t in grads]
    assert grads[0].dtype == dtype and grads[0].shape == x.shape
    assert all(t.dtype == torch.float32 and t.shape == w.shape for t, w in zip(grads[1:], weights))
    plan = twa.bwd_plan(c, 8, d, (7, 7), cross, False)
    blocks = plan.blocks(2, 1, 14, 14, 8)
    assert made[ws].dtype == torch.float32 and made[ws].numel() == floats
    assert floats == twa.bwd_workspace_floats(2, 1, 14, 14, c, 8, d, plan, blocks, cross)
    bf16 = dtype == torch.bfloat16
    # S, B, H, W, C, heads, d, head group, fused, blocks, shift, cross, bf16, scale
    assert args[5:18] == (2, 1, 14, 14, c, 8, d, hg, int(route == "fused"), blocks, 1, int(cross), int(bf16))
    assert args[18] == pytest.approx(d**-0.5)
    assert "swin_window_attention_bwd" not in fake_library.calls
    assert (twa.BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES, twa.DROP_BWD_LAUNCHES, twa.BF16_DROP_BWD_LAUNCHES) == \
        (before[0] + 1 - bf16, before[1] + bf16, before[2], before[3])


def test_library_binds_the_entry_points_with_their_argument_counts(fake_library):
    """``swin_k3_bwd`` takes 22 arguments (in, out, workspace and its floats, the dropout
    arguments, 13 ints, the scale, the window's rows and columns, the stream),
    ``swin_k3_bwd_smem`` 10 and ``swin_k3_bwd_workspace`` 13 (each ending with the window): the
    counts that ``tests/test_torch_kernel_gpu.py`` calls the library with on the card, in the
    7x7 build and the any-window builds alike."""
    for build in ("", "_any", "_any_drop"):
        lib = twa._bwd_library(build)
        assert [len(lib.swin_k3_bwd.argtypes), len(lib.swin_k3_bwd_smem.argtypes),
                len(lib.swin_k3_bwd_workspace.argtypes)] == [22, 10, 13]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_dropout_backward_keeps_swin_window_attention_bwd(fake_library, dtype):
    """A dropout backward, at a fused and at a split shape, runs ``swin_k3_bwd`` of
    ``csrc/window_attention_bwd.cu`` (no longer the three-launch backward of
    ``csrc/window_attention.cu``) with its dropout arguments (K3's keying, the attention site
    on at the call's rate and seed, the other sites off), the dropout plan's route and head group
    and the workspace without dropout's, and counts in its dropout counter."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
    from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

    before = (twa.DROP_BWD_LAUNCHES, twa.BF16_DROP_BWD_LAUNCHES, twa.BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES)
    for c, d in ((24, 3), (96, 12)):
        x, weights = _attention_args(c, 8, d, dtype=dtype)
        kw = dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=False, cross=True, attn_drop_rate=0.1,
                  drop_seed=5)
        grads = twa._launch_bwd(torch.zeros_like(x), x, weights, kw)
        assert grads[0].dtype == dtype
        args = fake_library.calls["swin_k3_bwd"][-1]
        drop = args[4].contents
        key = twa.attention_keying((14, 14), (7, 7), False, 8, d, x.device)
        assert (drop.units, drop.pairs, drop.attn_mode, drop.t_pad) == (key.units, 0, dl.ATTN_SLOTS, 56)
        assert list(drop.on) == [1, 0, 0, 0]
        assert drop.base[0] == hd.site_base(5, hd.SITE_ATTN) and drop.scale[0] == pytest.approx(1 / 0.9)
        plan = twa.bwd_plan(c, 8, d, (7, 7), True, False, True)
        assert args[12:14] == (plan.heads_per_block, int(plan.route == "fused"))
        assert args[3] == twa.bwd_workspace_floats(2, 1, 14, 14, c, 8, d, plan, args[14], True)
    assert len(fake_library.calls["swin_k3_bwd"]) == 2
    assert "swin_window_attention_bwd" not in fake_library.calls
    bf16 = dtype == torch.bfloat16
    assert (twa.DROP_BWD_LAUNCHES, twa.BF16_DROP_BWD_LAUNCHES, twa.BWD_LAUNCHES, twa.BF16_BWD_LAUNCHES) == \
        (before[0] + 2 - 2 * bf16, before[1] + 2 * bf16, before[2], before[3])


def test_out_of_range_shapes_raise_before_any_launch(fake_library):
    x, weights = _attention_args(512, 8, 64)
    with pytest.raises(ValueError, match="dims per head"):
        twa._launch_bwd(torch.zeros_like(x), x, weights, dict(window=(7, 7), num_heads=8, dims_per_head=64,
                                                              shift=False, cross=False))
    x, weights = _attention_args(24, 8, 3)
    with pytest.raises(ValueError, match="output gradient"):
        twa._launch_bwd(torch.zeros_like(x, dtype=torch.bfloat16), x, weights,
                        dict(window=(7, 7), num_heads=8, dims_per_head=3, shift=False, cross=False))
    assert not fake_library.calls
