"""The launch plan of the fused block's backward without dropout (K1 bwd and K4 bwd), on the
CPU: ``block_bwd_plan``'s route, launches, shared memory and workspace at every stage of the
default model at 224² batch 20, 512² and 100x90 (the fused route of
``csrc/fused_block_bwd.cu`` where one window's block fits, its split route at stages 2-4), the
same plan for both dtypes, what ``_launch_bwd`` hands the kernels (a fake library that checks
ctypes' argument counts), that stage 4 reaches ``swin_block_bwd_split`` with and without
dropout and never the twenty launches of ``csrc/fused_block.cu`` while dropout at stage 0
takes the fused route, and that shapes no backward takes raise before any launch
(``tests/test_torch_block_bwd_drop.py`` holds the dropout form's plan at every stage). The kernels themselves run in ``tests/test_torch_kernel_gpu.py`` and
``chip_smoke.py``."""

import contextlib

import pytest
import torch

from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import _build
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan

CFG = ModelConfig()
# (stage, C, MLP hidden) of the default model's encoder and decoder blocks
SHAPES = tuple((k, c, hidden) for k, c in enumerate(CFG.out_dims_list)
               for hidden in (c * CFG.mlp_hidden_dims_ratio, CFG.in_dims_list[k] * CFG.mlp_hidden_dims_ratio))
# (input map, batch): the training step's and the two serving inputs of the card checks
MAPS = (((224, 224), 20), ((512, 512), 1), ((100, 90), 1))


def _stage_map(hw, k):
    return make_plan(*hw, CFG.num_stages, CFG.merging_size, CFG.window_size)[k].att_hw


@pytest.mark.parametrize("hw,batch", MAPS, ids=["224x224x20", "512x512", "100x90"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("k,c,hidden", SHAPES, ids=[f"s{k}-C{c}-h{h}" for k, c, h in SHAPES])
def test_plan_of_each_shape(k, c, hidden, cross, hw, batch):
    """Stages 0-1 (C <= 48) take the fused route: seven launches, every head in a block (q/k
    row pitch 4 or 8), the hidden in steps of at most 144 columns, each of the three block
    kernels two blocks an SM within the 113 KB that allows (and the 227 KB a block may use);
    stages 2-4 (C = 96, 192 and 384) the split route: eleven launches, the recomputed attention
    and K3's backward block in groups of four heads of d = 12 (stage 2), two of d = 24 (stage 3)
    or one of d = 48 (stage 4, K3's block on its tiled core, one block an SM), the MLP backward
    two blocks an SM at C = 96 and one at C = 192 and 384 (224 KB), the g_ln product two but at
    C = 384 under cross (174 KB), where the MLP backward is stepped (a block a hidden step of
    144 columns) and the g_ln product grouped (a block a column group of 128). The fused and
    split routes' workspaces are what the tokens need (fused: LN1(x) and its statistics, q, k,
    v, AV, y, g_y, g_o, LN2(y), the hidden and g_pre, g_q/g_k/g_v, g_ln and under cross its k/v
    side; split the same but q, k, v, g_o and g_ln, and at stage 4 each hidden step's g_lny and
    g_ln's two sides) plus the transposed weights and partial sums, which stay below 64 MB."""
    d = CFG.dims_per_head(c)
    plan = tfb.block_bwd_plan(c, CFG.att_num_heads, d, hidden, CFG.window_size, cross)
    assert all(0 < smem <= tfb.SMEM_LIMIT_BYTES for _, smem in plan.smem)
    h, w = _stage_map(hw, k)
    if k > 1:
        assert (plan.route, plan.launches, plan.pitch) == ("split", 11, {12: 12, 24: 24, 48: 48}[d])
        assert plan.heads_per_block == {12: (4, 4), 24: (2, 2), 48: (1, 1)}[d]
        assert plan.groups == 8 // plan.heads_per_block[1]
        assert plan.hidden_chunk == min(hidden, 144) and [kind for kind, _ in plan.smem] == list(tfb.SPLIT_KERNELS)
        assert plan.smem == tuple((kernel, tfb.split_smem(kernel, c, c, d, plan.hidden_chunk, *plan.heads_per_block,
                                                         cross)) for kernel in tfb.SPLIT_KERNELS)
        assert plan.blocks_per_sm == ({96: 2, 192: 1, 384: 1}[c], {12: 2, 24: 1, 48: 1}[d],
                                      1 if c == 384 and cross else 2)
        mlp_blocks, k3_blocks, gln_blocks = blocks = plan.blocks(2, batch, h, w)
        assert 1 <= min(mlp_blocks, gln_blocks) and max(mlp_blocks, gln_blocks) <= min(batch * h * w // 49,
                                                                                      tfb.DEFAULT_SMS)
        assert 1 <= k3_blocks <= min(batch * (h // 7) * (w // 7), tfb.DEFAULT_SMS)
        floats = tfb.split_workspace_floats(2, batch, h, w, c, CFG.att_num_heads, d, hidden, plan, blocks)
        steps, groups = plan.split_steps
        assert (steps, groups) == ({1536: 11, 768: 6}[hidden], 3) if d == 48 else (steps, groups) == (1, 1)
        per_token = 8 * c + 2 + 2 * hidden + (steps + 2 * (groups > 1)) * c * (d == 48)
        assert 0 <= floats - 2 * batch * h * w * per_token < 16 * 2**20
        return
    assert (plan.route, plan.launches) == ("fused", 7)
    assert plan.pitch == {3: 4, 6: 8}[d] and plan.hidden_chunk == min(hidden, 144)
    assert [kind for kind, _ in plan.smem] == list(tfb.BWD_KERNELS)
    assert plan.blocks_per_sm == (2, 2, 2) and all(smem <= tfb.SMEM_TWO_PER_SM for _, smem in plan.smem)
    assert plan.smem == tuple((kernel, tfb.bwd_smem(kernel, c, c, CFG.att_num_heads, plan.pitch, plan.hidden_chunk,
                                                  cross)) for kernel in tfb.BWD_KERNELS)
    blocks = plan.blocks(2, batch, h, w)
    assert all(1 <= n <= min(batch * (h // 7) * (w // 7), tfb.DEFAULT_SMS) for n in blocks)
    floats = tfb.bwd_workspace_floats(2, batch, h, w, c, CFG.att_num_heads, d, hidden, blocks, cross)
    per_token = 5 * c + 2 + 8 * c + 2 * hidden + (c if cross else 0)
    assert 0 <= floats - 2 * batch * h * w * per_token < 16 * 2**20


def test_the_plan_is_one_for_both_dtypes_and_layouts():
    """The backward is fp32 inside for K1 and K4 in either dtype: the plan takes no dtype or
    layout. At stage 1 cross the forward's block holds the weight ring (2 x 16 x 144
    columns), x/y and the kv rows (49 x 48 each), LN1(x) and AV resident (48 x 60 each), q/k/v
    (8 heads x 49 x 8, over LN1(kv) and the 144-column MLP step), the bias table and the
    tables; the MLP backward's the ring, y and the row buffer, g resident, the 144-column
    step's g_pre and the LN2 statistics and sums; the attention backward's the ring of the
    48-column g_ln products, q/k/v/g_o, g_q | g_k | g_v (144 x 60), the core's row sums (8 x 49
    x 8 bytes), a row buffer, the bias table and the row tables."""
    tables = (3 * 64 + 2 * 192) * 4 + 3 * 64 * 8
    forward = 2 * 16 * 144 * 4 + 2 * 49 * 48 * 4 + 2 * 48 * 60 * 4 + 3 * (8 * 49 * 8 * 4) + 9616 + tables
    mlp = 2 * 16 * 144 * 4 + 2 * 49 * 48 * 4 + 48 * 60 * 4 + 144 * 60 * 4 + 64 * 8 + 2 * 48 * 4
    attention = 2 * 16 * 48 * 4 + 4 * (8 * 49 * 8 * 4) + 144 * 60 * 4 + 8 * 49 * 8 + 49 * 48 * 4 + 9616 + 3 * 64 * 4
    plan = tfb.block_bwd_plan(48, 8, 6, 192, (7, 7), True)
    assert plan.smem == (("forward", forward), ("mlp", mlp), ("attention", attention))
    assert (forward, mlp, attention) == (111_376, 84_224, 113_808)
    assert [b for _, b in tfb.block_bwd_plan(24, 8, 3, 96, (7, 7), False).smem] == [68_848, 53_120, 65_584]


def test_workspace_counts_every_buffer():
    """Stage 0, encoder MLP, cross, at 224² batch 20 on a 132-SM card: 132 blocks per stream
    in each kernel; the token buffers (LN1(x), y, g_y, LN2(y) and both sides of g_ln of C = 24
    columns, the statistics, q, k, v, AV, g_o, g_q, g_k and g_v of 24, the hidden and g_pre of
    96), the transposed weights, the partials of the bias table (49 x 49) per attention block,
    of LN2 per MLP block and of LN1 per 128 rows, and the weight gradients' chunks (as
    window_bwd.cuh's wg_chunk_rows cuts the rows)."""
    plan = tfb.block_bwd_plan(24, 8, 3, 96, (7, 7), True)
    m, blocks = 20 * 112 * 112, plan.blocks(2, 20, 112, 112)
    assert blocks == (132, 132, 132)
    tokens = 2 * m * (24 * 6 + 2 + 24 * 8 + 96 * 2)
    weights = 2 * (3 * 24 * 24 + 24 * 24 + 2 * 24 * 96)
    partials = 2 * 132 * (49 * 49 + 48) + 2 * (m // 128) * 48
    chunks = 2 * 88 * (3 * 25 * 24 + 25 * 24 + 25 * 96 + 97 * 24)
    expected = tokens + weights + partials + chunks
    assert tfb._wgrad_chunks(m, 12) == 88  # 1,056 blocks for 12 weights, whole slabs of 64 rows
    floats = tfb.bwd_workspace_floats(2, 20, 112, 112, 24, 8, 3, 96, blocks, True)
    assert expected <= floats < expected + 32 * 26  # every piece rounded up to 32 floats


@pytest.mark.parametrize("what,c,heads,d,hidden,window", [
    ("channels", 512, 8, 64, 2048, (7, 7)),
    ("shared memory", 384, 1, 384, 1536, (7, 7)),
])
def test_plan_raises_where_no_backward_takes_the_shape(what, c, heads, d, hidden, window):
    with pytest.raises(ValueError):
        tfb.block_bwd_plan(c, heads, d, hidden, window, False)


def test_shapes_outside_the_fused_route_take_the_five_launches():
    """Outside the fused route, the split route takes heads of d = 12, 24 and 48 (row pitches
    12, 24 and 48: d = 20 in groups of two, d = 12 in groups of four, d = 48 one a block);
    another window, d <= 8 with more than 144 q/k/v columns, the other row pitches (d = 16, 32)
    or a hidden that is not a multiple of 4 run the five-launch backward, which takes any of
    them."""
    assert tfb.block_bwd_plan(24, 8, 3, 96, (8, 8), True).route == "five"
    assert tfb.block_bwd_plan(64, 2, 32, 256, (7, 7), True).route == "five"
    plan = tfb.block_bwd_plan(80, 4, 20, 320, (7, 7), True)
    assert (plan.route, plan.pitch, plan.heads_per_block, plan.groups) == ("split", 24, (2, 2), 2)
    assert tfb.block_bwd_plan(96, 8, 12, 384, (7, 7), True).route == "split"
    assert tfb.block_bwd_plan(64, 4, 16, 256, (7, 7), True).route == "five"
    assert tfb.block_bwd_plan(64, 8, 8, 256, (7, 7), True).route == "five"
    assert tfb.block_bwd_plan(24, 8, 3, 98, (7, 7), True).route == "five"
    assert tfb.block_bwd_plan(384, 8, 48, 1536, (7, 7), False).route == "split"
    assert tfb.block_bwd_plan(16, 2, 8, 64, (7, 7), True).route == "fused"


class _FakeFunction:
    """A launcher with ctypes' argument check: a call must pass one argument per argtype."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name
        self.argtypes, self.restype = None, None

    def __call__(self, *args):
        if self.argtypes is not None:
            assert len(args) == len(self.argtypes), f"{self.name}: {len(args)} arguments, " \
                                                    f"{len(self.argtypes)} argtypes"
        self.calls.setdefault(self.name, []).append(args)
        return 1 if self.name.endswith(("_smem", "_workspace")) else 0


class _FakeLibrary:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        fn = _FakeFunction(self.calls, name)
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_library(monkeypatch):
    """Every fused-block library replaced by one fake that records each launcher call,
    bound with the wrapper's own argtypes, and no CUDA runtime."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    for cached in (tfb._library, tfb._fwd_library, tfb._bwd_library, tfb._split_library):
        cached.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    yield lib
    for cached in (tfb._library, tfb._fwd_library, tfb._bwd_library, tfb._split_library):
        cached.cache_clear()


def _block_args(c, heads, d, hidden, dtype=torch.float32, layout="image"):
    inner = heads * d
    x = torch.zeros(2, 1, 14, 14, c, dtype=dtype)
    if layout == "windows":
        x = x.reshape(2, 1, 4, 49, c)

    def dense(i, o):
        return torch.zeros(2, i, o), torch.zeros(2, o)

    ln = (torch.ones(2, c), torch.zeros(2, c))
    return x, (*ln, *dense(c, inner), *dense(c, inner), *dense(c, inner), *dense(inner, c),
               torch.zeros(2, 49, 49), *ln, *dense(c, hidden), *dense(hidden, c))


def _kw(d, layout="image", cross=True, **extra):
    return dict(window=(7, 7), num_heads=8, dims_per_head=d, shift=True, cross=cross, layout=layout,
                hw=(14, 14), **extra)


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_route_gets_x_g_and_gradients_in_their_dtypes(fake_library, dtype, layout):
    """Stage 0's shape without dropout launches ``swin_block_bwd`` once with x and g as
    handed in, g_x in x's dtype and every weight gradient fp32, the plan's hidden step and
    block counts, the workspace the plan sizes (fp32), the layout and dtype flags, and
    counts once in its dtype's counter; the five-launch backward is not called."""
    x, weights = _block_args(24, 8, 3, 96, dtype, layout)
    g = torch.zeros_like(x)
    before = (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES)
    new_empty = torch.Tensor.new_empty
    made = {}

    def recording_new_empty(self, *args, **kwargs):
        t = new_empty(self, *args, **kwargs)
        made[t.data_ptr()] = t
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "new_empty", recording_new_empty)
        grads = tfb._launch_bwd(g, x, weights, _kw(3, layout))
    (args,) = fake_library.calls["swin_block_bwd"]
    ins, outs, ws, floats, drop = args[:5]
    assert drop is None, "no dropout arguments without dropout"
    assert list(ins)[0] == x.data_ptr() and list(ins)[-1] == g.data_ptr() and len(list(ins)) == 19
    assert list(outs) == [t.data_ptr() for t in grads]
    assert grads[0].dtype == dtype and grads[0].shape == x.shape
    assert all(t.dtype == torch.float32 and t.shape == w.shape for t, w in zip(grads[1:], weights))
    plan = tfb.block_bwd_plan(24, 8, 3, 96, (7, 7), True)
    blocks = plan.blocks(2, 1, 14, 14)
    assert made[ws].dtype == torch.float32 and made[ws].numel() == floats
    assert floats == tfb.bwd_workspace_floats(2, 1, 14, 14, 24, 8, 3, 96, blocks, True)
    bf16 = dtype == torch.bfloat16
    # S, B, H, W, C, heads, d, hidden, hidden step, blocks of each kernel, shift, cross, windows, bf16
    assert args[5:21] == (2, 1, 14, 14, 24, 8, 3, 96, plan.hidden_chunk, *blocks, 1, 1,
                          int(layout == "windows"), int(bf16))
    assert "swin_fused_block_bwd" not in fake_library.calls
    assert (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_both_dtypes_hand_the_kernels_one_plan(fake_library, dtype):
    """fp32 and bf16 calls of one shape pass the same hidden step, blocks and workspace."""
    for dt in (torch.float32, dtype):
        x, weights = _block_args(48, 8, 6, 192, dt)
        tfb._launch_bwd(torch.zeros_like(x), x, weights, _kw(6, cross=False))
    first, last = fake_library.calls["swin_block_bwd"]
    assert first[3] == last[3] and first[5:20] == last[5:20]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["stage4", "stage4-dropout", "stage0-dropout", "five", "five-dropout"])
def test_five_route_and_dropout_run_the_five_launch_backward(fake_library, dtype, case):
    """Stage 4's shape (C = 384, d = 48) runs the split route (``swin_block_bwd_split``) with
    and without dropout, never the twenty launches of ``swin_fused_block_bwd``; stage 0's with
    dropout runs the fused route's dropout form (``swin_block_bwd`` with the call's dropout
    arguments); a shape outside the default model that plans "five" (d = 16, a row pitch neither
    route takes) runs ``swin_fused_block_bwd`` with and without dropout, the dropout arguments
    its fourth. A dropout call counts in its dtype's dropout counter, a call without dropout in
    its dtype's counter."""
    stage = case.split("-")[0]
    drop = case.endswith("dropout")
    c, d, hidden = {"stage4": (384, 48, 1536), "stage0": (24, 3, 96), "five": (128, 16, 512)}[stage]
    assert (tfb.block_bwd_plan(c, 8, d, hidden, (7, 7), True, drop).route == "five") == (stage == "five")
    x, weights = _block_args(c, 8, d, hidden, dtype)
    extra = dict(drop_rates=(0.1, 0.0, 0.1), drop_seed=4) if drop else {}
    before = (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES)
    tfb._launch_bwd(torch.zeros_like(x), x, weights, _kw(d, **extra))
    if stage == "stage4":
        (args,) = fake_library.calls["swin_block_bwd_split"]
        assert "swin_block_bwd" not in fake_library.calls and "swin_fused_block_bwd" not in fake_library.calls
        pointer = args[4]
    elif stage == "five":
        (args,) = fake_library.calls["swin_fused_block_bwd"]
        assert "swin_block_bwd" not in fake_library.calls and "swin_block_bwd_split" not in fake_library.calls
        pointer = args[3]
    else:
        (args,) = fake_library.calls["swin_block_bwd"]
        assert "swin_fused_block_bwd" not in fake_library.calls and "swin_block_bwd_split" not in fake_library.calls
        pointer = args[4]
    assert (pointer is not None) == drop, "the dropout arguments exactly when the call drops"
    if drop:
        assert list(pointer.contents.on) == [1, 0, 1, 1]
    bf16 = dtype == torch.bfloat16
    slot = 2 * drop + bf16
    assert (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES) == tuple(
        n + (i == slot) for i, n in enumerate(before))


def test_the_split_plan_counts_every_buffer():
    """Stage 2, encoder MLP, cross: the recomputed attention's block holds K3's split attention
    block (the x rings of both streams, 3 x 16 x 60 floats each, and the weight ring of 3 x 16
    x 144 columns; q/k/v of four heads [4][49][12]; the bias and the tables); the projection
    rows' and fc1's the forward's rings; the MLP backward's weight ring (2 x 16 x 144: the
    hidden step is wider than the 96-column g_lny groups), the g_lny sums [49][96], g resident
    (96 x 60), the step's g_pre (144 x 60), the LN2 statistics and sums; K3's block its rings
    (2 x 16 x 60 of both streams, 2 x 16 x 144 weights), q/k/v/g_o [4][49][12], the row sums,
    the bias and tables; the g_ln product's rings (2 x 16 x 60, 2 x 16 x 96), both sides of
    LN1(x)'s gradient [49][96], the row table, LN1 statistics and sums; the stepped MLP
    backward's LN2 epilogue the g_lny sums [49][96], the LN2 statistics and sums; the grouped g_ln
    product's LN1 epilogue both sides of LN1(x)'s gradient, the LN1 statistics and sums. At stage
    3 (C = 192) the MLP backward's g_lny sums and g double: 136 KB, one block an SM."""
    tables = 9616 + (2 * 64 + 3 * 192) * 4
    attention = 3 * 2 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 3 * (4 * 49 * 12 * 4) + tables
    mlp = 2 * 16 * 144 * 4 + 49 * 96 * 4 + 96 * 60 * 4 + 144 * 60 * 4 + 64 * 8 + 2 * 96 * 4
    k3 = 2 * 2 * 16 * 60 * 4 + 2 * 16 * 144 * 4 + 4 * (4 * 49 * 12 * 4) + 4 * 49 * 8 + 9616 + (3 * 64 + 2 * 192) * 4
    gln = 2 * 16 * 60 * 4 + 2 * 16 * 96 * 4 + 2 * 49 * 96 * 4 + 64 * 4 + 64 * 8 + 2 * 96 * 4
    plan = tfb.block_bwd_plan(96, 8, 12, 384, (7, 7), True)
    rows, fc1 = 6 * 16 * 60 * 4 + 6 * 16 * 48 * 4 + 2 * 64 * 4, 3 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 64 * 4
    ln2, ln1 = 49 * 96 * 4 + 64 * 8 + 2 * 96 * 4, 2 * 49 * 96 * 4 + 64 * 8 + 2 * 96 * 4
    assert plan.smem == (("attention", attention), ("rows", rows), ("fc1", fc1), ("mlp", mlp),
                         ("attention_bwd", k3), ("gln", gln), ("ln2", ln2), ("ln1", ln1))
    assert (attention, mlp, k3) == (91_344, 96_128, 84_912) and mlp <= tfb.SMEM_TWO_PER_SM
    stage3 = dict(tfb.block_bwd_plan(192, 8, 24, 768, (7, 7), True).smem)["mlp"]
    assert stage3 == mlp + 49 * 96 * 4 + 96 * 60 * 4 + 96 * 4 * 2 == 138_752 > tfb.SMEM_TWO_PER_SM


def test_the_split_workspace_counts_every_buffer():
    """Stage 3, encoder MLP, cross, at 224² batch 20 on a 132-SM card: 66 MLP blocks per stream
    (one an SM), 16 K3 blocks per stream and group of two heads and 80 g_ln blocks per stream
    (one per 49-token tile); the token buffers (LN1(x), y, LN2(y) and g_y of C = 192, the
    statistics, AV, g_q, g_k and g_v of 192, the hidden and g_pre of 768), the transposed
    weights, the partials of the bias table per K3 block, of LN2 per MLP block and of LN1 per
    g_ln block, and the weight gradients' chunks: seven, for sixteen of the 270 blocks of a
    chunk that do work (per stream 12 rectangles of 16 x 16 tiles for each of wq, wk, wv and wp,
    48 for w1, 39 for w2) an SM."""
    plan = tfb.block_bwd_plan(192, 8, 24, 768, (7, 7), True)
    m, blocks = 20 * 14 * 14, plan.blocks(2, 20, 14, 14)
    assert blocks == (66, 16, 80)
    tokens = 2 * m * (192 * 8 + 2 + 768 * 2)
    weights = 2 * (4 * 192 * 192 + 2 * 192 * 768)
    partials = 2 * (4 * 16 * 49 * 49 + 66 * 384 + 80 * 384)
    chunks = 2 * 7 * (4 * 193 * 192 + 193 * 768 + 769 * 192)
    expected = tokens + weights + partials + chunks
    assert tfb._wgrad_chunks(m, (4 * 12 + 48 + 39)) == 7
    floats = tfb.split_workspace_floats(2, 20, 14, 14, 192, 8, 24, 768, plan, blocks)
    assert expected <= floats < expected + 32 * 22  # every piece rounded up to 32 floats


@pytest.mark.parametrize("layout", ["image", "windows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_split_route_gets_x_g_and_gradients_in_their_dtypes(fake_library, dtype, layout):
    """Stage 2's shape without dropout launches ``swin_block_bwd_split`` once with x and g as
    handed in, g_x in x's dtype and every weight gradient fp32, the plan's hidden step, heads a
    block and block counts, the workspace the plan sizes (fp32), the layout and dtype flags,
    and counts once in its dtype's counter; neither the fused route nor the five-launch
    backward is called."""
    x, weights = _block_args(96, 8, 12, 384, dtype, layout)
    g = torch.zeros_like(x)
    before = (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES)
    new_empty = torch.Tensor.new_empty
    made = {}

    def recording_new_empty(self, *args, **kwargs):
        t = new_empty(self, *args, **kwargs)
        made[t.data_ptr()] = t
        return t

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "new_empty", recording_new_empty)
        grads = tfb._launch_bwd(g, x, weights, _kw(12, layout))
    (args,) = fake_library.calls["swin_block_bwd_split"]
    ins, outs, ws, floats, drop = args[:5]
    assert drop is None, "no dropout arguments without dropout"
    assert list(ins)[0] == x.data_ptr() and list(ins)[-1] == g.data_ptr() and len(list(ins)) == 19
    assert list(outs) == [t.data_ptr() for t in grads]
    assert grads[0].dtype == dtype and grads[0].shape == x.shape
    assert all(t.dtype == torch.float32 and t.shape == w.shape for t, w in zip(grads[1:], weights))
    plan = tfb.block_bwd_plan(96, 8, 12, 384, (7, 7), True)
    blocks = plan.blocks(2, 1, 14, 14)
    assert blocks == (4, 4, 4)  # one per 49-token tile, one per window, one per tile
    assert plan.split_steps == (1, 1)  # only stage 4 (pitch 48) steps its MLP backward
    assert made[ws].dtype == torch.float32 and made[ws].numel() == floats
    assert floats == tfb.split_workspace_floats(2, 1, 14, 14, 96, 8, 12, 384, plan, blocks, False)
    bf16 = dtype == torch.bfloat16
    # S, B, H, W, C, heads, d, hidden, hidden step, heads a block (recompute, K3 block), blocks
    # (MLP, K3, g_ln), shift, cross, windows, bf16
    assert args[5:23] == (2, 1, 14, 14, 96, 8, 12, 384, 144, 4, 4, *blocks, 1, 1, int(layout == "windows"), int(bf16))
    assert args[23] == pytest.approx(12**-0.5)
    assert "swin_fused_block_bwd" not in fake_library.calls and "swin_block_bwd" not in fake_library.calls
    assert (tfb.BWD_LAUNCHES, tfb.BF16_BWD_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


def test_out_of_range_shapes_raise_before_any_launch(fake_library):
    x, weights = _block_args(512, 8, 64, 2048)
    with pytest.raises(ValueError, match="C <= 384"):
        tfb._launch_bwd(torch.zeros_like(x), x, weights, _kw(64))
    x, weights = _block_args(24, 8, 3, 96)
    with pytest.raises(ValueError, match="output gradient"):
        tfb._launch_bwd(torch.zeros(2, 1, 14, 14, 24, dtype=torch.bfloat16), x, weights, _kw(3))
    assert not fake_library.calls
