"""The launch plan of the fused block's backward without dropout (K1 bwd and K4 bwd), on the
CPU: ``block_bwd_plan``'s route, launches, shared memory and workspace at every stage of the
default model at 224² batch 20, 512² and 100x90 (the fused route of
``csrc/fused_block_bwd.cu`` where one window's block fits, the five-launch backward of
``csrc/fused_block.cu`` elsewhere), the same plan for both dtypes, what ``_launch_bwd`` hands
the kernels (a fake library that checks ctypes' argument counts), that dropout keeps
``swin_fused_block_bwd`` and that shapes no backward takes raise before any launch. The
kernels themselves run in ``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``."""

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
    stages 2-4 the five-launch backward (twenty launches), whose core backward fits too. The
    fused route's workspace is what the tokens need (LN1(x) and its statistics, q, k, v, AV,
    y, g_y, g_o, LN2(y), the hidden and g_pre, g_q/g_k/g_v, g_ln and under cross its k/v side)
    plus the transposed weights and partial sums, which stay below 64 MB."""
    d = CFG.dims_per_head(c)
    plan = tfb.block_bwd_plan(c, CFG.att_num_heads, d, hidden, CFG.window_size, cross)
    assert all(0 < smem <= tfb.SMEM_LIMIT_BYTES for _, smem in plan.smem)
    if k > 1:
        assert (plan.route, plan.launches, plan.blocks_per_sm) == ("five", 20, ())
        assert [kind for kind, _ in plan.smem] == ["core_bwd"]
        return
    assert (plan.route, plan.launches) == ("fused", 7)
    assert plan.pitch == {3: 4, 6: 8}[d] and plan.hidden_chunk == min(hidden, 144)
    assert [kind for kind, _ in plan.smem] == list(tfb.BWD_KERNELS)
    assert plan.blocks_per_sm == (2, 2, 2) and all(smem <= tfb.SMEM_TWO_PER_SM for _, smem in plan.smem)
    assert plan.smem == tuple((kernel, tfb.bwd_smem(kernel, c, c, CFG.att_num_heads, plan.pitch, plan.hidden_chunk,
                                                  cross)) for kernel in tfb.BWD_KERNELS)
    h, w = _stage_map(hw, k)
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
    """Another window, d > 8, more than 144 q/k/v columns or a hidden that is not a
    multiple of 4 run the five-launch backward, which takes any of them."""
    assert tfb.block_bwd_plan(24, 8, 3, 96, (8, 8), True).route == "five"
    assert tfb.block_bwd_plan(64, 2, 32, 256, (7, 7), True).route == "five"
    assert tfb.block_bwd_plan(96, 8, 12, 384, (7, 7), True).route == "five"
    assert tfb.block_bwd_plan(64, 8, 8, 256, (7, 7), True).route == "five"
    assert tfb.block_bwd_plan(24, 8, 3, 98, (7, 7), True).route == "five"
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
    for cached in (tfb._library, tfb._fwd_library, tfb._bwd_library):
        cached.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    yield lib
    for cached in (tfb._library, tfb._fwd_library, tfb._bwd_library):
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
    ins, outs, ws, floats = args[:4]
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
    assert args[4:20] == (2, 1, 14, 14, 24, 8, 3, 96, plan.hidden_chunk, *blocks, 1, 1,
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
    assert first[3] == last[3] and first[4:19] == last[4:19]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_five_route_and_dropout_run_the_five_launch_backward(fake_library, dtype):
    """Stage 2's shape without dropout, and stage 0's with dropout, run
    ``swin_fused_block_bwd``; the dropout call counts in the dropout counter."""
    x, weights = _block_args(96, 8, 12, 384, dtype)
    tfb._launch_bwd(torch.zeros_like(x), x, weights, _kw(12))
    x, weights = _block_args(24, 8, 3, 96, dtype)
    before = (tfb.DROP_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES)
    tfb._launch_bwd(torch.zeros_like(x), x, weights, _kw(3, drop_rates=(0.1, 0.0, 0.1), drop_seed=4))
    assert len(fake_library.calls["swin_fused_block_bwd"]) == 2
    assert "swin_block_bwd" not in fake_library.calls
    bf16 = dtype == torch.bfloat16
    assert (tfb.DROP_BWD_LAUNCHES, tfb.BF16_DROP_BWD_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


def test_out_of_range_shapes_raise_before_any_launch(fake_library):
    x, weights = _block_args(512, 8, 64, 2048)
    with pytest.raises(ValueError, match="C <= 384"):
        tfb._launch_bwd(torch.zeros_like(x), x, weights, _kw(64))
    x, weights = _block_args(24, 8, 3, 96)
    with pytest.raises(ValueError, match="output gradient"):
        tfb._launch_bwd(torch.zeros(2, 1, 14, 14, 24, dtype=torch.bfloat16), x, weights, _kw(3))
    assert not fake_library.calls
