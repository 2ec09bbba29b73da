"""The launch plan of the fused block's forward without dropout (``csrc/fused_block_fwd.cu``:
K4 on the image, K1 on window-packed tokens), on the CPU: the route, launches and shared
memory of each of the default model's ten (stage, MLP width) shapes, K1's plan at the packed
stages (the fp32 plan in both dtypes: K1 is fp32 inside), what the wrapper hands the kernels
in both layouts (with a fake library and no CUDA runtime: the layout, the rounding mode, the
scratch dtypes), that a dropout forward in either layout runs the same entry point with its
dropout arguments (never the five launches of ``csrc/fused_block.cu``), and that shapes the
kernels do not take raise before any launch.
The kernels themselves run in ``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``."""

import contextlib

import pytest
import torch

from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import _build
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

CFG = ModelConfig()
# (stage, C, MLP hidden) of the default model's encoder and decoder blocks (the decoder's
# hidden is 4x its input width: 4 at stage 0)
SHAPES = tuple((k, c, hidden) for k, c in enumerate(CFG.out_dims_list)
               for hidden in (c * CFG.mlp_hidden_dims_ratio, CFG.in_dims_list[k] * CFG.mlp_hidden_dims_ratio))
# stage -> (route, heads per block)
ROUTES = {0: ("fused", 8), 1: ("fused", 8), 2: ("split", 4), 3: ("split", 2), 4: ("split", 1)}


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
        return 1 if self.name.endswith("_smem") else 0


class _FakeLibrary:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        fn = _FakeFunction(self.calls, name)
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_library(monkeypatch):
    """Both fused-block libraries replaced by one fake that records every launcher call,
    bound with the wrapper's own argtypes; ``lib.allocated`` maps the data pointer of every
    tensor that ``Tensor.new_empty`` made during the test to the tensor."""
    lib = _FakeLibrary()
    lib.allocated = {}
    new_empty = torch.Tensor.new_empty

    def recording_new_empty(self, *args, **kwargs):
        t = new_empty(self, *args, **kwargs)
        lib.allocated[t.data_ptr()] = t
        return t

    monkeypatch.setattr(torch.Tensor, "new_empty", recording_new_empty)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    for cached in (tfb._library, tfb._fwd_library, tfb._bwd_library):
        cached.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    yield lib
    for cached in (tfb._library, tfb._fwd_library, tfb._bwd_library):
        cached.cache_clear()


def _block_args(c, heads, d, hidden, hw=(14, 14), dtype=torch.float32):
    inner = heads * d
    x = torch.zeros(2, 1, *hw, c, dtype=dtype)

    def dense(i, o):
        return torch.zeros(2, i, o), torch.zeros(2, o)

    ln = (torch.ones(2, c), torch.zeros(2, c))
    return x, (*ln, *dense(c, inner), *dense(c, inner), *dense(c, inner), *dense(inner, c),
               torch.zeros(2, 49, 49), *ln, *dense(c, hidden), *dense(hidden, c))


def _kw(heads, d, shift=True, cross=True, layout="image", **extra):
    return dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift, cross=cross,
                layout=layout, hw=(14, 14) if layout == "windows" else None, **extra)


def _windows(x):
    """An image-layout x of a 14x14 map as the windows layout's (S, B, 4, 49, C)."""
    return x.reshape(x.shape[0], x.shape[1], 4, 49, x.shape[-1])


def _scratch_dtypes(lib, args):
    """The dtypes of the split route's scratch handed to ``swin_k4_fwd``: LN1(x), AV, y, hidden."""
    return [lib.allocated[p].dtype for p in args[19:23]]


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k,c,hidden", SHAPES, ids=[f"s{k}-C{c}-h{h}" for k, c, h in SHAPES])
def test_plan_of_each_shape(k, c, hidden, dtype, cross):
    """One launch with every head and the whole MLP in a block where two such blocks fit an
    SM (stages 0-1), the MLP in steps of as many hidden columns as one GEMM takes (144 fp32,
    192 bf16); else six launches (LN1, attention, projection, LN2, fc1 streaming LN2(y),
    fc2), a head group of at most 48 columns per q/k/v part and fc1 blocks of 144 / 192
    hidden columns; every block within the 227 KB a block may use."""
    bf16 = dtype == "bf16"
    d = CFG.dims_per_head(c)
    plan = tfb.block_fwd_plan(c, CFG.att_num_heads, d, hidden, CFG.window_size, cross, bf16)
    route, hg = ROUTES[k]
    cols = 192 if bf16 else 144
    assert (plan.route, plan.heads_per_block) == (route, hg)
    assert plan.pitch == {3: 4, 6: 8, 12: 12, 24: 24, 48: 48}[d]
    if route == "fused":
        assert plan.launches == 1 and plan.hidden_chunk == min(hidden, cols)
        ((kind, smem),) = plan.smem
        assert kind == "fused" and 0 < smem <= tfb.FUSED_SMEM_MAX
        # three blocks an SM where they fit: stage 0 in fp32
        assert plan.blocks_per_sm == (3 if k == 0 and not bf16 else 2)
        assert (plan.blocks_per_sm == 3) == (smem <= tfb.SMEM_THREE_PER_SM)
    else:
        assert plan.launches == 6 and plan.hidden_chunk == cols and plan.blocks_per_sm == 0
        assert [kind for kind, _ in plan.smem] == ["ln", "attention", "rows", "ln", "fc1", "rows"]
        assert all((smem == 0) == (kind == "ln") and smem <= tfb.SMEM_LIMIT_BYTES for kind, smem in plan.smem)
        assert hg * d <= tfb.GROUP_COLS and (hg * d) % 8 == 0


def test_shared_memory_counts_every_buffer():
    """Stage 1, cross, encoder MLP (hidden 192), fused. fp32: the weight ring (3 slots x 16
    channels x 144 columns), x/y (49 x 48), LN1(x) and LN1(kv) resident (48 x 60 each), q/k/v
    of 8 heads at pitch 8 (which the kv rows and the 144-column hidden step, 144 x 60, reuse),
    the bias table, the row, region, column and bias tables (2 x 64 + 2 x 192) and the LN
    statistics of x and kv (2 x 64 x 2). bf16: the P
    rows (8 warps x 32 x 72 halves) over the weight ring (3 x 16 x 196 with the 192-column
    step), operands 64 x 56 halves, v^T (8 heads x 8 x 72). Split, stage 4, fp32, cross:
    attention K3's split block (on LN1(x)), fc1 the LN2 pass's scratch and its weights
    streamed through two rings three deep and a row table (two blocks an SM), proj and fc2
    K3's projection block, LN1 and LN2 none."""
    tables = 9616 + 2048 + 1024
    fp32 = 3 * 16 * 144 * 4 + 49 * 48 * 4 + 2 * 48 * 60 * 4 + 3 * (8 * 49 * 8 * 4) + tables
    bf16 = 3 * 16 * 196 * 4 + 49 * 48 * 4 + 2 * 64 * 56 * 2 + 2 * (8 * 49 * 8 * 4) + 8 * 8 * 72 * 2 + tables
    assert tfb.block_smem("fused", False, True, 48, 48, 8, 6, 8, 144) == fp32 == 110416
    assert tfb.block_smem("fused", True, True, 48, 48, 8, 6, 8, 192) == bf16 == 108368
    assert max(8 * 32 * 72 * 2, 3 * 16 * 196 * 4) == 3 * 16 * 196 * 4
    attention = 3 * 2 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 3 * (49 * 48 * 4) + 9616 + 2816
    assert tfb.block_smem("attention", False, True, 384, 384, 1, 48, 48, 144) == attention
    assert attention == twa.attention_smem(False, False, True, 384, 384, 1, 48, 48)
    fc1 = 3 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 64 * 4
    assert tfb.block_smem("fc1", False, True, 384, 384, 1, 48, 48, 144) == fc1 <= tfb.SMEM_LIMIT_BYTES // 2
    assert tfb.block_smem("rows", False, True, 384, 384, 1, 48, 48, 144) == 6 * 16 * 60 * 4 + 6 * 16 * 48 * 4 + 512
    assert tfb.block_smem("ln", False, True, 384, 384, 1, 48, 48, 144) == 0


def test_a_wide_block_takes_four_launches():
    """Where q/k/v of every head exceed one GEMM's columns, or two blocks of the one-launch
    route do not fit an SM, the plan takes six launches; a hidden wider than one GEMM's
    columns is stepped through."""
    assert tfb.block_fwd_plan(48, 8, 6, 384, (7, 7), True, False).hidden_chunk == 144
    assert tfb.block_fwd_plan(64, 8, 8, 256, (7, 7), True, False).route == "split"  # 192 q/k/v columns
    assert tfb.block_fwd_plan(64, 8, 8, 256, (7, 7), True, True).route == "fused"
    assert tfb.block_smem("fused", True, True, 128, 16, 1, 16, 16, 192) > tfb.FUSED_SMEM_MAX
    assert tfb.block_fwd_plan(128, 1, 16, 512, (7, 7), True, True).route == "split"


@pytest.mark.parametrize("what,c,heads,d,hidden,window", [
    ("window", 24, 8, 3, 96, (8, 8)),
    ("dims per head", 512, 8, 64, 2048, (7, 7)),
    ("multiples of 8", 20, 4, 5, 80, (7, 7)),
    ("hidden multiple of 4", 24, 8, 3, 98, (7, 7)),
    ("split channels", 512, 16, 32, 2048, (7, 7)),
])
def test_plan_raises_on_shapes_the_kernels_do_not_take(what, c, heads, d, hidden, window):
    with pytest.raises(ValueError):
        tfb.block_fwd_plan(c, heads, d, hidden, window, False, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,hidden", [(24, 4), (96, 384)], ids=["C24-fused", "C96-split"])
def test_image_call_without_dropout_launches_the_new_forward(fake_library, c, hidden, dtype):
    """The plan reaches the launcher (head group, hidden step, the fused flag, scratch only
    on the split route, the dtype form) through arguments that match its ctypes signature,
    the five launches are not called, and the call counts once in its dtype's counter."""
    d = CFG.dims_per_head(c)
    x, weights = _block_args(c, 8, d, hidden, dtype=dtype)
    before = (tfb.LAUNCHES, tfb.BF16_LAUNCHES)
    out = tfb._launch_fwd(x, weights, _kw(8, d, drop_rates=(0.0, 0.0, 0.0), drop_seed=None))
    assert out.dtype == dtype and out.shape == x.shape
    bf16 = dtype == torch.bfloat16
    plan = tfb.block_fwd_plan(c, 8, d, hidden, (7, 7), True, bf16)
    (args,) = fake_library.calls["swin_k4_fwd"]
    fused = plan.route == "fused"
    # no dropout arguments; ..., fused, shift, cross, windows layout, bf16 I/O, bf16 operands
    # (K4's rounding)
    assert args[23] is None
    assert args[24:40] == (2, 1, 14, 14, c, 8, d, hidden, plan.heads_per_block, plan.hidden_chunk,
                           int(fused), 1, 1, 0, int(bf16), int(bf16))
    assert [a is None for a in args[19:23]] == [fused] * 4
    if not fused:  # LN1(x), AV and the hidden in x's dtype (K4 rounds them), y fp32
        assert _scratch_dtypes(fake_library, args) == [dtype, dtype, torch.float32, dtype]
    assert "swin_fused_block_fwd" not in fake_library.calls
    assert (tfb.LAUNCHES, tfb.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


# K1: the windows layout at the stages cuda_pack packs (stages 0-3 at 512²), both MLP widths
PACKED_SHAPES = tuple(shape for shape in SHAPES if shape[0] < 4)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("k,c,hidden", PACKED_SHAPES, ids=[f"s{k}-C{c}-h{h}" for k, c, h in PACKED_SHAPES])
def test_windows_plan_of_each_packed_shape(fake_library, k, c, hidden, dtype, cross):
    """K1 computes the block in fp32 inside whatever its I/O dtype, so both dtypes take the
    fp32 plan (stages 0-1 one launch, 2-3 six), and the wrapper hands the kernels that plan
    with the windows layout, x's I/O dtype and fp32 operands."""
    d = CFG.dims_per_head(c)
    assert not tfb.rounds_operands(dtype, "windows")
    plan = tfb.block_fwd_plan(c, CFG.att_num_heads, d, hidden, CFG.window_size, cross, False)
    assert (plan.route, plan.heads_per_block) == ROUTES[k]
    x, weights = _block_args(c, CFG.att_num_heads, d, hidden, dtype=dtype)
    tfb._launch_fwd(_windows(x), weights, _kw(CFG.att_num_heads, d, cross=cross, layout="windows",
                                              drop_rates=(0.0, 0.0, 0.0), drop_seed=None))
    (args,) = fake_library.calls["swin_k4_fwd"]
    assert args[32:40] == (plan.heads_per_block, plan.hidden_chunk, int(plan.route == "fused"), 1,
                           int(cross), 1, int(dtype == torch.bfloat16), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,hidden", [(24, 4), (96, 384)], ids=["C24-fused", "C96-split"])
def test_windows_call_without_dropout_launches_the_new_forward(fake_library, c, hidden, dtype):
    """K1 without dropout runs ``csrc/fused_block_fwd.cu``: the windows layout, x's I/O dtype,
    fp32 operands (K1 never rounds inside), the fp32 plan, and on the split route fp32
    scratch in both dtypes; the five launches are not called, and the call counts once in
    its dtype's counter."""
    d = CFG.dims_per_head(c)
    x, weights = _block_args(c, 8, d, hidden, dtype=dtype)
    before = (tfb.LAUNCHES, tfb.BF16_LAUNCHES)
    out = tfb._launch_fwd(_windows(x), weights, _kw(8, d, layout="windows", drop_rates=(0.0, 0.0, 0.0),
                                                    drop_seed=None))
    assert out.dtype == dtype and out.shape == (2, 1, 4, 49, c)
    bf16 = dtype == torch.bfloat16
    plan = tfb.block_fwd_plan(c, 8, d, hidden, (7, 7), True, False)
    (args,) = fake_library.calls["swin_k4_fwd"]
    fused = plan.route == "fused"
    assert args[24:40] == (2, 1, 14, 14, c, 8, d, hidden, plan.heads_per_block, plan.hidden_chunk,
                           int(fused), 1, 1, 1, int(bf16), 0)
    assert [a is None for a in args[19:23]] == [fused] * 4
    if not fused:
        assert _scratch_dtypes(fake_library, args) == [torch.float32] * 4
    assert "swin_fused_block_fwd" not in fake_library.calls
    assert (tfb.LAUNCHES, tfb.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


@pytest.mark.parametrize("what", ["windows layout dropout", "dropout", "backward"])
def test_windows_dropout_and_backward_keep_the_five_launches(fake_library, what):
    """A dropout forward in either layout (K1's and K4's) runs ``swin_k4_fwd`` of
    ``csrc/fused_block_fwd.cu`` with its dropout arguments (the five launches of
    ``csrc/fused_block.cu`` no longer); a dropout backward at stage 0 runs the dropout form of
    ``csrc/fused_block_bwd.cu``'s fused route, which recomputes the forward itself
    (``tests/test_torch_block_fwd_drop.py`` holds the dropout forward's routes at every stage,
    ``tests/test_torch_block_bwd_drop.py`` the dropout backward's)."""
    x, weights = _block_args(24, 8, 3, 96)
    if what == "windows layout dropout":
        tfb._launch_fwd(_windows(x), weights, _kw(8, 3, layout="windows", drop_rates=(0.25, 0.0, 0.1),
                                                   drop_seed=9))
        name = "swin_k4_fwd"
    elif what == "dropout":
        tfb._launch_fwd(x, weights, _kw(8, 3, drop_rates=(0.25, 0.0, 0.1), drop_seed=9))
        name = "swin_k4_fwd"
    else:
        tfb._launch_bwd(x, x, weights, _kw(8, 3, drop_rates=(0.25, 0.0, 0.1), drop_seed=9))
        name = "swin_block_bwd"
    (args,) = fake_library.calls[name]
    if name == "swin_k4_fwd":
        drop = args[23].contents
        assert list(drop.on) == [1, 0, 1, 1] and drop.pairs == int(what == "windows layout dropout")
        assert args[34] == 1, "the one-launch route at C = 24"
    assert "swin_fused_block_fwd" not in fake_library.calls
    assert ("swin_k4_fwd" in fake_library.calls) == (name == "swin_k4_fwd")


def test_launch_raises_before_any_call_on_a_shape_it_does_not_take(fake_library):
    x, weights = _block_args(24, 8, 3, 98)
    with pytest.raises(ValueError, match="hidden"):
        tfb._launch_fwd(x, weights, _kw(8, 3))
    assert "swin_k4_fwd" not in fake_library.calls and "swin_fused_block_fwd" not in fake_library.calls
