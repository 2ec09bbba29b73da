"""The launch plan of K4's forward without dropout (``csrc/fused_block_fwd.cu``), on the CPU:
the route, launches and shared memory of each of the default model's ten (stage, MLP width)
shapes, what the wrapper hands the kernels (with a fake library and no CUDA runtime), that
the windows layout (K1), dropout and the backward keep the five launches of
``csrc/fused_block.cu``, and that shapes the kernels do not take raise before any launch.
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
    bound with the wrapper's own argtypes."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    tfb._library.cache_clear()
    tfb._fwd_library.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    yield lib
    tfb._library.cache_clear()
    tfb._fwd_library.cache_clear()


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
                layout=layout, hw=None, **extra)


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k,c,hidden", SHAPES, ids=[f"s{k}-C{c}-h{h}" for k, c, h in SHAPES])
def test_plan_of_each_shape(k, c, hidden, dtype, cross):
    """One launch with every head and the whole MLP in a block where two such blocks fit an
    SM (stages 0-1), the MLP in steps of as many hidden columns as one GEMM takes (144 fp32,
    192 bf16); else five launches (LN1, attention, projection, fc1, fc2), a head group of at
    most 48 columns per q/k/v part and fc1 blocks of 144 / 192 hidden columns; every block
    within the 227 KB a block may use."""
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
        assert plan.launches == 5 and plan.hidden_chunk == cols and plan.blocks_per_sm == 0
        assert [kind for kind, _ in plan.smem] == ["ln", "attention", "rows", "fc1", "rows"]
        assert plan.smem[0][1] == 0 and all(0 < smem <= tfb.SMEM_LIMIT_BYTES for _, smem in plan.smem[1:])
        assert hg * d <= tfb.GROUP_COLS and (hg * d) % 8 == 0


def test_shared_memory_counts_every_buffer():
    """Stage 1, cross, encoder MLP (hidden 192), fused. fp32: the weight ring (3 slots x 16
    channels x 144 columns), x/y (49 x 48), LN1(x) and LN1(kv) resident (48 x 60 each), q/k/v
    of 8 heads at pitch 8 (which the kv rows and the 144-column hidden step, 144 x 60, reuse),
    the bias table, the row, region, column and bias tables (2 x 64 + 2 x 192) and the LN
    statistics of x and kv (2 x 64 x 2). bf16: the P
    rows (8 warps x 32 x 72 halves) over the weight ring (3 x 16 x 196 with the 192-column
    step), operands 64 x 56 halves, v^T (8 heads x 8 x 72). Split, stage 4, fp32, cross:
    attention K3's split block (on LN1(x)), fc1 its ring, LN2(y) of 49 rows (384 x 60) and their
    statistics, proj and fc2 K3's projection block, LN1 none."""
    tables = 9616 + 2048 + 1024
    fp32 = 3 * 16 * 144 * 4 + 49 * 48 * 4 + 2 * 48 * 60 * 4 + 3 * (8 * 49 * 8 * 4) + tables
    bf16 = 3 * 16 * 196 * 4 + 49 * 48 * 4 + 2 * 64 * 56 * 2 + 2 * (8 * 49 * 8 * 4) + 8 * 8 * 72 * 2 + tables
    assert tfb.block_smem("fused", False, True, 48, 48, 8, 6, 8, 144) == fp32 == 110416
    assert tfb.block_smem("fused", True, True, 48, 48, 8, 6, 8, 192) == bf16 == 108368
    assert max(8 * 32 * 72 * 2, 3 * 16 * 196 * 4) == 3 * 16 * 196 * 4
    attention = 3 * 2 * 16 * 60 * 4 + 3 * 16 * 144 * 4 + 3 * (49 * 48 * 4) + 9616 + 2816
    assert tfb.block_smem("attention", False, True, 384, 384, 1, 48, 48, 144) == attention
    assert attention == twa.attention_smem(False, False, True, 384, 384, 1, 48, 48)
    assert tfb.block_smem("fc1", False, True, 384, 384, 1, 48, 48, 144) == 3 * 16 * 144 * 4 + 384 * 60 * 4 + 512
    assert tfb.block_smem("rows", False, True, 384, 384, 1, 48, 48, 144) == 6 * 16 * 60 * 4 + 6 * 16 * 48 * 4 + 512
    assert tfb.block_smem("ln", False, True, 384, 384, 1, 48, 48, 144) == 0


def test_a_wide_block_takes_four_launches():
    """Where q/k/v of every head exceed one GEMM's columns, or two blocks of the one-launch
    route do not fit an SM, the plan takes five launches; a hidden wider than one GEMM's
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
    assert args[23:37] == (2, 1, 14, 14, c, 8, d, hidden, plan.heads_per_block, plan.hidden_chunk,
                           int(fused), 1, 1, int(bf16))
    assert [a is None for a in args[19:23]] == [fused] * 4
    assert "swin_fused_block_fwd" not in fake_library.calls
    assert (tfb.LAUNCHES, tfb.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


@pytest.mark.parametrize("what", ["windows layout", "dropout", "backward"])
def test_windows_dropout_and_backward_keep_the_five_launches(fake_library, what):
    """K1 (the windows layout), a dropout forward and every backward run
    ``csrc/fused_block.cu`` (the backward recomputes with its five launches), never the new
    forward."""
    x, weights = _block_args(24, 8, 3, 96)
    if what == "windows layout":
        xw = x.reshape(2, 1, 4, 49, 24)
        tfb._launch_fwd(xw, weights, dict(_kw(8, 3, layout="windows"), hw=(14, 14)))
        name = "swin_fused_block_fwd"
    elif what == "dropout":
        tfb._launch_fwd(x, weights, _kw(8, 3, drop_rates=(0.25, 0.0, 0.1), drop_seed=9))
        name = "swin_fused_block_fwd"
    else:
        tfb._launch_bwd(x, x, weights, _kw(8, 3))
        name = "swin_fused_block_bwd"
    assert name in fake_library.calls
    assert "swin_k4_fwd" not in fake_library.calls


def test_launch_raises_before_any_call_on_a_shape_it_does_not_take(fake_library):
    x, weights = _block_args(24, 8, 3, 98)
    with pytest.raises(ValueError, match="hidden"):
        tfb._launch_fwd(x, weights, _kw(8, 3))
    assert "swin_k4_fwd" not in fake_library.calls and "swin_fused_block_fwd" not in fake_library.calls
