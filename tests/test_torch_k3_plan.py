"""The launch plan of K3's forward without dropout (``csrc/window_attention_fwd.cu``), on
the CPU: the route, head grouping and shared memory per stage of the default model, what
the wrapper hands the kernels (with a fake library and no CUDA runtime), that the forward and
the backward, with and without dropout, run ``csrc/window_attention_fwd.cu`` and
``csrc/window_attention_bwd.cu`` and never the three launches of ``csrc/window_attention.cu``,
and that shapes the kernels do not take raise before any launch. The dropout form's plan is
``tests/test_torch_k3_fwd_drop.py``'s. The kernels themselves run in
``tests/test_torch_kernel_gpu.py`` and ``chip_smoke.py``."""

import contextlib

import pytest
import torch

from swin_unet_image_fusion_tpu_torch import ModelConfig
from swin_unet_image_fusion_tpu_torch.ops import _build
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

CFG = ModelConfig()
# (C, route, heads per block) of the default model's five stages
STAGES = ((24, "fused", 8), (48, "fused", 8), (96, "split", 4), (192, "split", 2), (384, "split", 1))


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
        return 0


class _FakeLibrary:
    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        fn = _FakeFunction(self.calls, name)
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_library(monkeypatch):
    """Every K3 library replaced by one fake that records each launcher call, bound with the
    wrapper's own argtypes."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    for cached in (twa._library, twa._fwd_library, twa._bwd_library):
        cached.cache_clear()
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    yield lib
    for cached in (twa._library, twa._fwd_library, twa._bwd_library):
        cached.cache_clear()


def _attention_args(c, heads, d, hw=(14, 14), dtype=torch.float32):
    inner = heads * d
    x = torch.zeros(2, 1, *hw, c, dtype=dtype)
    w, b = torch.zeros(2, c, inner), torch.zeros(2, inner)
    return x, (w, b, w, b, w, b, torch.zeros(2, inner, c), torch.zeros(2, c), torch.zeros(2, 49, 49))


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("c,route,hg", STAGES, ids=[f"C{c}" for c, _, _ in STAGES])
def test_plan_of_each_stage(c, route, hg, dtype, cross):
    """One launch with every head in a block where two such blocks fit an SM (stages 0-1),
    else a head group of at most 48 columns per q/k/v part and a projection launch; every
    block within the 227 KB a block may use."""
    d = CFG.dims_per_head(c)
    plan = twa.fwd_plan(c, CFG.att_num_heads, d, CFG.window_size, cross, dtype == "bf16")
    assert (plan.route, plan.heads_per_block, plan.launches) == (route, hg, 1 if route == "fused" else 2)
    assert plan.pitch == {3: 4, 6: 8, 12: 12, 24: 24, 48: 48}[d]
    assert 0 < plan.smem <= twa.SMEM_LIMIT_BYTES and plan.proj_smem <= twa.SMEM_LIMIT_BYTES
    if route == "fused":
        assert plan.smem <= twa.FUSED_SMEM_MAX and plan.proj_smem == 0
    else:
        assert plan.proj_smem > 0 and hg * d <= twa.GROUP_COLS and (hg * d) % 8 == 0


def test_shared_memory_counts_every_buffer():
    """Stage 1, cross, fused. fp32: the rings (x chunks of both streams, 3 slots x 16
    channels x 60 floats; w chunks, 3 x 16 x 144), which wp (48 x 48) reuses after them;
    q/k/v of 8 heads at pitch 8; AV by channel (48 x 60); the bias table; the row, region,
    column and bias tables (2 x 64 + 3 x 192). bf16: the rings (x 3 x 2 x 64 x 24 halves, w
    3 x 16 x 148 floats) and, after them, P (8 warps x 32 x 72 halves) and wp (48 x 52
    floats); q and k fp32; v^T (8 heads x 8 x 72); AV (64 x 56). The projection kernel: its
    six-deep rings (x 6 x 16 x 60, w 6 x 16 x 48) and row tables."""
    tables = 9616 + 2816
    fp32 = max(3 * 2 * 16 * 60 * 4 + 3 * 16 * 144 * 4, 48 * 48 * 4) + 3 * (8 * 49 * 8 * 4) \
        + 48 * 60 * 4 + tables
    bf16 = max(3 * 2 * 64 * 24 * 2 + 3 * 16 * 148 * 4, 8 * 32 * 72 * 2 + 48 * 52 * 4) \
        + 2 * (8 * 49 * 8 * 4) + 8 * 8 * 72 * 2 + 64 * 56 * 2 + tables
    assert twa.attention_smem(False, True, True, 48, 48, 8, 6, 8) == fp32 == 112272
    assert twa.attention_smem(True, True, True, 48, 48, 8, 6, 8) == bf16 == 100752
    assert twa.proj_smem(False) == 6 * 16 * 60 * 4 + 6 * 16 * 48 * 4 + 512


@pytest.mark.parametrize("what,c,heads,d,window", [
    ("window", 24, 8, 3, (12, 12)),
    ("dims per head", 512, 8, 64, (7, 7)),
    ("multiples of 8", 20, 4, 5, (7, 7)),
])
def test_plan_raises_on_shapes_the_kernels_do_not_take(what, c, heads, d, window):
    with pytest.raises(ValueError):
        twa.fwd_plan(c, heads, d, window, False, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c,route,hg", [STAGES[0], STAGES[2]], ids=["C24", "C96"])
def test_call_without_dropout_launches_the_new_forward(fake_library, c, route, hg, dtype):
    """The plan's route reaches the launcher (head group, fused flag, an AV scratch only on
    the split route, the dtype form) through arguments that match its ctypes signature,
    and the call counts once in its dtype's counter."""
    d = CFG.dims_per_head(c)
    x, weights = _attention_args(c, 8, d, dtype=dtype)
    before = (twa.LAUNCHES, twa.BF16_LAUNCHES)
    out = twa._launch_fwd(x, weights, dict(window=(7, 7), num_heads=8, dims_per_head=d,
                                           shift=True, cross=True))
    assert out.dtype == dtype and out.shape == x.shape
    (args,) = fake_library.calls["swin_k3_fwd"]
    assert args[20:25] == (hg, int(route == "fused"), 1, 1, int(dtype == torch.bfloat16))
    assert (args[11] is None) == (route == "fused") and args[12] is None
    assert "swin_window_attention_fwd" not in fake_library.calls
    bf16 = int(dtype == torch.bfloat16)
    assert (twa.LAUNCHES, twa.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


def test_dropout_keeps_the_three_launches_and_the_backward_without_dropout_is_new(fake_library):
    """The dropout forward no longer keeps the three launches (the name is the older rule's):
    the forward and the backward, with and without dropout, run ``swin_k3_fwd`` of
    ``csrc/window_attention_fwd.cu`` and ``swin_k3_bwd`` of ``csrc/window_attention_bwd.cu``
    (with the dropout arguments for a dropout call, NULL without), never the three-launch
    forward or backward of ``csrc/window_attention.cu``."""
    x, weights = _attention_args(24, 8, 3)
    kw = dict(window=(7, 7), num_heads=8, dims_per_head=3, shift=False, cross=True)
    drop = dict(kw, attn_drop_rate=0.25, drop_seed=9)
    twa._launch_fwd(x, weights, drop)
    twa._launch_bwd(x, x, weights, drop)
    launchers = ("swin_window_attention_fwd", "swin_window_attention_bwd", "swin_k3_fwd", "swin_k3_bwd")
    assert {n: len(fake_library.calls.get(n, ())) for n in launchers} == \
        {"swin_window_attention_fwd": 0, "swin_window_attention_bwd": 0, "swin_k3_fwd": 1, "swin_k3_bwd": 1}
    twa._launch_fwd(x, weights, kw)
    twa._launch_bwd(x, x, weights, kw)
    (fwd_drop, fwd_without) = fake_library.calls["swin_k3_fwd"]
    assert fwd_drop[12] is not None and fwd_without[12] is None
    (with_drop, without) = fake_library.calls["swin_k3_bwd"]
    assert with_drop[4] is not None and without[4] is None
    assert "swin_window_attention_fwd" not in fake_library.calls
    assert "swin_window_attention_bwd" not in fake_library.calls


def test_launch_raises_before_any_call_on_a_shape_it_does_not_take(fake_library):
    x, weights = _attention_args(24, 8, 3, hw=(24, 24))
    with pytest.raises(ValueError, match="windows"):
        twa._launch_fwd(x, weights, dict(window=(12, 12), num_heads=8, dims_per_head=3,
                                         shift=False, cross=False))
    assert "swin_k3_fwd" not in fake_library.calls
