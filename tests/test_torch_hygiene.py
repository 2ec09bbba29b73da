"""The PyTorch port stands alone: it imports neither JAX nor the JAX package, and its
entry points refuse to run on the CPU when a CUDA device was asked for."""

import ast
import contextlib
import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
from swin_unet_image_fusion_tpu_torch.ops import _build
from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd
from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "swin_unet_image_fusion_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "swin_unet_image_fusion_tpu")
TINY = ModelConfig(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
                   att_dims_per_head_ratio=1 / 2)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import swin_unet_image_fusion_tpu_torch, swin_unet_image_fusion_tpu_torch.infer\n"
        "import swin_unet_image_fusion_tpu_torch.models.from_jax\n"
        "import swin_unet_image_fusion_tpu_torch.ops.window_attention\n"
        "import swin_unet_image_fusion_tpu_torch.ops.fused_block\n"
        "import swin_unet_image_fusion_tpu_torch.ops.window_pack\n"
        "import swin_unet_image_fusion_tpu_torch.train, swin_unet_image_fusion_tpu_torch.losses\n"
        "import swin_unet_image_fusion_tpu_torch.optim, swin_unet_image_fusion_tpu_torch.ops.ssim\n"
        "import swin_unet_image_fusion_tpu_torch.ops.edges\n"
        "import swin_unet_image_fusion_tpu_torch.ops.hash_dropout\n"
        "import swin_unet_image_fusion_tpu_torch.ops.dropout_layout\n"
        "import swin_unet_image_fusion_tpu_torch.ops.dropout_mask\n"
        "import swin_unet_image_fusion_tpu_torch.data.dataset, swin_unet_image_fusion_tpu_torch.testing\n"
        "import swin_unet_image_fusion_tpu_torch.utils.term, swin_unet_image_fusion_tpu_torch.utils.meters\n"
        "import swin_unet_image_fusion_tpu_torch.models.torch_import\n"
        "import swin_unet_image_fusion_tpu_torch.models.torch_export\n"
        "import swin_unet_image_fusion_tpu_torch.metrics, swin_unet_image_fusion_tpu_torch.eval_metrics\n"
        "import swin_unet_image_fusion_tpu_torch.parallel.tiled, swin_unet_image_fusion_tpu_torch.utils.flops\n"
        "import swin_unet_image_fusion_tpu_torch.parallel.mesh, swin_unet_image_fusion_tpu_torch.parallel.spatial\n"
        "import swin_unet_image_fusion_tpu_torch.ops.window_pack_spmd\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path.name}:{node.lineno} imports {names}"


def test_fuser_on_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Fuser(Config(model=TINY), random_variables(TINY, seed=0))


@pytest.mark.parametrize("entry", ["Trainer", "start_main", "Fuser.from_checkpoint"])
def test_training_entry_points_on_the_default_device_raise_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_from_jax
    from swin_unet_image_fusion_tpu_torch.models.torch_export import save_torch_checkpoint
    from swin_unet_image_fusion_tpu_torch.train import Trainer, start_main

    cfg = Config(model=TINY)
    path = str(tmp_path / "w.pth")
    save_torch_checkpoint(path, variables_from_jax(random_variables(TINY, seed=0)), TINY)
    calls = {"Trainer": lambda: Trainer(cfg), "start_main": lambda: start_main(cfg),
             "Fuser.from_checkpoint": lambda: Fuser.from_checkpoint(cfg, path)}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


@pytest.mark.parametrize("entry", ["TiledFuser", "run_test", "score_fusion"])
def test_serving_and_evaluation_entry_points_on_the_default_device_raise_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    from swin_unet_image_fusion_tpu_torch.config import LogConfig
    from swin_unet_image_fusion_tpu_torch.eval_metrics import score_fusion
    from swin_unet_image_fusion_tpu_torch.infer import run_test
    from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_from_jax
    from swin_unet_image_fusion_tpu_torch.models.torch_export import save_torch_checkpoint
    from swin_unet_image_fusion_tpu_torch.parallel.tiled import TiledFuser

    path = str(tmp_path / "w.pth")
    save_torch_checkpoint(path, variables_from_jax(random_variables(TINY, seed=0)), TINY)
    image = np.zeros((16, 16), np.float32)
    calls = {"TiledFuser": lambda: TiledFuser(TINY, random_variables(TINY, seed=0)),
             "run_test": lambda: run_test(Config(model=TINY, log=LogConfig(using_state_path=path))),
             "score_fusion": lambda: score_fusion(image, image, image)}
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_window_attention_never_runs_the_plain_version_off_the_cpu():
    x = torch.empty(2, 1, 7, 7, 8, device="meta")
    w = torch.empty(2, 8, 8, device="meta")
    b = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        twa.window_attention(x, w, b, w, b, w, b, w, b, torch.empty(2, 49, 49, device="meta"),
                             window=(7, 7), num_heads=2, dims_per_head=4, shift=False, cross=False)


def test_fused_block_never_runs_the_plain_version_off_the_cpu():
    c, hidden = 8, 32
    x = torch.empty(2, 1, 7, 7, c, device="meta")
    vec, mat = torch.empty(2, c, device="meta"), torch.empty(2, c, c, device="meta")
    weights = (vec, vec, mat, vec, mat, vec, mat, vec, mat, vec, torch.empty(2, 49, 49, device="meta"),
               vec, vec, torch.empty(2, c, hidden, device="meta"), torch.empty(2, hidden, device="meta"),
               torch.empty(2, hidden, c, device="meta"), vec)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfb.fused_block(x, *weights, window=(7, 7), num_heads=2, dims_per_head=4, shift=False,
                        cross=False, layout="image")


def test_repartition_never_runs_the_plain_version_off_the_cpu():
    with pytest.raises(ValueError, match="cpu or cuda"):
        twp.repartition_windows(torch.empty(2, 1, 4, 49, 8, device="meta"), (14, 14), (7, 7),
                                False, True)


def test_band_forms_never_run_the_plain_version_off_the_cpu():
    from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd

    x = torch.empty(2, 1, 2, 49, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmd.repartition_halo(x, torch.empty(2, 1, 2, 49, 8, device="meta"), (14, 14), (7, 7),
                              False, True)
    _, weights = _meta_block_args()
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmd.fused_block_band(x, *weights, hw=(14, 14), row0=0, window=(7, 7), num_heads=2,
                              dims_per_head=4, shift=True, cross=False)


def test_dropout_masks_never_run_the_plain_version_off_the_cpu():
    key = dl.keying("k4", (7, 7), (7, 7), False, 2, 4, "cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        dm.token_dropout(torch.empty(2, 1, 7, 7, 8, device="meta"), 5, hd.SITE_PROJ, 0.1, key)
    with pytest.raises(ValueError, match="cpu or cuda"):
        dm.attention_dropout(torch.empty(2, 1, 2, 49, 49, device="meta"), 5, 0.1, key)


def _meta_block_args(c=8, hidden=32, dtype=torch.float32):
    x = torch.empty(2, 1, 7, 7, c, device="meta", dtype=dtype)
    vec, mat = torch.empty(2, c, device="meta"), torch.empty(2, c, c, device="meta")
    weights = (vec, vec, mat, vec, mat, vec, mat, vec, mat, vec, torch.empty(2, 49, 49, device="meta"),
               vec, vec, torch.empty(2, c, hidden, device="meta"), torch.empty(2, hidden, device="meta"),
               torch.empty(2, hidden, c, device="meta"), vec)
    return x, weights


def test_bf16_never_runs_a_plain_version_off_the_cpu():
    x = torch.empty(2, 1, 7, 7, 8, device="meta", dtype=torch.bfloat16)
    w, b = torch.empty(2, 8, 8, device="meta"), torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        twa.window_attention(x, w, b, w, b, w, b, w, b, torch.empty(2, 49, 49, device="meta"),
                             window=(7, 7), num_heads=2, dims_per_head=4, shift=False, cross=False)
    x, weights = _meta_block_args(dtype=torch.bfloat16)
    for layout in ("image", "windows"):
        xl = x if layout == "image" else x.reshape(2, 1, 1, 49, 8)
        with pytest.raises(ValueError, match="cpu or cuda"):
            tfb.fused_block(xl, *weights, window=(7, 7), num_heads=2, dims_per_head=4, shift=False,
                            cross=False, layout=layout, hw=(7, 7))
    with pytest.raises(ValueError, match="cpu or cuda"):
        twp.repartition_windows(torch.empty(2, 1, 4, 49, 8, device="meta", dtype=torch.bfloat16),
                                (14, 14), (7, 7), False, True)


class _FakeLibrary:
    """Records the arguments of every launcher call; every call succeeds."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def fake_library(monkeypatch):
    """The wrappers' launch code with a fake library and no CUDA runtime, so that what
    they would hand the kernels can be read on the CPU."""
    lib = _FakeLibrary()
    for module in (twa, tfb, twp, dm):
        monkeypatch.setattr(module, "_library", lambda: lib)
    monkeypatch.setattr(twa, "_fwd_library", lambda build="": lib)
    monkeypatch.setattr(twa, "_bwd_library", lambda build="": lib)
    monkeypatch.setattr(tfb, "_fwd_library", lambda drop=False: lib)
    monkeypatch.setattr(tfb, "_bwd_library", lambda: lib)
    monkeypatch.setattr(tfb, "_split_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_each_dtype_launches_its_own_kernel_form(fake_library, dtype):
    """A bf16 tensor goes to the bf16 form of each kernel and an fp32 one to the fp32
    form, each counted as such: nothing is upcast into the fp32 kernels."""
    bf16 = int(dtype == torch.bfloat16)
    x = torch.zeros(2, 1, 7, 7, 8, dtype=dtype)
    w, b = torch.zeros(2, 8, 8), torch.zeros(2, 8)
    before = (twa.LAUNCHES, twa.BF16_LAUNCHES)
    out = twa._launch_fwd(x, (w, b, w, b, w, b, w, b, torch.zeros(2, 49, 49)),
                          dict(window=(7, 7), num_heads=2, dims_per_head=4, shift=False, cross=False))
    # ..., the bf16 flag, the scale, the window's rows and columns, the stream
    assert out.dtype == dtype and fake_library.calls["swin_k3_fwd"][-5] == bf16
    assert (twa.LAUNCHES, twa.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)

    _, weights = _meta_block_args()
    weights = [torch.zeros(a.shape) for a in weights]
    # without dropout K4 (image layout) and K1 (windows) run csrc/fused_block_fwd.cu: the
    # bf16 I/O form, with bf16 operands for K4 alone (K1 is fp32 inside)
    for layout, xl in (("image", x), ("windows", x.reshape(2, 1, 1, 49, 8))):
        before = (tfb.LAUNCHES, tfb.BF16_LAUNCHES)
        out = tfb._launch_fwd(xl, weights, dict(window=(7, 7), num_heads=2, dims_per_head=4, shift=True,
                                                cross=True, layout=layout, hw=(7, 7)))
        args = fake_library.calls["swin_k4_fwd"]
        assert args[-2] == 0, "the activation's code (ELU), the last argument before the stream"
        assert out.dtype == dtype and args[-5] == bf16
        assert args[-4] == (bf16 if layout == "image" else 0), "the operands' rounding"
        assert args[-6] == (layout == "windows"), "the windows layout's flag"
        assert "swin_fused_block_fwd" not in fake_library.calls
        assert (tfb.LAUNCHES, tfb.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)

    before = (twp.LAUNCHES, twp.BF16_LAUNCHES)
    xw = torch.zeros(2, 1, 4, 49, 8, dtype=dtype)
    out = twp._launch(xw, (14, 14), (7, 7), False, True)
    twp._count_forward(xw)
    assert out.dtype == dtype
    assert fake_library.calls["swin_repartition_fwd"][5] == 8 * x.element_size(), "bytes per token"
    assert (twp.LAUNCHES, twp.BF16_LAUNCHES) == (before[0] + 1 - bf16, before[1] + bf16)


def test_bf16_backward_raises_before_any_launch(fake_library):
    """A bf16 backward launches the bf16 form of each backward kernel (g_x bf16, the weight
    gradients fp32) and counts in its own counter, with and without dropout; a gradient of
    another dtype than x raises before any launch."""
    x = torch.zeros(2, 1, 7, 7, 8, dtype=torch.bfloat16)
    w, b = torch.zeros(2, 8, 8), torch.zeros(2, 8)
    attn = (w, b, w, b, w, b, w, b, torch.zeros(2, 49, 49))
    kw = dict(window=(7, 7), num_heads=2, dims_per_head=4, shift=False, cross=True)
    _, weights = _meta_block_args()
    weights = [torch.zeros(a.shape) for a in weights]
    with pytest.raises(ValueError, match="output gradient"):
        twa._launch_bwd(x.float(), x, attn, kw)
    with pytest.raises(ValueError, match="output gradient"):
        tfb._launch_bwd(x.float(), x, weights, dict(kw, layout="image", hw=None))
    assert not fake_library.calls

    counters = lambda m: (m.BWD_LAUNCHES, m.BF16_BWD_LAUNCHES, m.DROP_BWD_LAUNCHES,
                          m.BF16_DROP_BWD_LAUNCHES)
    for rate in (0.0, 0.5):
        before = counters(twa)
        grads = twa._launch_bwd(x, x, attn, dict(kw, attn_drop_rate=rate, drop_seed=3))
        assert grads[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[1:])
        # the backward of csrc/window_attention_bwd.cu, with dropout its dropout form
        args = fake_library.calls["swin_k3_bwd"]
        assert args[-5] == 1 and args[-6] == 1, "the bf16 form, cross (then the scale, the window, the stream)"
        assert (args[4] is None) == (rate == 0.0), "the dropout arguments"
        assert counters(twa) == tuple(c + (i == (3 if rate else 1)) for i, c in enumerate(before))
        for layout in ("image", "windows"):
            xl = x if layout == "image" else x.reshape(2, 1, 1, 49, 8)
            before = counters(tfb)
            grads = tfb._launch_bwd(xl, xl, weights, dict(kw, layout=layout, hw=(7, 7),
                                                          drop_rates=(rate, rate, rate), drop_seed=3))
            assert grads[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads[1:])
            # csrc/fused_block_bwd.cu's fused route, without dropout and in its dropout form
            args = fake_library.calls["swin_block_bwd"]
            assert args[-4] == 1 and args[-5] == int(layout == "windows") and args[-2] == 0
            assert counters(tfb) == tuple(c + (i == (3 if rate else 1)) for i, c in enumerate(before))


def test_dropout_launches_its_own_kernel_form(fake_library):
    """A call with dropout hands the kernels its arguments (the keying table, the per-site
    hash base, threshold and scale, a site of rate 0 off) and counts in the dropout
    counters, forward and backward."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
    from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

    x = torch.zeros(2, 1, 7, 7, 8)
    _, weights = _meta_block_args()
    weights = [torch.zeros(a.shape) for a in weights]
    kw = dict(window=(7, 7), num_heads=2, dims_per_head=4, shift=True, cross=True,
              layout="image", hw=None, drop_rates=(0.1, 0.0, 0.25), drop_seed=5)
    before = (tfb.LAUNCHES, tfb.DROP_LAUNCHES, tfb.BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES)
    tfb._launch_fwd(x, weights, kw)
    tfb._launch_bwd(x, x, weights, kw)
    assert (tfb.LAUNCHES, tfb.DROP_LAUNCHES, tfb.BWD_LAUNCHES, tfb.DROP_BWD_LAUNCHES) == (
        before[0], before[1] + 1, before[2], before[3] + 1)
    for name in ("swin_k4_fwd", "swin_block_bwd"):  # the forward's and the backward's fused route
        args = fake_library.calls[name]
        drop = next(a for a in args if isinstance(a, ctypes._Pointer)).contents
        assert list(drop.on) == [1, 0, 1, 1] and drop.pairs == 0 and drop.t_pad == 56
        assert drop.base[0] == hd.site_base(5, hd.SITE_ATTN)
        assert drop.base[3] == hd.site_base(5, hd.SITE_MLP_OUT)
        assert drop.threshold[2] == hd.keep_threshold(0.25) and drop.scale[2] == hd.keep_scale(0.25)
        table, units = dl.keying_table("k4", (7, 7), (7, 7), True)
        assert drop.units == units == 4 and drop.table != 0
    before = (twa.LAUNCHES, twa.DROP_LAUNCHES)
    w, b = torch.zeros(2, 8, 8), torch.zeros(2, 8)
    attn = (w, b, w, b, w, b, w, b, torch.zeros(2, 49, 49))
    twa._launch_fwd(x, attn, dict(kw, attn_drop_rate=0.5))
    assert (twa.LAUNCHES, twa.DROP_LAUNCHES) == (before[0], before[1] + 1)
    drop = fake_library.calls["swin_k3_fwd"][12].contents
    assert list(drop.on) == [1, 0, 0, 0] and drop.units == 1


def test_dropout_masks_launch_with_their_site_and_count_each_direction(fake_library):
    """The composition's mask kernels get the keying, the one site that is on (its hash
    base, threshold and scale) and the tensor's geometry; a recorded call counts once
    forward and once on the gradient."""
    key = dl.keying("k4", (14, 7), (7, 7), True, 2, 4, "cpu")
    x = torch.zeros(2, 3, 14, 7, 8, requires_grad=True)
    before = (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES)
    out = dm._apply(functools.partial(dm._launch_tokens, seed=5, site=hd.SITE_MLP_OUT, rate=0.25,
                                      key=key), x)
    out.backward(torch.ones_like(out))
    assert (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    args = fake_library.calls["swin_dropout_tokens"]
    drop = args[2].contents
    assert args[3:8] == (3, 2, 3, 98, 8), "site index, streams, images, tokens per image, columns"
    assert list(drop.on) == [0, 0, 0, 1] and drop.base[3] == hd.site_base(5, hd.SITE_MLP_OUT)
    assert drop.threshold[3] == hd.keep_threshold(0.25) and drop.scale[3] == hd.keep_scale(0.25)
    assert drop.units == dl.keying_table("k4", (14, 7), (7, 7), True)[1] and drop.table != 0

    before = dm.ATTN_LAUNCHES
    dm._launch_attention(torch.zeros(2, 3 * 2, 2, 49, 49), 5, 0.5, key)
    assert dm.ATTN_LAUNCHES == before + 1
    args = fake_library.calls["swin_dropout_attention"]
    drop = args[2].contents
    assert args[3] != 0 and args[4:9] == (2, 3, 2, 49, 2), "streams, images, windows, T, heads"
    assert list(drop.on) == [1, 0, 0, 0] and drop.t_pad == 56 and drop.attn_mode == dl.ATTN_SLOTS


def test_bf16_dropout_masks_launch_their_bf16_form(fake_library):
    """A bf16 tensor hands the composition's mask kernels the bf16 flag, gets a bf16 output
    and counts in the bf16 counters, forward and on the gradient; the fp32 counters stay."""
    key = dl.keying("k4", (14, 7), (7, 7), True, 2, 4, "cpu")
    x = torch.zeros(2, 3, 14, 7, 8, dtype=torch.bfloat16, requires_grad=True)
    fp32 = (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES, dm.ATTN_LAUNCHES, dm.ATTN_BWD_LAUNCHES)
    before = (dm.BF16_TOKEN_LAUNCHES, dm.BF16_TOKEN_BWD_LAUNCHES, dm.BF16_ATTN_LAUNCHES)
    out = dm._apply(functools.partial(dm._launch_tokens, seed=5, site=hd.SITE_PROJ, rate=0.25,
                                      key=key), x)
    out.backward(torch.ones_like(out))
    assert out.dtype == x.grad.dtype == torch.bfloat16
    assert fake_library.calls["swin_dropout_tokens"][-2] == 1, "the bf16 form"
    dm._launch_attention(torch.zeros(2, 6, 2, 49, 49, dtype=torch.bfloat16), 5, 0.5, key)
    assert fake_library.calls["swin_dropout_attention"][-2] == 1
    assert (dm.BF16_TOKEN_LAUNCHES, dm.BF16_TOKEN_BWD_LAUNCHES, dm.BF16_ATTN_LAUNCHES) == tuple(
        c + 1 for c in before)
    assert (dm.TOKEN_LAUNCHES, dm.TOKEN_BWD_LAUNCHES, dm.ATTN_LAUNCHES, dm.ATTN_BWD_LAUNCHES) == fp32
    dm._launch_tokens(torch.zeros(2, 3, 14, 7, 8), 5, hd.SITE_PROJ, 0.25, key)
    assert fake_library.calls["swin_dropout_tokens"][-2] == 0


def test_kernel_build_hash_covers_the_shared_headers(monkeypatch, tmp_path):
    """A source that includes a header is rebuilt when only the header changes."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k")
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert _build._target("k") != before



def test_kernel_build_hash_covers_an_included_source_and_no_other(monkeypatch, tmp_path):
    """A source that includes another source (an any-window build and its 7x7 source) is rebuilt
    when only the included source changes; an edit to a source it does not include leaves its
    build in place."""
    (tmp_path / "k_any.cu").write_text('#define SWIN_ANY_WINDOW 1\n#include "k.cu"\n')
    (tmp_path / "k.cu").write_text("// one\n")
    (tmp_path / "other.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k_any")
    (tmp_path / "other.cu").write_text("// two\n")
    assert _build._target("k_any") == before
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build._target("k_any") != before

def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit: the build raises instead of leaving a caller on another path."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("the CUDA toolkit is installed")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("window_attention")
