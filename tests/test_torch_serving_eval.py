"""The port's colour serving, test-folder entry point, evaluation metrics and FLOP count against
the JAX package's.

- ``Fuser.fuse_pair_ycrcb`` against JAX's on the tiny model (weights from flax's
  ``model.init`` carried across by ``variables_from_jax``) at 60x52: atol 2e-4 / rtol 1e-3,
  the JAX package's tiny-model parity tolerance; the colour rows against ``cv2.cvtColor``
  at atol 2e-6; ``save_image``'s file decoded equal to JAX ``save_image``'s.
- ``run_test`` over a folder of two seeded PNG pairs from a ``.pth`` that the port's
  ``save_torch_checkpoint`` wrote (JAX's ``load_torch_checkpoint`` reads it too): the
  ``pic{i}_MKX_SELF.jpg`` names, each file decoded equal to ``save_image`` of the port's
  RGB, and that RGB within the parity tolerance of the JAX ``Fuser``'s on the same file.
- ``metrics.ssim``, ``ms_ssim_index`` and ``psnr`` against JAX's (rtol 1e-5); every
  ``eval_metrics`` function equal to JAX's (the same numpy arithmetic) and ``score_fusion``
  (its SSIM/PSNR at rtol 1e-5).
- ``utils/flops.py::model_flops_per_pair`` equal to JAX's for the default and the tiny
  model at 512x512, 224x224, 100x90 and 2160x3840.

About 45 s in one process, most of it JAX's compile.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swin_unet_image_fusion_tpu import config as jcfg
from swin_unet_image_fusion_tpu import eval_metrics as jeval
from swin_unet_image_fusion_tpu import infer as jinfer
from swin_unet_image_fusion_tpu import metrics as jmetrics
from swin_unet_image_fusion_tpu.models.unet import SwinFusionUNet as JaxUNet
from swin_unet_image_fusion_tpu.utils import flops as jflops
from swin_unet_image_fusion_tpu_torch import Config, ModelConfig, eval_metrics, infer, metrics
from swin_unet_image_fusion_tpu_torch.config import DataConfig, LogConfig
from swin_unet_image_fusion_tpu_torch.data.dataset import FusionPairDataset
from swin_unet_image_fusion_tpu_torch.models.from_jax import flatten_variables, random_variables, variables_from_jax
from swin_unet_image_fusion_tpu_torch.models.torch_export import save_torch_checkpoint
from swin_unet_image_fusion_tpu_torch.utils import flops

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

TINY = dict(in_dims_list=(1, 8), out_dims_list=(8, 16), att_num_heads=2,
            att_dims_per_head_ratio=1 / 2)
ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxUNet(jcfg.ModelConfig(**TINY, attention_impl="jnp"))
    zeros = jnp.zeros((1, 28, 28, 1))
    return jax.jit(model.init)(jax.random.PRNGKey(0), zeros, zeros)


def _jax_config(**sections):
    return jcfg.Config(model=jcfg.ModelConfig(**TINY, attention_impl="jnp"), **sections)


def _colour_pair(rng, h, w):
    ir = rng.random((1, h, w, 1), dtype=np.float32)
    vis = rng.random((1, h, w, 3), dtype=np.float32)
    return ir, vis


def test_fuse_pair_ycrcb_matches_jax(jax_variables):
    rng = np.random.default_rng(21)
    ir, vis = _colour_pair(rng, 60, 52)  # full-range chroma: the RGB clip is exercised too
    ref = jinfer.Fuser(_jax_config(), jax_variables["params"], jax_variables["batch_stats"]).fuse_pair_ycrcb(ir, vis)
    fuser = infer.Fuser(Config(model=ModelConfig(**TINY)), flatten_variables(jax_variables), device="cpu")
    out = fuser.fuse_pair_ycrcb(ir, vis)
    assert out.shape == (1, 60, 52, 3) and out.dtype == np.float32
    assert out.min() == 0.0 and out.max() == 1.0, "the clip to [0, 1] is reached"
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw", [(64, 64), (37, 50)])
def test_colour_rows_match_cv2(hw):
    ycrcb = np.random.default_rng(hw[0]).random((*hw, 3), dtype=np.float32)
    ref = cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2RGB)
    np.testing.assert_allclose(infer.ycrcb_to_rgb(torch.from_numpy(ycrcb)).numpy(), ref, atol=2e-6, rtol=0)


def test_save_image_matches_jax(tmp_path):
    rgb = np.random.default_rng(5).random((33, 47, 3), dtype=np.float32)
    rgb[0, :3] = (-0.2, 1.3, 0.5)  # values the quantisation clips
    infer.save_image(rgb, str(tmp_path / "port.jpg"))
    jinfer.save_image(rgb, str(tmp_path / "jax.jpg"))
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.jpg")), cv2.imread(str(tmp_path / "jax.jpg")))


def test_run_test_end_to_end_matches_jax(tmp_path):
    rng = np.random.default_rng(31)
    folder, out_dir = tmp_path / "input", tmp_path / "output"
    for sub in ("ir", "vis"):
        (folder / sub).mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(folder / "ir" / f"pic{i}.png"), (rng.random((48, 56)) * 255).astype(np.uint8))
        cv2.imwrite(str(folder / "vis" / f"pic{i}.png"), (rng.random((48, 56, 3)) * 255).astype(np.uint8))
    pth = str(tmp_path / "weights.pth")
    cfg_model = ModelConfig(**TINY)
    save_torch_checkpoint(pth, variables_from_jax(random_variables(cfg_model, seed=8)), cfg_model)
    cfg = Config(model=cfg_model, data=DataConfig(test_dataset_folder=str(folder), test_result_folder=str(out_dir)),
                 log=LogConfig(using_state_path=pth))
    infer.run_test(cfg, device="cpu")
    assert sorted(os.listdir(out_dir)) == ["pic0_MKX_SELF.jpg", "pic1_MKX_SELF.jpg"]

    port = infer.Fuser.from_checkpoint(cfg, pth, device="cpu")
    ref = jinfer.Fuser.from_checkpoint(_jax_config(), pth)
    dataset = FusionPairDataset(is_test=True, dataset_folder=str(folder), cfg=cfg.data)
    for i in range(2):
        item = dataset[i]
        rgb = port.fuse_pair_ycrcb(item["ir"][None], item["vis"][None])[0]
        np.testing.assert_allclose(rgb, ref.fuse_pair_ycrcb(item["ir"][None], item["vis"][None])[0],
                                   atol=ATOL, rtol=RTOL)
        infer.save_image(rgb, str(tmp_path / f"again{i}.jpg"))
        np.testing.assert_array_equal(cv2.imread(str(out_dir / f"pic{i}_MKX_SELF.jpg")),
                                      cv2.imread(str(tmp_path / f"again{i}.jpg")))


@pytest.mark.parametrize("channels", [1, 3])
def test_image_metrics_match_jax(channels):
    rng = np.random.default_rng(40 + channels)
    a, b = (rng.random((2, 40, 36, channels), dtype=np.float32) for _ in range(2))
    b = np.clip(0.7 * a + 0.3 * b, 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for name in ("ssim", "psnr"):
        ref = float(getattr(jmetrics, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(getattr(metrics, name)(ta, tb).item(), ref, rtol=1e-5, err_msg=name)
    big_a, big_b = (rng.random((1, 180, 190, channels), dtype=np.float32) for _ in range(2))
    big_b = np.clip(0.8 * big_a + 0.2 * big_b, 0, 1)
    ref = float(jmetrics.ms_ssim_index(jnp.asarray(big_a), jnp.asarray(big_b)))
    got = metrics.ms_ssim_index(torch.from_numpy(big_a), torch.from_numpy(big_b)).item()
    assert 0 < ref < 1
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _eval_images(shape, seed):
    rng = np.random.default_rng(seed)
    ir, vis = (rng.random(shape, dtype=np.float32) for _ in range(2))
    fused = np.clip(0.5 * ir + 0.5 * vis + 0.05 * rng.standard_normal(shape).astype(np.float32), 0, 1)
    return fused, ir, vis


@pytest.mark.parametrize("shape", [(48, 40), (48, 40, 1), (32, 36, 3)], ids=["hw", "hw1", "hw3"])
def test_eval_metrics_equal_jax(shape):
    fused, ir, vis = _eval_images(shape, seed=len(shape))
    for name in ("entropy", "std_deviation", "spatial_frequency"):
        assert getattr(eval_metrics, name)(fused) == getattr(jeval, name)(fused), name
    assert eval_metrics.mutual_information(fused, ir) == jeval.mutual_information(fused, ir)
    for name in ("fusion_mutual_information", "scd", "qabf"):
        assert getattr(eval_metrics, name)(fused, ir, vis) == getattr(jeval, name)(fused, ir, vis), name


@pytest.mark.parametrize("shape", [(48, 40), (32, 36, 1)], ids=["hw", "hw1"])
def test_score_fusion_matches_jax(shape):
    fused, ir, vis = _eval_images(shape, seed=9)
    ref = jeval.score_fusion(fused, ir, vis)
    got = eval_metrics.score_fusion(fused, ir, vis, device="cpu")
    assert list(got) == list(ref)
    for key, value in ref.items():
        if key.startswith(("SSIM", "PSNR")):
            np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("hw", [(512, 512), (224, 224), (100, 90), (2160, 3840)])
@pytest.mark.parametrize("model", ["default", "tiny"])
def test_model_flops_equal_jax(model, hw):
    kw = TINY if model == "tiny" else {}
    got = flops.model_flops_per_pair(ModelConfig(**kw), hw)
    assert got == jflops.model_flops_per_pair(jcfg.ModelConfig(**kw), hw)
    assert got["total"] == sum(got["per_stage"].values())
    assert flops.mfu(2.0, got["total"], 67.0) == jflops.mfu(2.0, got["total"], 67.0)
