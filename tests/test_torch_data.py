"""The port's data pipeline (``data/dataset.py``) against the JAX package's, on a folder of
PNG pairs written with cv2: the pairing walk and the split equal; every dataset item over
two epochs and every batch of the loaders, in order, equal bit for bit; the numpy bilinear
resize that replaces cv2's where cv2 is absent equals the JAX fallback bit for bit; without
cv2 both datasets raise the same error; ``device_prefetch`` on the CPU hands out the
batches as tensors, keeps the path lists, and raises a producer's exception in the
consumer.

A few seconds in one process.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from swin_unet_image_fusion_tpu.config import DataConfig as JaxDataConfig  # noqa: E402
from swin_unet_image_fusion_tpu.data import dataset as jds  # noqa: E402
from swin_unet_image_fusion_tpu_torch.config import DataConfig  # noqa: E402
from swin_unet_image_fusion_tpu_torch.data import dataset as tds  # noqa: E402
from swin_unet_image_fusion_tpu_torch.testing import ArrayPairDataset  # noqa: E402

PAIRS = 10
CROP = (28, 36)
SEED = 3


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(11)
    for sub in ("a", "b"):  # two leaf folders of each kind: the walk gathers both
        (root / sub / "ir").mkdir(parents=True)
        (root / sub / "vis").mkdir(parents=True)
    for i in range(PAIRS):
        sub = "a" if i % 3 else "b"
        h, w = 40 + 3 * i, 52 - 2 * i
        cv2.imwrite(str(root / sub / "ir" / f"{i:02d}.png"), (rng.random((h, w)) * 255).astype(np.uint8))
        cv2.imwrite(str(root / sub / "vis" / f"{i:02d}.png"), (rng.random((h, w, 3)) * 255).astype(np.uint8))
    return str(root)


def _datasets(folder, is_test=False):
    return (jds.FusionPairDataset(is_test, folder, JaxDataConfig(crop_size=CROP), seed=SEED),
            tds.FusionPairDataset(is_test, folder, DataConfig(crop_size=CROP), seed=SEED))


def _assert_items_equal(a, b, what):
    assert set(a) == set(b), what
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, (what, key)
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{what} {key}")
        else:
            assert a[key] == b[key], (what, key)


def test_pairing_and_split_equal_jax(folder):
    assert tds.collect_pair_paths(folder) == jds.collect_pair_paths(folder)
    for n, ratio, seed in ((10, 0.75, 0), (10, 0.99, 3), (101, 0.5, 7)):
        for got, ref in zip(tds.split_train_val(n, ratio, seed), jds.split_train_val(n, ratio, seed)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_items_equal_jax_bit_for_bit_over_two_epochs(folder, is_test):
    ref, got = _datasets(folder, is_test)
    assert len(got) == len(ref) == PAIRS
    for epoch in (1, 2):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        for i in range(PAIRS):
            _assert_items_equal(ref[i], got[i], f"epoch {epoch} item {i}")


def test_batch_loader_order_and_batches_equal_jax(folder):
    ref, got = _datasets(folder)
    tr, _ = tds.split_train_val(PAIRS, 0.8, SEED)
    for drop_last in (True, False):
        loaders = [mod.BatchLoader(ds, tr, 3, shuffle=True, drop_last=drop_last, seed=SEED)
                   for mod, ds in ((jds, ref), (tds, got))]
        assert len(loaders[0]) == len(loaders[1])
        for epoch in (1, 2):  # the shuffle generator runs on across epochs
            ref.set_epoch(epoch)
            got.set_epoch(epoch)
            batches = [list(loader) for loader in loaders]
            assert len(batches[0]) == len(batches[1]) == len(loaders[0])
            for k, (a, b) in enumerate(zip(*batches)):
                _assert_items_equal(a, b, f"drop_last {drop_last} epoch {epoch} batch {k}")


def test_numpy_resize_fallback_equals_jax(monkeypatch):
    monkeypatch.setattr(jds, "cv2", None)
    monkeypatch.setattr(tds, "cv2", None)
    rng = np.random.default_rng(5)
    for shape, (top, left, h, w), out_hw in (((40, 52, 1), (3, 5, 30, 41), (28, 36)),
                                             ((40, 52, 3), (0, 0, 40, 52), (56, 56)),
                                             ((33, 47, 1), (10, 2, 7, 9), (28, 28))):
        img = rng.random(shape, dtype=np.float32)
        got = tds.resized_crop(img, top, left, h, w, out_hw)
        ref = jds.resized_crop(img, top, left, h, w, out_hw)
        assert got.dtype == ref.dtype == np.float32 and got.shape == (*out_hw, shape[2])
        np.testing.assert_array_equal(got, ref)


def test_without_cv2_both_datasets_raise_the_same_error(folder, monkeypatch):
    ref, got = _datasets(folder)
    monkeypatch.setattr(jds, "cv2", None)
    monkeypatch.setattr(tds, "cv2", None)
    with pytest.raises(RuntimeError) as ref_exc:
        ref[0]
    with pytest.raises(RuntimeError) as got_exc:
        got[0]
    assert str(got_exc.value) == str(ref_exc.value)


def test_device_prefetch_on_the_cpu():
    ds = ArrayPairDataset(6, (30, 34), DataConfig(crop_size=(14, 14)), seed=2)
    loader = tds.BatchLoader(ds, np.arange(6), 2, shuffle=False)
    expected = list(loader)
    got = list(tds.device_prefetch(iter(loader), depth=1, device="cpu"))
    assert len(got) == len(expected) == 3
    for a, b in zip(got, expected):
        for key in ("ir", "vis"):
            assert isinstance(a[key], torch.Tensor) and a[key].device.type == "cpu"
            np.testing.assert_array_equal(a[key].numpy(), b[key])
        assert a["ir_path"] == b["ir_path"] and a["vis_path"] == b["vis_path"]
    assert ds[0]["ir"].shape == (14, 14, 1) and ds[0]["vis"].shape == (14, 14, 1)


def test_device_prefetch_raises_the_producers_error_in_the_consumer():
    def batches():
        yield {"ir": np.zeros((1, 2, 2, 1), np.float32), "ir_path": ["x"]}
        raise NameError("either ir or vis image failed to decode")

    stream = tds.device_prefetch(batches(), depth=2, device="cpu")
    first = next(stream)
    assert first["ir_path"] == ["x"]
    with pytest.raises(NameError, match="failed to decode"):
        next(stream)
