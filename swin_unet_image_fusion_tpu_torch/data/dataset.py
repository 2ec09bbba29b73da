"""IR/visible pair dataset with paired augmentation, the batch loader and the prefetch to
the device (port of the JAX ``data/dataset.py``).

- pairing: walk ``dataset_folder`` for files under ``ir/`` and ``vis/`` folders, sorted;
- colour: IR decoded grayscale with a channel axis, VIS as BGR -> YCrCb; training keeps
  only the Y channel, test mode all three;
- augmentation: one draw from a per-item generator ``np.random.default_rng((seed,
  epoch, index))`` applied to both images of the pair, so that a seed gives the same
  epochs whatever thread decodes an item: torchvision's RandomResizedCrop parameters
  (scale (0.08, 1), log-uniform aspect in (3/4, 4/3), 10 proposals then a centre crop),
  a bilinear resize (cv2's, or a numpy fallback without cv2) and a horizontal flip;
- decoding fans out over a thread pool; :func:`device_prefetch` copies batches to the
  device ``depth`` batches ahead of the step.

Decoding needs cv2, as in the JAX package: without it :meth:`FusionPairDataset._read_pair`
raises, and a dataset of arrays overrides that one method
(``testing.ArrayPairDataset``). Layout: NHWC float32 in [0, 1]; the loader and the
prefetch hand out torch tensors on the device, path lists stay on the host.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..config import DataConfig

try:  # the image decoder; without it only datasets of arrays load
    import cv2
except ImportError:
    cv2 = None


def collect_pair_paths(dataset_folder: str) -> Tuple[List[str], List[str]]:
    """Every file under an ``ir/`` and under a ``vis/`` folder below ``dataset_folder``,
    each list sorted."""
    ir_paths: List[str] = []
    vis_paths: List[str] = []
    for root, _dirs, files in os.walk(dataset_folder):
        base = os.path.basename(root)
        if base == "ir":
            ir_paths.extend(os.path.join(root, f) for f in files)
        elif base == "vis":
            vis_paths.extend(os.path.join(root, f) for f in files)
    return sorted(ir_paths), sorted(vis_paths)


def sample_resized_crop_params(rng: np.random.Generator, height: int, width: int,
                               scale: Tuple[float, float],
                               ratio: Tuple[float, float]) -> Tuple[int, int, int, int]:
    """torchvision ``RandomResizedCrop.get_params``: (top, left, h, w)."""
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # fallback: a centre crop clamped to the ratio bounds
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    top = (height - h) // 2
    left = (width - w) // 2
    return top, left, h, w


def resized_crop(img: np.ndarray, top: int, left: int, h: int, w: int,
                 out_hw: Tuple[int, int]) -> np.ndarray:
    """Crop an HWC float image, then resize it bilinearly to ``out_hw``: cv2's
    ``INTER_LINEAR`` where cv2 is present, else a numpy bilinear resize with half-pixel
    centres."""
    patch = img[top: top + h, left: left + w]
    if cv2 is not None:
        out = cv2.resize(patch, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
        if out.ndim == 2:
            out = out[:, :, None]
        return out
    hh, ww = out_hw
    ys = np.clip((np.arange(hh) + 0.5) * h / hh - 0.5, 0, h - 1)
    xs = np.clip((np.arange(ww) + 0.5) * w / ww - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    p = patch
    out = (p[y0][:, x0] * (1 - wy) * (1 - wx) + p[y0][:, x1] * (1 - wy) * wx
           + p[y1][:, x0] * wy * (1 - wx) + p[y1][:, x1] * wy * wx)
    return out.astype(img.dtype)


class FusionPairDataset:
    """Paired IR/VIS images under ``dataset_folder`` (the reference ``MyDataset``)."""

    def __init__(self, is_test: bool, dataset_folder: str, cfg: DataConfig = DataConfig(),
                 seed: int = 0):
        self.is_test = is_test
        self.cfg = cfg
        self.dataset_folder = Path(dataset_folder)
        self.ir_paths, self.vis_paths = collect_pair_paths(dataset_folder)
        if not self.ir_paths:
            raise FileNotFoundError(f"no image pairs found: expected ir/ and vis/ subfolders "
                                    f"under '{dataset_folder}'")
        if len(self.ir_paths) != len(self.vis_paths):
            raise ValueError(f"ir/vis count mismatch: {len(self.ir_paths)} vs {len(self.vis_paths)}")
        self.seed = seed
        self._aug_epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream: new draws each epoch, the same for a seed."""
        self._aug_epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.ir_paths)

    def _read_pair(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """Pair ``index`` decoded: IR (H, W, 1) and VIS YCrCb (H, W, 3), float32 in [0, 1]."""
        if cv2 is None:
            raise RuntimeError("cv2 required for image decoding")
        ir_path, vis_path = self.ir_paths[index], self.vis_paths[index]
        ir = cv2.imread(ir_path, cv2.IMREAD_GRAYSCALE)
        vis = cv2.imread(vis_path, cv2.IMREAD_COLOR)
        if ir is None or vis is None:
            raise NameError(f"either ir or vis image failed to decode:\n"
                            f"  ir_path = {ir_path}\n  vis_path = {vis_path}")
        ir = ir[..., None].astype(np.float32) / 255.0
        vis = cv2.cvtColor(vis, cv2.COLOR_BGR2YCrCb).astype(np.float32) / 255.0
        return ir, vis

    def __getitem__(self, index: int) -> Dict[str, object]:
        ir, vis = self._read_pair(index)
        if not self.is_test:
            vis = vis[..., 0:1]  # the Y channel only, for training
            ir, vis = self.augment_pair(ir, vis, index)
        return {"ir": ir, "vis": vis, "ir_path": self.ir_paths[index],
                "vis_path": self.vis_paths[index]}

    def augment_pair(self, ir: np.ndarray, vis: np.ndarray, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """One draw of crop and flip applied to both images, from the item's generator
        of (seed, epoch, index)."""
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, self._aug_epoch, index))
        h, w = ir.shape[:2]
        top, left, ch, cw = sample_resized_crop_params(rng, h, w, cfg.crop_scale, cfg.crop_ratio)
        ir = resized_crop(ir, top, left, ch, cw, cfg.crop_size)
        vis = resized_crop(vis, top, left, ch, cw, cfg.crop_size)
        if rng.random() < cfg.hflip_prob:
            ir = ir[:, ::-1]
            vis = vis[:, ::-1]
        return np.ascontiguousarray(ir), np.ascontiguousarray(vis)


def split_train_val(n: int, train_ratio: float, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded random split of ``range(n)``: (train indices, validation indices)."""
    perm = np.random.default_rng(seed).permutation(n)
    n_train = int(round(n * train_ratio))
    return perm[:n_train], perm[n_train:]


class BatchLoader:
    """Shuffling (optionally drop-last) batches of ``dataset[indices]`` as numpy arrays,
    decoded on a thread pool. The shuffle generator is seeded once and runs on across
    epochs."""

    def __init__(self, dataset: FusionPairDataset, indices: Sequence[int], batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_threads: int = 8):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_threads)

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, object]]:
        order = self.indices.copy()
        if self.shuffle:
            self.rng.shuffle(order)
        limit = (len(order) // self.batch_size) * self.batch_size if self.drop_last else len(order)
        for start in range(0, limit, self.batch_size):
            chunk = order[start: start + self.batch_size]
            items = list(self.pool.map(self.dataset.__getitem__, chunk))
            yield {
                "ir": np.stack([it["ir"] for it in items]),
                "vis": np.stack([it["vis"] for it in items]),
                "ir_path": [it["ir_path"] for it in items],
                "vis_path": [it["vis_path"] for it in items],
            }


def device_prefetch(iterator: Iterator[Dict[str, object]], depth: int = 2,
                    device: torch.device | str = "cuda") -> Iterator[Dict[str, object]]:
    """Batches of ``iterator`` with their numpy arrays as tensors on ``device``, copied up
    to ``depth`` batches ahead by a producer thread; other leaves (the path lists) pass
    as they are.

    On a CUDA device each batch is pinned and copied with ``non_blocking=True`` on a
    stream of its own; the consumer's stream waits on the copy's event before the batch
    is handed out, so that no kernel reads a batch before it has arrived. On the CPU the
    arrays are wrapped without a copy. An exception in the producer (a decode error) is
    raised again in the consumer; closing the generator stops the producer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch was asked for a CUDA device and none is available")
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch):
        arrays = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
        event = None
        if cuda:
            with torch.cuda.stream(copy_stream):
                arrays = {k: v.pin_memory().to(device, non_blocking=True) for k, v in arrays.items()}
                event = torch.cuda.Event()
                event.record(copy_stream)
        return {**batch, **arrays}, event

    def producer():
        try:
            for batch in iterator:
                if not put(to_device(batch)):
                    return
            put(done)
        except BaseException as exc:  # handed to the consumer, which raises it
            put(exc)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for value in batch.values():
                    if isinstance(value, torch.Tensor):
                        value.record_stream(stream)  # made on the copy stream, used on this one
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
