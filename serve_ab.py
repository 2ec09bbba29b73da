#!/usr/bin/env python3
"""fuse_y of the PyTorch port under one ``attention_impl`` (``cuda`` by default) at 512x512,
fp32 and bf16, for the package in one checkout: the bs=1 median latency of 20 requests, the
bs=32 pairs/s of 3 calls (medians) and one bs=1 request's device busy time from
``torch.profiler``, with the full default model and random weights from seed 0; with
``--train``, also the median of 5 train steps at 224x224 batch 20 after a first one. Prints
one ``[ab] LABEL {json}`` line.

    python3 serve_ab.py ROOT LABEL [--impl cuda_block] [--train]

ROOT is a checkout of one commit (``git archive`` of a parent unpacked into a directory
that ``.gitignore`` lists, or ``.``). To compare two commits on one card, run them in
turns in one session: parent, change, change, parent. Needs a CUDA device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def train_ms(impl: str, dtype: str, flat, steps: int = 5) -> float:
    """Median wall ms of ``steps`` train steps at 224x224 batch 20 after a first one, each
    ending in a synchronise."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(attention_impl=impl, compute_dtype=dtype))
    state = create_train_state(cfg, flat, iters_per_epoch=100, device="cuda")
    step = make_train_step(cfg)
    rng = np.random.default_rng(0)
    ir, vis = (torch.from_numpy(rng.random((20, 224, 224, 1), dtype=np.float32)).cuda() for _ in range(2))
    step(state, ir, vis)
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t = time.perf_counter()
        step(state, ir, vis)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    return float(np.median(walls))


def main(root: str, label: str, impl: str, train: bool) -> None:
    sys.path.insert(0, root)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import swin_unet_image_fusion_tpu_torch as pkg
    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
    from swin_unet_image_fusion_tpu_torch.ops import _build

    if not Path(pkg.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"imported {pkg.__file__}, not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    flat = random_variables(ModelConfig(), seed=0)
    rng = np.random.default_rng(0)
    one = [rng.random((1, 512, 512, 1), dtype=np.float32) for _ in range(2)]
    many = [rng.random((32, 512, 512, 1), dtype=np.float32) for _ in range(2)]
    res = {}
    for dtype in ("float32", "bfloat16"):
        fuser = Fuser(Config(model=ModelConfig(attention_impl=impl, compute_dtype=dtype)), flat)
        fuser.fuse_y(*one)
        fuser.fuse_y(*many)
        walls = []
        for _ in range(20):
            t = time.perf_counter()
            fuser.fuse_y(*one)
            walls.append(1e3 * (time.perf_counter() - t))
        calls = []
        for _ in range(3):
            t = time.perf_counter()
            fuser.fuse_y(*many)
            calls.append(time.perf_counter() - t)
        busy = None
        for _ in range(3):  # a profiler session now and then records no device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fuser.fuse_y(*one)
                torch.cuda.synchronize()
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA) / 1e3 or None
            if busy:
                break
        res[dtype] = dict(bs1_median_ms=float(np.median(walls)),
                          bs32_pairs_per_s=32 / float(np.median(calls)), bs1_device_busy_ms=busy)
        del fuser
        torch.cuda.empty_cache()
        if train:
            res[dtype]["train_224x20_median_ms"] = train_ms(impl, dtype, flat)
            torch.cuda.empty_cache()
    print(f"[ab] {label} {impl} {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root")
    parser.add_argument("label")
    parser.add_argument("--impl", default="cuda")
    parser.add_argument("--train", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        sys.exit(1)
    main(args.root, args.label, args.impl, args.train)
