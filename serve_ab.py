#!/usr/bin/env python3
"""fuse_y of the PyTorch port under ``attention_impl="cuda"`` at 512x512, fp32 and bf16, for
the package in one checkout: the bs=1 median latency of 20 requests, the bs=32 pairs/s of
3 calls (medians) and one bs=1 request's device busy time from ``torch.profiler``, with the
full default model and random weights from seed 0. Prints one ``[ab] LABEL {json}`` line.

    python3 serve_ab.py ROOT LABEL

ROOT is a checkout of one commit (``git archive`` of a parent unpacked into a directory
that ``.gitignore`` lists, or ``.``). To compare two commits on one card, run them in
turns in one session: parent, change, change, parent. Needs a CUDA device.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main(root: str, label: str) -> None:
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
        fuser = Fuser(Config(model=ModelConfig(attention_impl="cuda", compute_dtype=dtype)), flat)
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
    print(f"[ab] {label} {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        sys.exit(1)
    main(sys.argv[1], sys.argv[2])
