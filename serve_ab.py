#!/usr/bin/env python3
"""fuse_y of the PyTorch port under one ``attention_impl`` (``cuda`` by default) at 512x512,
fp32 and bf16, for the package in one checkout: the bs=1 median latency of 20 requests, the
bs=32 pairs/s of 3 calls (medians) and one bs=1 request's device busy time from
``torch.profiler``, with the full default model and random weights from seed 0; with
``--train``, also the median of 5 train steps at 224x224 batch 20 after a first one. Prints
one ``[ab] LABEL {json}`` line. With ``--hashes`` it serves nothing and prints ``[hash] LABEL
{json}``: a digest of every output of K3's forward and backward, each without dropout and with
it, and of K1's and K4's forward and backward, each without dropout and with it, at stages 0-3
of a 224x224 batch-2 step, fp32 and bf16, every shift x cross case, inputs from fixed seeds,
so that two checkouts whose kernels give the same bits print the same digests. With
``--dropout`` it serves nothing and prints the ``[ab]`` line of the train steps alone, fp32 and
bf16, with every dropout ratio 0.1: their median, peak memory, and one profiled step's device
busy time and kernels.

    python3 serve_ab.py ROOT LABEL [--impl cuda_block] [--train | --hashes | --dropout]

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


def train_ms(impl: str, dtype: str, flat, steps: int = 5, drop: float = 0.0, profiled: bool = False):
    """Median wall ms of ``steps`` train steps at 224x224 batch 20 after a first one, each
    ending in a synchronise; ``drop``: every dropout ratio. ``profiled``: (the median, the
    step's peak memory in MiB, one more step's device busy ms and device kernels under
    torch.profiler)."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    cfg = Config(model=ModelConfig(attention_impl=impl, compute_dtype=dtype, attention_drop_ratio=drop,
                                   linear_after_att_drop_ratio=drop, mlp_drop_ratio=drop))
    state = create_train_state(cfg, flat, iters_per_epoch=100, device="cuda")
    step = make_train_step(cfg)
    rng = np.random.default_rng(0)
    ir, vis = (torch.from_numpy(rng.random((20, 224, 224, 1), dtype=np.float32)).cuda() for _ in range(2))
    step(state, ir, vis)
    torch.cuda.synchronize()
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        t = time.perf_counter()
        step(state, ir, vis)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    if not profiled:
        return float(np.median(walls))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    peak = torch.cuda.max_memory_allocated() / 2**20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, ir, vis)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (float(np.median(walls)), peak, sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def kernel_hashes() -> dict:
    """The digests of ``--hashes``, by kernel, stage, dtype, shift and cross."""
    import hashlib

    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    cfg = ModelConfig()
    heads, batch, out = cfg.att_num_heads, 2, {}
    for k, stage in enumerate(make_plan(224, 224, cfg.num_stages, cfg.merging_size, cfg.window_size)[:4]):
        (h, w), c = stage.att_hw, cfg.out_dims_list[k]
        d, hidden = cfg.dims_per_head(c), c * cfg.mlp_hidden_dims_ratio
        inner = heads * d
        gen = torch.Generator().manual_seed(700 + k)

        def rand(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        ln = (1.0 + rand(2, c, scale=0.1), rand(2, c, scale=0.1))
        attn = (rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1), rand(2, c, inner, scale=c**-0.5),
                rand(2, inner, scale=0.1), rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
                rand(2, inner, c, scale=inner**-0.5), rand(2, c, scale=0.1), rand(2, 49, 49))
        mlp = (rand(2, c, hidden, scale=c**-0.5), rand(2, hidden, scale=0.1), rand(2, hidden, c, scale=hidden**-0.5),
               rand(2, c, scale=0.1))
        x32, g32 = rand(2, batch, h, w, c), rand(2, batch, h, w, c)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            for shift in (False, True):
                for cross in (False, True):
                    kw = dict(window=(7, 7), num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                    key = f"s{k} {str(dtype)[6:]} shift={int(shift)} cross={int(cross)}"
                    drop = dict(kw, attn_drop_rate=0.1, drop_seed=11 + k)
                    out[f"K3 {key}"] = digest([twa._launch_fwd(x, attn, kw)])
                    out[f"K3 bwd {key}"] = digest(twa._launch_bwd(g, x, attn, kw))
                    out[f"K3 drop {key}"] = digest([twa._launch_fwd(x, attn, drop)])
                    out[f"K3 drop bwd {key}"] = digest(twa._launch_bwd(g, x, attn, drop))
                    for name, layout in (("K4", "image"), ("K1", "windows")):
                        shape = (2, batch, (h // 7) * (w // 7), 49, c) if layout == "windows" else x.shape
                        xl, gl, weights = x.reshape(shape), g.reshape(shape), (*ln, *attn, *ln, *mlp)
                        bkw = dict(kw, layout=layout, hw=(h, w))
                        bdrop = dict(bkw, drop_rates=(0.1, 0.1, 0.1), drop_seed=13 + k)
                        out[f"{name} {key}"] = digest([tfb._launch_fwd(xl, weights, bkw)])
                        out[f"{name} bwd {key}"] = digest(tfb._launch_bwd(gl, xl, weights, bkw))
                        out[f"{name} drop {key}"] = digest([tfb._launch_fwd(xl, weights, bdrop)])
                        out[f"{name} drop bwd {key}"] = digest(tfb._launch_bwd(gl, xl, weights, bdrop))
    torch.cuda.synchronize()
    return out


def main(root: str, label: str, impl: str, train: bool, hashes: bool = False, dropout: bool = False) -> None:
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
    if hashes:
        print(f"[hash] {label} {json.dumps(kernel_hashes())}", flush=True)
        return
    flat = random_variables(ModelConfig(), seed=0)
    if dropout:
        res = {}
        for dtype in ("float32", "bfloat16"):
            ms, peak, busy, kernels = train_ms(impl, dtype, flat, drop=0.1, profiled=True)
            res[dtype] = dict(train_224x20_dropout_median_ms=ms, peak_mib=peak, device_busy_ms=busy,
                              device_kernels=kernels)
            torch.cuda.empty_cache()
        print(f"[ab] {label} {impl} {json.dumps(res)}", flush=True)
        return
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
    what = parser.add_mutually_exclusive_group()
    what.add_argument("--train", action="store_true")
    what.add_argument("--hashes", action="store_true")
    what.add_argument("--dropout", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        sys.exit(1)
    main(args.root, args.label, args.impl, args.train, args.hashes, args.dropout)
