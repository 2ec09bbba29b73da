#!/usr/bin/env python3
"""The fused block's split route (stages 2-4 of ``csrc/fused_block_fwd.cu``) in variant builds
against the committed one, on one CUDA card: each variant is a copy of
``fused_block_fwd.cu`` (with ``--dropout``, of ``fused_block_fwd_drop.cu``; the kernels live in
``fused_block_fwd.cuh``, a variant of which goes beside the copy) with the same C interface,
built by ``nvcc`` with the port's flags,
``-I`` the ``csrc`` directory and its own ``-D`` flags (a copy's quoted includes find headers
copied beside it first). At every split-route block of a
512x512 request (stage x role x shift x cross; K1 at the packed stages in the windows
layout, K4 in the image layout; fp32 and bf16) each build is checked for a bit-identical
repeat and against the committed build's output, and its kernels' device time is read by
``torch.profiler`` in turns with the others (the order reversed at every other block), as
``chip_smoke.py``'s ``[split]`` lines read it. Prints one ``[variant]`` line per (kernel,
dtype, build, stage) with the device ms per request by kernel, and one total per (kernel,
dtype, build). With ``--dropout`` it times the dropout form instead, at every block of stages
0-3 of a 224x224 batch-20 train step (the one-launch route at stages 0-1, the six launches at
2-3), every site at ``chip_smoke.DROP_RATIOS``, per step.

    python3 split_ab.py [--dropout] NAME=PATH[:-DFLAG=VALUE,...] [NAME=PATH...]

Needs a CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402

SPLIT_STAGES = (2, 3, 4)


def build(name: str, spec: str, out_dir: Path) -> subprocess.Popen:
    """Start ``nvcc`` on a variant source (``PATH[:-DFLAG=VALUE,...]``) into ``out_dir``."""
    from swin_unet_image_fusion_tpu_torch.ops import _build

    path, _, flags = spec.partition(":")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), *filter(None, flags.split(",")),
           "-o", str(out_dir / f"{name}.so"), path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load(so: Path, like: ctypes.CDLL) -> ctypes.CDLL:
    """A variant library bound with the committed library's signatures."""
    lib = ctypes.CDLL(str(so))
    for fn in ("swin_k4_fwd", "swin_k4_fwd_smem", "swin_cuda_error_string"):
        getattr(lib, fn).argtypes = getattr(like, fn).argtypes
        getattr(lib, fn).restype = getattr(like, fn).restype
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("split_ab: no CUDA device", file=sys.stderr)
        return 1
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.ops import _build
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    dropout = "--dropout" in sys.argv[1:]
    specs = dict(arg.split("=", 1) for arg in sys.argv[1:] if arg != "--dropout")
    if not specs or "committed" in specs:
        print(__doc__, file=sys.stderr)
        return 2
    start = time.perf_counter()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: build(name, spec, out_dir) for name, spec in specs.items()}
    committed = tfb._fwd_library(dropout)
    libs = {"committed": committed}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed on {specs[name]}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = load(out_dir / f"{name}.so", committed)
    print(f"[variant] built {', '.join(libs)} in {time.perf_counter() - start:.1f} s", flush=True)

    card = cs.card_line()
    cfg = ModelConfig()
    device = torch.device("cuda")
    names = list(libs)
    stages, hw, batch = ((0, 1, 2, 3), cs.TRAIN_HW, cs.TRAIN_BATCH) if dropout else (SPLIT_STAGES, cs.SERVE_HW, 1)
    per = f"per {hw[0]}x{hw[1]} batch-{batch} step" if dropout else "per 512x512 request"
    for dtype in (torch.float32, cs.BF16):
        for kernel, layout, packed_only in (("K1", "windows", True), ("K4", "image", False)):
            label = f"{kernel}{cs.tag(dtype)}"
            parts = {n: {} for n in names}
            worst = dict.fromkeys(names, 0.0)
            for i, (case, x, weights) in enumerate(cs.block_cases(cfg, device, packed_only, hw, batch)):
                if case[0] not in stages:
                    continue
                xl, kw = cs.fused_args(case, x.to(dtype), layout)
                if dropout:
                    kw = dict(kw, drop_rates=cs.DROP_RATIOS, drop_seed=cs.DROP_SEED + i)
                outs = {}
                for n in names:
                    tfb._fwd_library = lambda drop=False, n=n: libs[n]
                    out, again = tfb._launch_fwd(xl, weights, kw), tfb._launch_fwd(xl, weights, kw)
                    torch.cuda.synchronize()
                    if not torch.equal(out, again):
                        raise AssertionError(f"{label} {n} {case}: a repeat gave other bits")
                    outs[n] = out.float()
                for n in names:
                    worst[n] = max(worst[n], (outs[n] - outs["committed"]).abs().max().item())
                order = names if i % 2 == 0 else names[::-1]
                for n in order + order[::-1]:
                    tfb._fwd_library = lambda drop=False, n=n: libs[n]
                    got = cs._profile_call(lambda: tfb._launch_fwd(xl, weights, kw), 5)
                    if got is None:
                        raise AssertionError(f"{label} {n}: the profiler recorded no whole calls")
                    cs._add_parts(parts[n].setdefault(case[0], {}), got, 0.5)
            tfb._fwd_library = lambda drop=False: committed
            for n in names:
                for k, p in parts[n].items():
                    print(f"[variant] {label}{' drop' if dropout else ''} {n} stage {k}, {per} (8 calls): "
                          + ", ".join(f"{kn} {ms:.4f} ms" for kn, ms in p.items())
                          + f", total {sum(p.values()):.4f} ms | {card}", flush=True)
            for n in names:
                total = sum(sum(p.values()) for p in parts[n].values())
                print(f"[variant] {label}{' drop' if dropout else ''} {n}: stages {sorted(parts[n])} {total:.4f} ms "
                      f"of device time {per}, max |diff| against the committed build {worst[n]:.3e} | {card}",
                      flush=True)
    print(f"[variant] done in {time.perf_counter() - start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
