#!/usr/bin/env python3
"""K1's and K4's backward on the split route (``csrc/fused_block_bwd_split.cu``), or with
``--source fused_block_bwd`` on the fused route (``csrc/fused_block_bwd.cu``), in variant builds
against the committed one and the twenty launches of ``csrc/fused_block.cu``, on one CUDA card;
with ``--dropout``, every call at dropout rates 0.1 (the routes' dropout forms and the twenty
launches' dropout form). Each variant is a copy of the source with the same C interface (for
instance one whose ``split_pitch`` also takes 32, or a copy of the whole ``csrc`` directory
with one header changed: a source includes the headers beside it first), built by ``nvcc``
with the port's flags, ``-I`` the ``csrc`` directory and its own ``-D`` flags. At
every block of ``--stages`` of an ``--hw`` map of ``--batch`` images (role x shift x cross;
``--layout`` image, K4, or windows, K1; fp32 or bf16) each build that takes the shape is
checked against the plain backward (``testing.assert_grads_close``, a bf16 g_x by
``chip_smoke.compare_kernel``) and for a bit-identical repeat, timed by CUDA events in turns
with the others and the twenty launches (the order reversed at every other block), and its
kernels' device time read by ``torch.profiler``. ``--pitch`` adds a q/k row pitch to the
plan's split route for the run (``fused_block.SPLIT_PITCHES``), so that a variant that takes
it is routed there. Prints one ``[bwd-ab]`` line per (block, build) and one total per
build.

    python3 split_bwd_ab.py [--hw H W] [--batch N] [--stages K ...] [--layout image|windows]
                            [--bf16] [--dropout] [--source fused_block_bwd_split|fused_block_bwd]
                            [--pitch P ...] [NAME=PATH[:-DFLAG=VALUE,...] ...]

Needs a CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from split_ab import build  # noqa: E402

FUNCTIONS = {source: (f"swin_block_{name}", f"swin_block_{name}_workspace", f"swin_block_{name}_smem",
                      "swin_cuda_error_string")
             for source, name in (("fused_block_bwd_split", "bwd_split"), ("fused_block_bwd", "bwd"))}
ROUTE = {"fused_block_bwd_split": "split", "fused_block_bwd": "fused"}


def load(so: Path, like, source):
    """A variant library of ``source`` bound with the committed library's signatures."""
    import ctypes

    lib = ctypes.CDLL(str(so))
    for fn in FUNCTIONS[source]:
        getattr(lib, fn).argtypes = getattr(like, fn).argtypes
        getattr(lib, fn).restype = getattr(like, fn).restype
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--hw", type=int, nargs=2, default=list(cs.TRAIN_HW))
    parser.add_argument("--batch", type=int, default=cs.TRAIN_BATCH)
    parser.add_argument("--stages", type=int, nargs="+", default=[2, 3])
    parser.add_argument("--layout", choices=("image", "windows"), default="image")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--dropout", action="store_true")
    parser.add_argument("--source", choices=tuple(FUNCTIONS), default="fused_block_bwd_split")
    parser.add_argument("--pitch", type=int, action="append", default=[])
    parser.add_argument("variants", nargs="*")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("split_bwd_ab: no CUDA device", file=sys.stderr)
        return 1
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.ops import _build
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs = dict(arg.split("=", 1) for arg in args.variants)
    start = time.perf_counter()
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: build(name, spec, out_dir) for name, spec in specs.items()}
    _build.build_all((args.source, "fused_block"))
    split = args.source == "fused_block_bwd_split"
    committed = tfb._split_library() if split else tfb._bwd_library()
    libs = {"committed": committed}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"nvcc failed on {specs[name]}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = load(out_dir / f"{name}.so", committed, args.source)
    print(f"[bwd-ab] built {', '.join(libs)} in {time.perf_counter() - start:.1f} s", flush=True)
    tfb.SPLIT_PITCHES = tuple(sorted(set(tfb.SPLIT_PITCHES) | set(args.pitch)))
    tfb.block_bwd_plan.cache_clear()
    card = cs.card_line()
    dtype = cs.BF16 if args.bf16 else torch.float32
    names = ("x", *tfb.WEIGHT_NAMES)
    totals = {}
    for i, (case, x, weights) in enumerate(cs.block_cases(ModelConfig(), "cuda", False, tuple(args.hw), args.batch)):
        k, h, w, c, heads, d, role, hidden, shift, cross = case
        if k not in args.stages:
            continue
        xl, kw = cs.fused_args(case, x.to(dtype), args.layout)
        if args.dropout:
            kw = dict(kw, drop_rates=cs.DROP_RATIOS, drop_seed=cs.DROP_SEED + k)
        g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(k)).to("cuda", dtype)
        plan = tfb.block_bwd_plan(c, heads, d, hidden, cs.WINDOW, cross, args.dropout)
        ref = tfb.fused_block_bwd_plain(g, xl, *weights, **kw)

        def on(lib):
            def run():
                if split:
                    tfb._split_library = lambda: lib
                else:
                    tfb._bwd_library = lambda: lib
                return tfb._launch_bwd(g, xl, weights, kw)
            return run

        def takes(lib):
            if plan.route != ROUTE[args.source]:
                return False
            if split:
                return lib.swin_block_bwd_split_smem(0, c, heads, d, hidden, plan.hidden_chunk, *plan.heads_per_block,
                                                     int(cross), int(args.dropout)) > 0
            return lib.swin_block_bwd_smem(0, c, heads, d, hidden, plan.hidden_chunk, int(cross), int(args.dropout)) > 0

        forms = {name: on(lib) for name, lib in libs.items() if takes(lib)}
        forms["twenty launches"] = lambda: tfb._launch_bwd_five(g, xl, weights, kw)
        label = (f"stage {k} {role} {h}x{w}x{args.batch} C={c} hidden={hidden} shift={shift} cross={cross} "
                 f"{args.layout} {str(dtype)[6:]}{' dropout' if args.dropout else ''}")
        for name in (forms if i % 2 == 0 else reversed(forms)):
            got, again = forms[name](), forms[name]()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if dtype == cs.BF16:
                cs.compare_kernel(got[0], ref[0], f"[bwd-ab] {name} {label} g_x")
                worst = assert_grads_close(got[1:], ref[1:], names[1:], f"{name} {label}").worst_own
            else:
                worst = assert_grads_close(got, ref, names, f"{name} {label}").worst_own
            del got, again
            ms = cs.time_ms(forms[name], iters=5, warmup=1)
            parts = cs._profile_kernels(forms[name], 3) or {}
            totals[name] = totals.get(name, 0.0) + ms
            print(f"[bwd-ab] {name} {label}: {ms:.4f} ms by events, {sum(parts.values()):.4f} ms of device time ("
                  + ", ".join(f"{n} {v:.4f}" for n, v in sorted(parts.items(), key=lambda kv: -kv[1]))
                  + f"); worst {worst:.2e} of a gradient's own largest, repeat bit for bit {same} | {card}",
                  flush=True)
        del g, ref
        torch.cuda.empty_cache()
    for name, ms in totals.items():
        print(f"[bwd-ab] {name}: {ms:.3f} ms by events over the blocks of stages {args.stages} of "
              f"{args.hw[0]}x{args.hw[1]} batch {args.batch} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
