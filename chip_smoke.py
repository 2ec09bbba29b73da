#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``swin_unet_image_fusion_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each against its plain PyTorch version at
the shapes of a 512x512 request: window attention (K3), the fused block on
window-packed tokens (K1) and on the image (K4), and the window re-partition (K2,
bit-exact). Then it serves ``Fuser.fuse_y`` requests with the full default
33M-parameter model (weights made with numpy from a seed) at 512x512 and 100x90 under
each kernel configuration (``cuda``: K3; ``cuda_pack``: K1, K2 and K3; ``cuda_block``:
K4), checks the outputs and each kernel's launch count, times the kernels and the
requests, and breaks one request's device time down by kernel family with
``torch.profiler``. The fused block's forward without dropout, K4 on the image and K1 on
window-packed tokens, is ``csrc/fused_block_fwd.cu`` (one launch at C <= 48, six above; its
dropout forms ``csrc/fused_block_fwd_drop.cu``); each is checked for a bit-identical repeat,
timed in turns with the five launches of ``csrc/fused_block.cu`` that it replaced (no call of
the model runs them), and both are broken down by stage and kernel
(``[split] K1``, ``[split] K4``). K3's forward is ``csrc/window_attention_fwd.cu`` (one
launch at C <= 64, two above, with and without dropout); it is checked for a bit-identical
repeat, timed in turns with the three launches of ``csrc/window_attention.cu`` that it
replaced (which no call of the model runs now), and both are broken down by stage and kernel
from the profiler's device times (``[split]``). Then the training path: each backward
kernel (K3, K1, K2 and K4 bwd) against autograd of its plain version at the shapes of a
224x224 batch-20 train step, K1's and K4's each repeated bit for bit; their backward is the
route ``block_bwd_plan`` names, with and without dropout ("fused", ``csrc/fused_block_bwd.cu``,
at stages 0-1, "split", ``csrc/fused_block_bwd_split.cu``, at stages 2-4, each in its dropout
form for a dropout call), broken down by stage and kernel in turns with the twenty-launch
backward of ``csrc/fused_block.cu`` (``[split] K1 bwd``, ``[split] K4 bwd``), and the same
at the stage-4 shapes (C = 384) of a 448x448 batch-5 step, fp32 and bf16, with and without
dropout (K3's backward there and at the 512x512 stage 4 on its d = 48 tiled core); the first
train step of the full model under each configuration against the torch composition on the
card (loss terms, every parameter's gradient, the exact forward and backward launches), then
timed steps in turns and one profiled step per configuration; the same at 448x448 batch 5,
where stage 4 runs the kernels, its traced steps holding no kernel of ``csrc/fused_block.cu``
or ``csrc/window_attention.cu``, stage 4's device time by kernel family, and one
``cuda_block`` dropout step repeated bit for bit (``[train] 448``). The bf16 serving path
(``compute_dtype="bfloat16"``) takes the same steps: the bf16 form of each kernel against its bf16 plain version, ``fuse_y`` under each
configuration with exact launch counts and against the bf16 and the fp32 torch
compositions on the card by image-level criteria, kernel times, latencies in turns with
the fp32 configurations, a traced request each, and the throughput of 512x512 batches of
32 in both dtypes. Dropout training (every ratio 0.1, a test setting: the reference
configuration trains without dropout): the hash-dropout forms of K3, K1 and K4, forward
and backward, against their plain versions at rates 0.1 and 0.5 at the 224x224 batch-20
shapes, with the keep fraction of each site and the times beside the forms without
dropout (K1's and K4's dropout forward on ``csrc/fused_block_fwd.cu`` and backward, and K3's
dropout forward on ``csrc/window_attention_fwd.cu`` and backward on
``csrc/window_attention_bwd.cu``, each case repeated bit for bit, also beside the old launches
they replaced: the five-launch forward and twenty-launch backward of ``csrc/fused_block.cu``,
the three-launch forward and backward of ``csrc/window_attention.cu``, per stage and per step),
the new dropout forms at one C = 384 shape (K3's dropout forward also at every stage of
100x90), and the composition's mask kernels bit for bit; the first dropout train step under
each configuration with exact launch counts and repeated bit for bit; timed in turns with the
steps without dropout, the dropout steps' traces checked to launch no kernel of
``csrc/fused_block.cu``'s forward or backward (``cuda_pack``, ``cuda_block``) or of
``csrc/window_attention.cu`` (``cuda``, fp32 and bf16, with K3's forward kernels as many as its
plan reckons and the mask kernels' device ms apart); and a full-width step on a 112x112 map on
the card against the same configuration on the CPU.
bf16 training (``compute_dtype="bfloat16"``, the JAX package's production path): the bf16
backward forms of K3, K1, K2 and K4 and the bf16 dropout forms, forward and backward,
against their plain bf16 versions at the 224x224 batch-20 shapes, without dropout and at
rates 0.1 and 0.5, their keep masks against the fp32 dropout forms', each timed in turns
with its fp32 form (the new dropout forms also with the old launches and the form without
dropout), and the bf16 token masks bit for bit; the first bf16 step under each
configuration with exact launch counts, held against the bf16 and the fp32 torch
compositions on the card, bf16 steps timed in turns with the fp32 steps and one traced;
the first bf16 dropout step under each configuration, repeated bit for bit. Then the
training entry point: ``Trainer.start_train`` on the default model over seeded arrays
(``testing.ArrayPairDataset``) at 224x224 batch 20 with exact launch counts, its step beside
the bare step, the loader, memory and checkpoints (``[trainer]``); a fresh ``Trainer`` resumed
from the epoch-1 checkpoint, bit-equal in state and next step (``[resume]``); the trained
weights out as a reference ``.pth`` and served back by ``Fuser.from_checkpoint`` bit for bit
(``[pth]``); a NaN step under ``skip_nonfinite_updates`` (``[nonfinite]``);
``python -m swin_unet_image_fusion_tpu_torch.train`` over a folder of PNG pairs (``[cli]``);
and each configuration's step with and without ``remat`` in turns, gradients held to each
other (``[remat]``). Last the serving and evaluation surface with the default model in fp32
under ``"auto"``: ``Fuser.fuse_pair_ycrcb`` against the CPU port, the torch composition and host
``cv2.cvtColor``, timed beside ``fuse_y`` (``[colour]``); ``python -m
swin_unet_image_fusion_tpu_torch.infer`` over PNG pairs, its files decoded equal to the
in-process path (``[test]``); ``TiledFuser`` at 2048x2048 and 2160x3840 (each chunk against the
composition, the blend against numpy's, exact K3 launches, uint8 against float I/O, s/image with
and without the transfers, MP/s, peak memory, a traced 4K call; ``[tiled]``); the 224x224
batch-20 step with the Canny texture term against the composition and the Sobel step, its edge
maps bit-equal to the CPU's (``[canny]``); ``score_fusion`` (``[metrics]``) and the 4K run's FLOP
rate (``[flops]``). Then the multi-device paths, as far as one card shows them: the data-parallel
step (``train.make_train_step(cfg, group)``) over an NCCL group of one rank at 224x224 batch 20
under each kernel configuration, its first step with exact launches against the bare step, timed
in turns and traced beside it (``[dist] world 1``); the data-parallel step over
a gloo group of two processes on the one card, rank 0's first step against the one-process step
on the global batch (``[dist] world 2``); the K1 band and K2 halo forms (``ops/window_pack_spmd.py``)
in 4 bands of every packed stage of a 1792x1792 request, fp32 and bf16, against the whole map's
launches (bit-equal) and their plain versions, timed beside them (K2 halo one kernel a call, in
turns with its first form, concatenation, launch and copy, and index_select), and ``SpatialFuser`` under
``cuda_pack`` over the group of one at 1792x1792 with exact launches against ``fuse_y`` and the
composition (``[spatial]``); ``TiledFuser`` over the group of one at 2048x2048 against no group
(``[tiled] world 1``). Then the relu and gelu MLP forms of K1 and K4 (``[act]``). Last K3 at windows
other than 7x7 (``[window]``): the any-window build (``window_attention_fwd_any.cu``,
``window_attention_bwd_any.cu``) forward and backward, fp32 and bf16, at 8x8, 4x4 and 7x8 windows at
every stage against the plain K3 and repeated bit for bit, the dropout forms at 8x8; each 8x8 form
timed in turns with the 7x7 form at the same C; the full-width model with 8x8 windows served at
512x512 under ``"auto"`` (fp32 against the composition, bf16 by the image criteria, timed beside
the 7x7 model) and one train step at 224x224 batch 20 without and with attention dropout, with
exact launches. Each phase prints its wall seconds (``[phase]``). Every phase raises on failure. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it lists the kernels with their
launches, errors, times and bounds.

It needs a CUDA device and the repository beside it, and exits non-zero without them.

    python3 chip_smoke.py --serving-eval

runs only the serving and evaluation group (``[colour]`` to ``[flops]``) after building the two
sources it runs, and

    python3 chip_smoke.py --multi-device

only the multi-device phases after building every source; ``--activation`` only ``[act]``, and
``--window`` only ``[window]`` after building K3's five sources; none of them prints the kernels
line or the last line. ``--dist-worker RANK STORE OUT`` is one rank of ``[dist] world 2``, which the
script starts itself.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

PEAK_FP32_FLOPS = 67e12  # H100 SXM, CUDA cores, NVIDIA's data sheet
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores, NVIDIA's data sheet
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# The hash dropout's integer work (132 SMs at 1.98 GHz, each of an SM's 4 schedulers issuing
# one warp instruction a clock): the INT32 pipe takes 16 lanes per scheduler and clock,
# half of the 32 fp32 lanes behind the 67 TFLOP/s above (an FMA is 2 FLOP); an integer and
# an fp32 instruction run on separate pipes but share the schedulers' issue slots.
PEAK_INT32_OPS = 16.7e12
PEAK_ISSUE_LANES = 33.4e12  # warp-instruction lanes issued per second, of any type
HASH_OPS = 11  # integer operations of one keep decision: fmix32 (8), the offset add, mask, compare
KERNEL_ATOL = KERNEL_RTOL = 1e-4
# bf16 kernel against its bf16 plain version: rtol 2^-7 (two bf16 ulps), atol 2^-6 x the
# case's largest magnitude (a rare one-ulp flip of an intermediate), and at most 10% of
# the elements different at all (the right rounding points differed in up to 6.0% on an
# H100, K4 at stage 4, C=384; other rounding points differ in 66-75%)
BF16_RTOL, BF16_ATOL, BF16_MAX_MISMATCH = 2.0**-7, 2.0**-6, 0.1
BF16 = torch.bfloat16
MODEL_ATOL, MODEL_RTOL = 5e-4, 1e-3
REQUESTS = 3
LATENCY_SAMPLES = 20
SEED = 0
SERVE_HW = (512, 512)
TRAIN_HW, TRAIN_BATCH = (224, 224), 20  # the JAX package's default training crop and batch
# a larger crop at which stage 4 (C = 384, 14x14) runs the kernels; at batch 5 stages 0-3 hold the
# tokens of the 224² batch-20 step
TRAIN448_HW, TRAIN448_BATCH = (448, 448), 5
TRAIN448_WIDE_BATCH = 20  # stage 4's backward checked where its blocks walk several tiles each
TRAIN_STEPS = 5  # timed steps per configuration, after the checked first one
THROUGHPUT_BATCH, THROUGHPUT_ROUNDS = 32, 3  # 512x512 pairs per fuse_y call; timed calls each
WINDOW = (7, 7)
T = WINDOW[0] * WINDOW[1]
# attention_impl -> kernel launches per request at each served shape; "fused" is K1
# under cuda_pack and K4 under cuda_block (one wrapper, two layouts)
CONFIGS = {
    "cuda": {(512, 512): {"K3": 40}, (100, 90): {"K3": 24}},
    "cuda_pack": {(512, 512): {"K1": 32, "K2": 24, "K3": 8},
                  (100, 90): {"K1": 24, "K2": 18, "K3": 8}},
    "cuda_block": {(512, 512): {"K4": 40}, (100, 90): {"K4": 24}},
}
FUSED_NAME = {"cuda": "K4", "cuda_pack": "K1", "cuda_block": "K4"}
# the configuration whose run gives each kernel's launches in the kernels line; a bf16
# kernel's come from the bf16 run of the same configuration
MAIN_PATH = {"K3": "cuda", "K1": "cuda_pack", "K2": "cuda_pack", "K4": "cuda_block"}
MAIN_PATH.update({f"{name} bf16": impl for name, impl in MAIN_PATH.items()})
DEVICE = "cuda"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def stage_geometries(cfg, hw=SERVE_HW):
    """(stage, H, W, C, heads, d) of every attention stage of an ``hw`` input."""
    from swin_unet_image_fusion_tpu_torch.ops.shape_plan import make_plan

    plan = make_plan(*hw, cfg.num_stages, cfg.merging_size, cfg.window_size)
    return [(k, *p.att_hw, cfg.out_dims_list[k], cfg.att_num_heads,
             cfg.dims_per_head(cfg.out_dims_list[k])) for k, p in enumerate(plan)]


def mlp_hiddens(cfg, k):
    """(role, MLP hidden) of stage k's encoder and decoder blocks (the decoder quirk)."""
    return (("enc", cfg.out_dims_list[k] * cfg.mlp_hidden_dims_ratio),
            ("dec", cfg.in_dims_list[k] * cfg.mlp_hidden_dims_ratio))


def _rand(gen, device):
    def rand(*shape, scale=1.0, offset=0.0):
        return (torch.randn(*shape, generator=gen) * scale + offset).to(device)
    return rand


def attention_inputs(h, w, c, heads, d, seed, device, batch=1, window=WINDOW):
    """x like an LN output, He-scaled weights, small biases, N(0, 1) bias table (T x T of the
    window's T tokens)."""
    rand = _rand(torch.Generator().manual_seed(seed), device)
    inner = heads * d
    t = window[0] * window[1]
    return (rand(2, batch, h, w, c),
            rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
            rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
            rand(2, c, inner, scale=c**-0.5), rand(2, inner, scale=0.1),
            rand(2, inner, c, scale=inner**-0.5), rand(2, c, scale=0.1),
            rand(2, t, t))


def block_inputs(h, w, c, heads, d, hidden, seed, device, batch=1):
    """x like a stage's activations and the 17 weights of one fused block (LN scales
    near 1, He-scaled dense kernels, small biases, N(0, 1) bias table)."""
    rand = _rand(torch.Generator().manual_seed(seed), device)
    inner = heads * d

    def dense(i, o):
        return rand(2, i, o, scale=i**-0.5), rand(2, o, scale=0.1)

    return (rand(2, batch, h, w, c),
            rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
            *dense(c, inner), *dense(c, inner), *dense(c, inner), *dense(inner, c),
            rand(2, T, T), rand(2, c, scale=0.1, offset=1.0), rand(2, c, scale=0.1),
            *dense(c, hidden), *dense(hidden, c))


def _bound(flops, bytes_, peak_flops=PEAK_FP32_FLOPS, int_ops=0):
    """Least time (ms) and what bounds it: the operations against the bytes at the memory
    rate. The operations take the FLOPs at their peak; with integer work, for fp32 FLOPs
    the larger of the INT32 pipe's time and the issue slots that the FMAs and the integer
    instructions share, for bf16 FLOPs (the tensor cores, which take few issue slots) the
    larger of the tensor cores' and the INT32 pipe's times."""
    t_ops = flops / peak_flops
    if int_ops and peak_flops == PEAK_FP32_FLOPS:
        t_ops = max(int_ops / PEAK_INT32_OPS, t_ops + int_ops / PEAK_ISSUE_LANES)
    elif int_ops:
        t_ops = max(int_ops / PEAK_INT32_OPS, t_ops)
    t_bytes = bytes_ / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_bound_ms(h, w, c, heads, d, batch=1, backward=False, dtype=torch.float32,
                       int_ops=0, window=WINDOW):
    """Least time for one K3 launch: matmul FLOPs over the peak for their operands vs each
    input byte read once and the output written once over HBM bandwidth (both streams).
    In bf16 the products take bf16 operands, so the FLOPs are at the dense bf16
    tensor-core rate, and x and the output are 2 bytes an element (the weights stay fp32).
    The backward's inputs are x, the weights and g alone, so its work is the forward's
    recomputed but for the projection (its output is not needed), plus the input- and
    weight-gradient products of every matmul: three times the forward's FLOPs less the
    projection's 2*T*C*inner per window. It reads x and g and writes g_x and the weight
    gradients. In bf16 the backward computes in fp32 (the JAX body upcasts), at the fp32
    rate, on 2-byte x, g and g_x. ``int_ops``: the dropout form's hash work, added to the
    operations. ``window``: (wh, ww) of T = wh * ww tokens."""
    inner = heads * d
    t = window[0] * window[1]
    windows = 2 * batch * (h // window[0]) * (w // window[1])
    flops = windows * (8 * t * c * inner + 4 * t * t * inner)
    maps, weights = 2 * 2 * batch * h * w * c, 2 * (4 * c * inner + 3 * inner + c + t * t)
    act = 2 if dtype == BF16 else 4  # bytes of an x, g, g_x or output element
    if backward:
        return _bound(3 * flops - windows * 2 * t * c * inner, act * 3 * maps // 2 + 8 * weights,
                      int_ops=int_ops)
    if dtype == BF16:
        return _bound(flops, 2 * maps + 4 * weights, PEAK_BF16_FLOPS, int_ops=int_ops)
    return _bound(flops, 4 * (maps + weights), int_ops=int_ops)


def block_bound_ms(h, w, c, heads, d, hidden, batch=1, backward=False, dtype=torch.float32,
                   layout="image", int_ops=0):
    """Least time for one K1/K4 launch: the block's matmul FLOPs (q/k/v, scores, AV,
    proj, fc1, fc2) over the peak for their operands vs x read once, the output written
    once and the weights read once over HBM bandwidth (both streams). In bf16, x and the
    output are 2 bytes an element; K4 (image) takes bf16 operands, at the dense bf16
    tensor-core rate, while K1 (windows) computes in fp32 inside, at the fp32 rate. The
    backward as K3's: the forward recomputed but for its last matmul, fc2, plus every
    matmul's input- and weight-gradient products, so three times the forward's FLOPs
    less fc2's 2*T*C*hidden per window; x and g read, g_x and the weight gradients
    written; in bf16 at the fp32 rate (the JAX bodies upcast) on 2-byte x, g and g_x.
    ``int_ops``: the dropout form's hash work, added to the operations."""
    inner = heads * d
    windows = 2 * batch * (h // WINDOW[0]) * (w // WINDOW[1])
    flops = windows * (8 * T * c * inner + 4 * T * T * inner + 4 * T * c * hidden)
    maps = 2 * 2 * batch * h * w * c
    weights = 2 * (4 * c * inner + 3 * inner + 6 * c + T * T + 2 * c * hidden + hidden)
    act = 2 if dtype == BF16 else 4  # bytes of an x, g, g_x or output element
    if backward:
        return _bound(3 * flops - windows * 2 * T * c * hidden, act * 3 * maps // 2 + 8 * weights,
                      int_ops=int_ops)
    if dtype == BF16:
        peak = PEAK_BF16_FLOPS if layout == "image" else PEAK_FP32_FLOPS
        return _bound(flops, 2 * maps + 4 * weights, peak, int_ops=int_ops)
    return _bound(flops, 4 * (maps + weights), int_ops=int_ops)


def repartition_bound_ms(h, w, c, batch=1, dtype=torch.float32):
    """Least time for one K2 launch, forward or backward: both streams' tokens read once
    and written once."""
    return _bound(0, torch.finfo(dtype).bits // 8 * 2 * 2 * batch * h * w * c)


def time_ms(fn, iters, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fns, calls=200, rounds=5):
    """Host microseconds a call of each of ``fns`` takes to return: ``rounds`` rounds in turns
    of ``calls`` calls each with no sync between them (so few launches that the launch queue
    never fills and the host never waits on the card), the median round; the card is
    synchronised before and after each round, outside the clock."""
    per = [[] for _ in fns]
    for fn in fns:
        for _ in range(20):
            fn()
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            per[i].append(1e6 * (time.perf_counter() - t) / calls)
            torch.cuda.synchronize()
    return [float(np.median(v)) for v in per]


def queued_ms(fn, iters, warmup=3, cycles=4_000_000):
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls by CUDA events with the
    launch queue filled ahead: a spin kernel (``torch.cuda._sleep``) holds the stream while
    the host enqueues the calls, so the events time the calls' kernels back to back on the
    card and not the host's launch rate. The spin is doubled until it outlasts the host's
    enqueueing (checked on the host clock against the spin's own event time)."""
    for _ in range(warmup):
        fn()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(6):
        torch.cuda.synchronize()
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t)
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 2
    raise AssertionError(f"the spin kernel never outlasted the host's {iters} calls ({host_ms:.3f} ms)")


def kernel_ms(call, runs=10, kernels=1):
    """Mean device ms of one call of ``call`` that launches ``kernels`` device kernels, by
    torch.profiler over ``runs`` calls; None unless a session recorded exactly ``runs *
    kernels`` device events (a session now and then drops some: five tries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(events) == runs * kernels:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / runs
    return None


# CUgraphNodeType values of the driver API (cuda.h)
_GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph", 5: "empty",
                     6: "event wait", 7: "event record"}


def graph_operations(call):
    """The type of every operation that one call of ``call`` puts on its stream (kernel,
    memcpy, memset, ...), read from a CUDA graph captured from the call through the driver's
    ``cuGraphGetNodes`` and ``cuGraphNodeGetType``: every launch and copy is a node of the
    graph, so the count does not depend on the profiler."""
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        call()
    driver = ctypes.CDLL("libcuda.so.1")
    driver.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    driver.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    rc = driver.cuGraphGetNodes(handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    rc = rc or driver.cuGraphGetNodes(handle, nodes, ctypes.byref(count))
    types = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        rc = rc or driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        types.append(_GRAPH_NODE_TYPES.get(kind.value, f"node type {kind.value}"))
    if rc:
        raise RuntimeError(f"reading a captured CUDA graph's nodes failed: CUresult {rc}")
    del graph
    return types


def device_kernels(call, runs=3):
    """The names of every device event (kernels, copies and sets) of one call of ``call``,
    by torch.profiler over ``runs`` calls, or None where it recorded none or a share of
    them (five tries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events and not len(events) % runs:
            return [_kernel_name(e.name) for e in events[:len(events) // runs]]
    return None


def k2_launch_with_context(xw, hw, window, from_shift, to_shift):
    """K2's launch as its wrapper made it before the host-path repair: the device context
    entered and a ``torch.cuda.Stream`` made on every call (the same kernel and result)."""
    from swin_unet_image_fusion_tpu_torch.ops import _build
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    s, b, _, _, c = xw.shape
    out = torch.empty_like(xw)
    lib = twp._library()
    with torch.cuda.device(xw.device):
        rc = lib.swin_repartition_fwd(
            xw.data_ptr(), out.data_ptr(), s * b, hw[0], hw[1], c * xw.element_size(), window[0],
            window[1], int(from_shift), int(to_shift), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, rc, "repartition")
    return out


def token_mask_with_context(a, seed, site, rate, key):
    """The token mask's launch as its wrapper made it before the host-path repair: the
    dropout arguments built anew, the device context entered and a ``torch.cuda.Stream``
    made on every call (the same kernel and result)."""
    from swin_unet_image_fusion_tpu_torch.ops import _build
    from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
    from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
    from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

    s, b, h, w, cols = a.shape
    rates = [rate if x == site else 0.0 for x in hd.SITES]
    args = dl.drop_args(key, rates, seed)
    out = torch.empty_like(a)
    lib = dm._library()
    with torch.cuda.device(a.device):
        rc = lib.swin_dropout_tokens(a.data_ptr(), out.data_ptr(), dl.drop_pointer(args),
                                     hd.SITES.index(site), s, b, h * w, cols,
                                     int(a.dtype == BF16), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, rc, "token dropout mask")
    return out


def token_mask_first_form(a, seed, site, rate, key):
    """The token mask through its kernel's first form (a thread an element, the row's unit
    hashed again for every column; uncounted): the same result, kept for the timings in
    turns."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm

    return dm._token_launch(dm._library().swin_dropout_tokens_elementwise, a.contiguous(), seed, site,
                            rate, key)


def tag(dtype) -> str:
    return " bf16" if dtype == BF16 else ""


def compare_kernel(out, ref, what):
    """A kernel's output against its plain version's on the same inputs: fp32 within atol
    and rtol 1e-4; bf16 within rtol 2^-7 and atol 2^-6 x the largest magnitude, with at
    most 10% of the elements different. Returns (max_abs_err, share of elements that
    differ)."""
    o, r = out.float(), ref.float()
    err, share = (o - r).abs().max().item(), (o != r).float().mean().item()
    print(f"{what}: max_abs_err {err:.3e}, {share:.3%} of the elements differ", flush=True)
    if out.dtype != ref.dtype:
        raise AssertionError(f"{what}: the kernel returned {out.dtype}, its plain version {ref.dtype}")
    if out.dtype == BF16:
        torch.testing.assert_close(o, r, rtol=BF16_RTOL, atol=BF16_ATOL * r.abs().max().item())
        if share > BF16_MAX_MISMATCH:
            raise AssertionError(f"{what}: {share:.2%} of the elements differ")
    else:
        torch.testing.assert_close(out, ref, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    return err, share


def check_attention_kernel(cfg, device, dtype=torch.float32):
    """K3 against its plain version in all 20 stage x variant cases."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    worst = worst_share = 0.0
    for k, h, w, c, heads, d in stage_geometries(cfg):
        for shift in (False, True):
            for cross in (False, True):
                x, *weights = attention_inputs(h, w, c, heads, d, SEED + k, device)
                args = (x.to(dtype), *weights)
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d,
                          shift=shift, cross=cross)
                out = twa.window_attention(*args, **kw)
                again = twa.window_attention(*args, **kw)
                torch.cuda.synchronize()
                ref = twa.window_attention_plain(*args, **kw)
                what = f"[k3{tag(dtype)}] stage {k} {h}x{w} C={c} d={d} shift={shift} cross={cross}"
                err, share = compare_kernel(out, ref, what)
                if not torch.equal(out, again):
                    raise AssertionError(f"{what}: a repeat gave other bits")
                worst, worst_share = max(worst, err), max(worst_share, share)
    print(f"[check] K3{tag(dtype)}: worst max_abs_err {worst:.3e}, at most {worst_share:.3%} of "
          f"the elements differ, over 20 cases, each repeated bit for bit", flush=True)
    return worst


def block_cases(cfg, device, packed_only, hw=SERVE_HW, batch=1, stages=None):
    """Every (stage, role, shift, cross) block of an ``hw`` input of ``batch`` images with
    its inputs; ``packed_only`` keeps the stages that cuda_pack packs, ``stages`` (where
    given) those stages alone."""
    from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_beneficial

    for k, h, w, c, heads, d in stage_geometries(cfg, hw):
        if (packed_only and not pack_beneficial(c, w)) or (stages is not None and k not in stages):
            continue
        for r, (role, hidden) in enumerate(mlp_hiddens(cfg, k)):
            x, *weights = block_inputs(h, w, c, heads, d, hidden, SEED + 10 * k + r, device, batch)
            for shift in (False, True):
                for cross in (False, True):
                    yield (k, h, w, c, heads, d, role, hidden, shift, cross), x, weights


def fused_args(case, x, layout):
    """x in ``layout`` and the wrapper's keyword arguments for a block case."""
    from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_windows

    k, h, w, c, heads, d, role, hidden, shift, cross = case
    if layout == "windows":
        x = pack_windows(x, WINDOW, shift).contiguous()
    return x, dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift,
                   cross=cross, layout=layout, hw=(h, w))


def check_fused_block(cfg, device, dtype=torch.float32):
    """K1 (windows layout, the packed stages) and K4 (image layout, every stage), both the
    forward of ``csrc/fused_block_fwd.cu``, each case repeated bit for bit, against their
    plain version in every stage x role x shift x cross case of a 512² request."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    worst = {}
    for name, layout, packed_only in (("K1", "windows", True), ("K4", "image", False)):
        key, worst_share = f"{name}{tag(dtype)}", 0.0
        worst[key] = 0.0
        for case, x, weights in block_cases(cfg, device, packed_only):
            xl, kw = fused_args(case, x.to(dtype), layout)
            out = tfb.fused_block(xl, *weights, **kw)
            again = tfb.fused_block(xl, *weights, **kw)
            torch.cuda.synchronize()
            ref = tfb.fused_block_plain(xl, *weights, **kw)
            k, h, w, c, _, d, role, hidden, shift, cross = case
            what = f"[{key.lower()}] stage {k} {role} {h}x{w} C={c} hidden={hidden} shift={shift} cross={cross}"
            err, share = compare_kernel(out, ref, what)
            if not torch.equal(out, again):
                raise AssertionError(f"{what}: a repeat gave other bits")
            worst[key], worst_share = max(worst[key], err), max(worst_share, share)
        print(f"[check] {key}: worst max_abs_err {worst[key]:.3e}, at most {worst_share:.3%} "
              f"of the elements differ, over {32 if packed_only else 40} cases, each repeated bit "
              f"for bit", flush=True)
    return worst


def repartition_cases(cfg, device, hw=SERVE_HW, batch=1, dtype=torch.float32):
    """(stage, h, w, c, from_shift, xw, permutation) at every packed stage map of an
    ``hw`` input of ``batch`` images, both directions; the permutation is the source
    token of each destination slot (for the library call)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    for k, h, w, c, _, _ in stage_geometries(cfg, hw):
        if not twp.pack_beneficial(c, w):
            continue
        x = torch.randn(2, batch, h, w, c, generator=torch.Generator().manual_seed(SEED + k))
        x = x.to(device=device, dtype=dtype)
        for from_shift in (False, True):
            xw = twp.pack_windows(x, WINDOW, from_shift).contiguous()
            ids = torch.arange(h * w, dtype=torch.float32, device=device).reshape(1, 1, -1, T, 1)
            perm = twp.repartition_windows_plain(ids, (h, w), WINDOW, from_shift, not from_shift)
            yield k, h, w, c, from_shift, xw, perm.reshape(-1).long()


def repartition_library(xw, perm):
    """One PyTorch call computing the re-partition: index_select of the token axis."""
    s, b, n, t, c = xw.shape
    return xw.reshape(s * b, n * t, c).index_select(1, perm).reshape(s, b, n, t, c)


def check_repartition(cfg, device, dtype=torch.float32):
    """K2 bit-exact against its plain version (and the library call) at every packed
    stage map of a 512² request, in both directions."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    worst = 0.0
    for k, h, w, c, from_shift, xw, perm in repartition_cases(cfg, device, dtype=dtype):
        out = twp.repartition_windows(xw, (h, w), WINDOW, from_shift, not from_shift)
        torch.cuda.synchronize()
        ref = twp.repartition_windows_plain(xw, (h, w), WINDOW, from_shift, not from_shift)
        err = (out.float() - ref.float()).abs().max().item()
        worst = max(worst, err)
        print(f"[k2{tag(dtype)}] stage {k} {h}x{w} C={c} shift {from_shift} -> {not from_shift}: "
              f"bit-exact {torch.equal(out, ref)}", flush=True)
        if (out.dtype != dtype or not torch.equal(out, ref)
                or not torch.equal(repartition_library(xw, perm), ref)):
            raise AssertionError(f"K2{tag(dtype)} at stage {k} is not bit-exact (max_abs_err {err})")
    if dtype == BF16:
        print("[check] K2 bf16: bit-exact at every packed map, both directions", flush=True)
    return worst


def check_fused(out, shape):
    """A fuse_y output: the input's shape, finite, inside [0, 1]."""
    if out.shape != shape or not np.isfinite(out).all():
        raise AssertionError(f"fuse_y at {shape}: shape {out.shape}, finite {np.isfinite(out).all()}")
    if out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError(f"fuse_y at {shape} left [0, 1]: {out.min()} .. {out.max()}")


def serve(fuser, shape, requests, seed):
    """``requests`` fuse_y calls at ``shape``; returns the last inputs/output."""
    rng = np.random.default_rng(seed)
    for _ in range(requests):
        ir = rng.random((1, *shape, 1), dtype=np.float32)
        vis = rng.random((1, *shape, 1), dtype=np.float32)
        out = fuser.fuse_y(ir, vis)
        check_fused(out, (1, *shape, 1))
    return ir, vis, out


def forward(fuser, ir, vis):
    with torch.inference_mode():
        dev = fuser.device
        return fuser.model(torch.from_numpy(ir).to(dev), torch.from_numpy(vis).to(dev)).cpu().numpy()


# the counters of each form, by the suffix of its kernel name
FORM_COUNTERS = {"": "LAUNCHES", " bf16": "BF16_LAUNCHES", " bwd": "BWD_LAUNCHES",
                 " bwd bf16": "BF16_BWD_LAUNCHES", " drop": "DROP_LAUNCHES",
                 " drop bf16": "BF16_DROP_LAUNCHES", " drop bwd": "DROP_BWD_LAUNCHES",
                 " drop bwd bf16": "BF16_DROP_BWD_LAUNCHES"}
MASK_COUNTERS = {"mask tokens": "TOKEN_LAUNCHES", "mask tokens bwd": "TOKEN_BWD_LAUNCHES",
                 "mask attention": "ATTN_LAUNCHES", "mask attention bwd": "ATTN_BWD_LAUNCHES",
                 "mask tokens bf16": "BF16_TOKEN_LAUNCHES",
                 "mask tokens bwd bf16": "BF16_TOKEN_BWD_LAUNCHES",
                 "mask attention bf16": "BF16_ATTN_LAUNCHES",
                 "mask attention bwd bf16": "BF16_ATTN_BWD_LAUNCHES"}


def _counted():
    """(kernel name prefix, module) of every kernel wrapper with launch counters."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    return (("K3", twa), ("K2", twp), ("fused", tfb))


def reset_counts():
    """Every kernel wrapper's launch count of every form (fp32, bf16, with dropout, forward
    and backward) to 0, and the composition's mask kernels' counts."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm

    for _, m in _counted():
        for counter in FORM_COUNTERS.values():
            if hasattr(m, counter):
                setattr(m, counter, 0)
    for counter in MASK_COUNTERS.values():
        setattr(dm, counter, 0)


def read_mask_counts():
    """Launches of the composition's dropout mask kernels since the reset, forward and on
    a gradient, fp32 and bf16."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm

    return {name: getattr(dm, counter) for name, counter in MASK_COUNTERS.items()}


def read_counts(impl):
    """Launches of every form of every kernel since the reset, by kernel name under
    ``impl`` (K2 has no dropout form)."""
    counts = {}
    for name, m in _counted():
        name = FUSED_NAME[impl] if name == "fused" else name
        counts.update({f"{name}{suffix}": getattr(m, counter)
                       for suffix, counter in FORM_COUNTERS.items() if hasattr(m, counter)})
    return counts


def serve_configs(fusers, plain_fuser, cpu_fuser, dtype=torch.float32, plain32=None):
    """The main paths: every configuration at every served shape, with its launch counts
    (each read right after its own run), checked against the torch composition on the
    card and, at 100x90, against the CPU composition. In bf16 the launches are the bf16
    kernels' (the fp32 ones stay 0), and the outputs are held to the bf16 and the fp32
    compositions on the card (``plain32``) by the image-level criteria of
    ``testing.py``. Returns the launches per kernel."""
    launches = {}
    cpu_out = {}
    for impl, shapes in CONFIGS.items():
        fuser = fusers[impl]
        for shape, per_request in shapes.items():
            reset_counts()
            ir, vis, out = serve(fuser, shape, REQUESTS, seed=SEED + shape[1])
            got = read_counts(impl)
            expected = {name: 0 for name in got}
            expected.update({f"{name}{tag(dtype)}": n * REQUESTS for name, n in per_request.items()})
            print(f"[serve]{tag(dtype)} {impl} {shape}: {REQUESTS} requests, launches {got}", flush=True)
            if got != expected:
                raise AssertionError(f"{impl}{tag(dtype)} at {shape}: launches {got}, expected {expected}")
            for name, n in got.items():
                if MAIN_PATH.get(name) == impl and name.endswith(" bf16") == (dtype == BF16):
                    launches[name] = launches.get(name, 0) + n
            if dtype == BF16:
                check_bf16_fidelity(impl, shape, out, plain_fuser.fuse_y(ir, vis), plain32.fuse_y(ir, vis))
                continue
            plain_out = plain_fuser.fuse_y(ir, vis)
            raw, plain_raw = forward(fuser, ir, vis), forward(plain_fuser, ir, vis)
            print(f"[parity] {impl} {shape}: kernels vs torch composition on the card, fuse_y "
                  f"max_abs_err {np.abs(out - plain_out).max():.3e}, unclamped "
                  f"{np.abs(raw - plain_raw).max():.3e}", flush=True)
            np.testing.assert_allclose(out, plain_out, atol=MODEL_ATOL, rtol=MODEL_RTOL)
            np.testing.assert_allclose(raw, plain_raw, atol=MODEL_ATOL, rtol=MODEL_RTOL)
            if shape == (100, 90):
                if shape not in cpu_out:
                    cpu_out[shape] = cpu_fuser.fuse_y(ir, vis)
                print(f"[parity] {impl} {shape}: card vs CPU composition max_abs_err "
                      f"{float(np.abs(out - cpu_out[shape]).max()):.3e}", flush=True)
                np.testing.assert_allclose(out, cpu_out[shape], atol=MODEL_ATOL, rtol=MODEL_RTOL)
    return launches


def check_bf16_fidelity(impl, shape, out, plain16_out, plain32_out):
    """A bf16 request against the bf16 and the fp32 torch compositions on the card, by the
    image-level criteria of ``testing.py`` (never a largest difference: rounding flips
    amplify through the stages)."""
    from swin_unet_image_fusion_tpu_torch.testing import assert_bf16_fidelity, image_fidelity

    for ref, ref_dtype in ((plain16_out, "bfloat16"), (plain32_out, "float32")):
        f = image_fidelity(out, ref)
        print(f"[parity] bf16 {impl} {shape}: vs the {ref_dtype} torch composition on the card: "
              f"mean_abs {f.mean_abs:.3e}, max_abs {f.max_abs:.3e}, PSNR {f.psnr:.2f} dB, "
              f"SSIM {f.ssim:.5f}, {f.interior:.1%} of the reference inside (0, 1)", flush=True)
        assert_bf16_fidelity(out, ref, ref_dtype, f"bf16 {impl} {shape}")


def time_attention(cfg, device, card, dtype=torch.float32):
    """K3 per call at every stage x variant: the forward without dropout
    (``csrc/window_attention_fwd.cu``, one or two kernels) in turns with the three launches
    it replaced (``_launch_three``: new, three, three, new); per-request sums weight each by
    its 2 calls (encoder and decoder)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    name = f"K3{tag(dtype)}"
    totals = dict(ms=0.0, three_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    by = {}
    for k, h, w, c, heads, d in stage_geometries(cfg):
        x, *weights = attention_inputs(h, w, c, heads, d, SEED + k, device)
        args = (x.to(dtype), *weights)
        bound, bound_by = attention_bound_ms(h, w, c, heads, d, dtype=dtype)
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift,
                          cross=cross, attn_drop_rate=0.0, drop_seed=None)
                forms = {"new": lambda: twa.window_attention(*args, **kw),
                         "three": lambda: twa._launch_three(args[0], args[1:], kw)}
                runs = {form: [] for form in forms}
                for form in ("new", "three", "three", "new"):
                    runs[form].append(time_ms(forms[form], iters=20))
                ms, three = (sum(runs[f]) / 2 for f in ("new", "three"))
                plain = time_ms(lambda: twa.window_attention_plain(*args, **kw), iters=5)
                print(f"[time] {name} stage {k} {h}x{w} C={c} shift={shift} cross={cross}: "
                      f"{ms:.4f} ms ({runs['new'][0]:.4f}, {runs['new'][1]:.4f}), three launches "
                      f"{three:.4f} ms in turns, plain {plain:.4f} ms, bound {bound:.4f} ms "
                      f"({bound_by}) | {card}", flush=True)
                for key, v in (("ms", ms), ("three_ms", three), ("plain_ms", plain), ("bound_ms", bound)):
                    totals[key] += 2 * v
                by[bound_by] = by.get(bound_by, 0.0) + 2 * bound
    print(f"[time] {name} per 512x512 request under cuda (40 calls): {totals['ms']:.3f} ms "
          f"({totals['bound_ms'] / totals['ms']:.1%} of the bound), the three launches in turns "
          f"{totals['three_ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.4f} ms | {card}", flush=True)
    return dict(totals, bound_by=max(by, key=by.get), library_ms=None)


def time_fused_block(cfg, device, card, dtype=torch.float32):
    """K1 (packed stages, windows layout) and K4 (every stage, image layout) per call at
    every stage x role x shift x cross block of a 512² request; each block runs once per
    request, so the per-request sums add them all. Each forward (``csrc/fused_block_fwd.cu``)
    is timed in turns with the five launches of ``csrc/fused_block.cu`` that it replaced
    (new, five, five, new)."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    results = {}
    for name, layout, packed_only in (("K1", "windows", True), ("K4", "image", False)):
        name = f"{name}{tag(dtype)}"
        totals = dict(ms=0.0, five_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        by = {}
        for case, x, weights in block_cases(cfg, device, packed_only):
            xl, kw = fused_args(case, x.to(dtype), layout)
            k, h, w, c, heads, d, role, hidden, shift, cross = case
            bound, bound_by = block_bound_ms(h, w, c, heads, d, hidden, dtype=dtype, layout=layout)
            five_kw = dict(kw, drop_rates=(0.0, 0.0, 0.0), drop_seed=None)
            # the redesigned forward in turns with the five launches
            runs = {"new": [], "five": []}
            forms = {"new": lambda: tfb.fused_block(xl, *weights, **kw),
                     "five": lambda: tfb._launch_five(xl, weights, five_kw)}
            for form in ("new", "five", "five", "new"):
                runs[form].append(time_ms(forms[form], iters=20))
            ms, five = (sum(runs[f]) / 2 for f in ("new", "five"))
            turns = (f" ({runs['new'][0]:.4f}, {runs['new'][1]:.4f}), five launches {five:.4f} "
                     f"ms in turns")
            totals["five_ms"] += five
            plain = time_ms(lambda: tfb.fused_block_plain(xl, *weights, **kw), iters=3, warmup=1)
            print(f"[time] {name} stage {k} {role} {h}x{w} C={c} hidden={hidden} shift={shift} "
                  f"cross={cross}: {ms:.4f} ms{turns}, plain {plain:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by}) | {card}", flush=True)
            for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
                totals[key] += v
            by[bound_by] = by.get(bound_by, 0.0) + bound
        n = 32 if packed_only else 40
        print(f"[time] {name} per 512x512 request ({n} calls): {totals['ms']:.3f} ms "
              f"({totals['bound_ms'] / totals['ms']:.1%} of the bound), the five launches in turns "
              f"{totals['five_ms']:.3f} ms, plain "
              f"{totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.4f} ms | {card}", flush=True)
        results[name] = dict(totals, bound_by=max(by, key=by.get), library_ms=None)
    return results


def device_ms(fn, iters):
    """Mean device time of ``fn`` per call over ``iters`` calls, by torch.profiler (the
    kernels' own time, which the host's enqueue rate does not enter); None where the
    profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / iters if total else None


def _kernel_name(key):
    """The function name of a device kernel's profiler key (no namespace, no arguments)."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split("::")[-1] \
        .replace("void ", "").strip()


def _profile_call(call, runs):
    """The device kernels of ``runs`` calls of ``call`` under torch.profiler: {position in the
    call:function name: mean ms per call}, or None where the profiler recorded no whole calls
    (a session now and then drops device events: five tries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                         and "mem" not in e.name.lower()), key=lambda e: e.time_range.start)
        if events and not len(events) % runs:
            per_call, parts = len(events) // runs, {}
            for i, e in enumerate(events):
                name = f"{i % per_call}:{_kernel_name(e.name)}"
                parts[name] = parts.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / runs
            return parts
    return None


def _add_parts(into, parts, times=1):
    for name, ms in parts.items():
        into[name] = into.get(name, 0.0) + times * ms


def k3_split(cfg, device, card, launch, label, dtype=torch.float32, runs=5):
    """K3's device time per 512² request by stage and by kernel, from torch.profiler:
    ``launch(x, weights, kw)`` ``runs`` times at each stage's four variants (each runs twice
    per request, encoder and decoder), every kernel of a call named by its position in the
    call and its function (the three-launch form's two GEMMs share a name). Returns
    {stage: {kernel: ms per request}}."""
    split = {}
    for k, h, w, c, heads, d in stage_geometries(cfg):
        x, *weights = attention_inputs(h, w, c, heads, d, SEED + k, device)
        x = x.to(dtype)
        parts = {}
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift,
                          cross=cross, attn_drop_rate=0.0, drop_seed=None)
                got = _profile_call(lambda: launch(x, weights, kw), runs)
                if got is None:
                    print(f"[split] {label}: the profiler recorded no whole calls: not measured | {card}")
                    return None
                _add_parts(parts, got, 2)
        split[k] = parts
        print(f"[split] {label} stage {k} {h}x{w} C={c} d={d}, per 512x512 request (8 calls): "
              + ", ".join(f"{n} {ms:.4f} ms" for n, ms in parts.items())
              + f", total {sum(parts.values()):.4f} ms | {card}", flush=True)
    return split


def _block_split_forms(cfg, device, card, label, layout, packed_only, dtype, runs):
    """{form: {stage: {kernel: ms per request}}} of ``block_split`` for one layout, or None
    where the profiler recorded no whole calls of a form."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    split = {"redesigned": {}, "five launches": {}}
    for i, (case, x, weights) in enumerate(block_cases(cfg, device, packed_only)):
        xl, kw = fused_args(case, x.to(dtype), layout)
        five_kw = dict(kw, drop_rates=(0.0, 0.0, 0.0), drop_seed=None)
        forms = {"redesigned": lambda: tfb._launch_fwd(xl, weights, kw),
                 "five launches": lambda: tfb._launch_five(xl, weights, five_kw)}
        for form in (forms if i % 2 == 0 else reversed(forms)):
            got = _profile_call(forms[form], runs)
            if got is None:
                print(f"[split] {label} {form}: the profiler recorded no whole calls: not measured | {card}")
                return None
            _add_parts(split[form].setdefault(case[0], {}), got)
    return split


def block_split(cfg, device, card, dtype=torch.float32, runs=5):
    """K1's and K4's device time per 512² request by stage and by kernel, from
    torch.profiler: at each block of a request (stage x role x shift x cross, each once per
    request: K1's 32 at the packed stages in the windows layout, K4's 40 in the image
    layout) the redesigned forward (``csrc/fused_block_fwd.cu``) and the five launches of
    ``csrc/fused_block.cu``, in turns (the redesigned one first at every other block)."""
    for name, layout, packed_only in (("K1", "windows", True), ("K4", "image", False)):
        label = f"{name}{tag(dtype)}"
        split = _block_split_forms(cfg, device, card, label, layout, packed_only, dtype, runs)
        if split is None:
            continue
        for k, h, w, c, heads, d in stage_geometries(cfg):
            for form, stages in split.items():
                if k not in stages:
                    continue
                parts = stages[k]
                print(f"[split] {label} {form} stage {k} {h}x{w} C={c}, per 512x512 request (8 calls): "
                      + ", ".join(f"{n} {ms:.4f} ms" for n, ms in parts.items())
                      + f", total {sum(parts.values()):.4f} ms | {card}", flush=True)
        totals = {form: sum(sum(p.values()) for p in stages.values()) for form, stages in split.items()}
        print(f"[split] {label} per 512x512 request ({32 if packed_only else 40} calls): redesigned "
              f"{totals['redesigned']:.4f} ms of device time, the five launches "
              f"{totals['five launches']:.4f} ms | {card}", flush=True)


def _profile_kernels(call, runs):
    """{kernel function name: mean device ms per call} of ``runs`` calls of ``call`` under
    torch.profiler, summed by name over the session's kernels (``key_averages``: a kernel's
    records are not ordered within a call), or None where the profiler recorded no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    for _ in range(5):  # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total and "mem" not in e.key.lower():
                name = _kernel_name(e.key)
                parts[name] = parts.get(name, 0.0) + e.self_device_time_total / 1e3 / runs
        if parts:
            return parts
    return None


def block_bwd_split(cfg, device, card, runs=2):
    """K1 bwd's and K4 bwd's device time per 224² batch-20 step by stage and by kernel, from
    torch.profiler (:func:`_profile_kernels`), and by CUDA events: at each of the step's 32
    blocks (stage 0-3 x role x shift x cross) the redesigned backward (``_launch_bwd``:
    ``csrc/fused_block_bwd.cu`` at stages 0-1, ``csrc/fused_block_bwd_split.cu`` at 2-3) and
    the five-launch backward of ``csrc/fused_block.cu`` (``_launch_bwd_five``), in turns (the
    redesigned one first at every other block); per stage, then the split route's stages 2-3
    and the step. Then the same at the 8 stage-4 blocks of a 448² batch-5 step (the split
    route at C = 384; key 4 of the stage sums)."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    for name, layout in (("K1 bwd", "windows"), ("K4 bwd", "image")):
        split = {"redesigned": {}, "five-launch": {}}
        events = {"redesigned": {}, "five-launch": {}}  # ms per stage by CUDA events
        cases = itertools.chain(block_cases(cfg, device, True, TRAIN_HW, TRAIN_BATCH),
                                block_cases(cfg, device, False, TRAIN448_HW, TRAIN448_BATCH, stages=(4,)))
        for i, (case, x, weights) in enumerate(cases):
            xl, kw = fused_args(case, x, layout)
            g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(case[0])).to(device)
            forms = {"redesigned": lambda: tfb._launch_bwd(g, xl, weights, kw),
                     "five-launch": lambda: tfb._launch_bwd_five(g, xl, weights, kw)}
            for form in (forms if i % 2 == 0 else reversed(forms)):
                ms = time_ms(forms[form], iters=runs, warmup=1)
                events[form][case[0]] = events[form].get(case[0], 0.0) + ms
                got = _profile_kernels(forms[form], runs)
                if got is None:
                    print(f"[split] {name} {form}: the profiler recorded no whole calls: not measured | {card}")
                    split = None
                    break
                _add_parts(split[form].setdefault(case[0], {}), got)
            if split is None:
                break
            del g
        if split is None:
            continue
        for form, stages in split.items():
            parts = stages[4]
            print(f"[split] {name} {form} stage 4 of 448x448 14x14x{TRAIN448_BATCH} C=384, per step (8 calls): "
                  + ", ".join(f"{n} {ms:.4f} ms" for n, ms in parts.items())
                  + f", total {sum(parts.values()):.4f} ms of device time, {events[form][4]:.4f} ms "
                  f"by events | {card}", flush=True)
        s4 = {form: (sum(stages.pop(4).values()), per.pop(4)) for (form, stages), per in
              zip(split.items(), events.values())}
        print(f"[split] {name} stage 4 of a 448x448 batch-{TRAIN448_BATCH} step (8 calls): redesigned "
              f"{s4['redesigned'][0]:.4f} ms of device time ({s4['redesigned'][1]:.4f} by events), twenty "
              f"launches {s4['five-launch'][0]:.4f} ms ({s4['five-launch'][1]:.4f}) | {card}", flush=True)
        for k, h, w, c, heads, d in stage_geometries(cfg, TRAIN_HW):
            for form, stages in split.items():
                if k not in stages:
                    continue
                parts = stages[k]
                print(f"[split] {name} {form} stage {k} {h}x{w}x{TRAIN_BATCH} C={c}, per step (8 calls): "
                      + ", ".join(f"{n} {ms:.4f} ms" for n, ms in parts.items())
                      + f", total {sum(parts.values()):.4f} ms of device time, {events[form][k]:.4f} ms "
                      f"by events | {card}", flush=True)
        split_stages = {form: sum(sum(p.values()) for k, p in stages.items() if k in (2, 3))
                        for form, stages in split.items()}
        split_events = {form: sum(ms for k, ms in per.items() if k in (2, 3)) for form, per in events.items()}
        print(f"[split] {name} stages 2-3 (the split route, 16 calls) per step: redesigned "
              f"{split_stages['redesigned']:.4f} ms of device time ({split_events['redesigned']:.4f} by events), "
              f"five-launch {split_stages['five-launch']:.4f} ms ({split_events['five-launch']:.4f}) | {card}",
              flush=True)
        totals = {form: sum(sum(p.values()) for p in stages.values()) for form, stages in split.items()}
        by_events = {form: sum(per.values()) for form, per in events.items()}
        print(f"[split] {name} per {TRAIN_HW[0]}x{TRAIN_HW[1]} batch-{TRAIN_BATCH} step ({i - 7} calls): "
              f"redesigned {totals['redesigned']:.4f} ms of device time ({by_events['redesigned']:.4f} by "
              f"events), five-launch {totals['five-launch']:.4f} ms ({by_events['five-launch']:.4f}) | {card}",
              flush=True)
        torch.cuda.empty_cache()


def _repartition_device_ms(calls):
    """The device time of one request's or step's re-partitions by torch.profiler, the
    kernel's and the library call's (index_select), each "not measured" where the profiler
    recorded none; ``calls``: (launches per request or step, kernel call, library call)."""
    return tuple("not measured" if v is None else f"{v:.4f} ms" for v in (
        device_ms(lambda: [call[i]() for call in calls for _ in range(call[0])], iters=5)
        for i in (1, 2)))


def time_repartition(cfg, device, card):
    """K2 per launch at every packed stage map, both directions, fp32 and bf16 in turns at
    each map (fp32, bf16, bf16, fp32), so that a drift of the host's speed falls on both
    alike. A packed stage re-partitions normal -> shift twice and shift -> normal once per
    role (encoder and decoder), so a request runs each normal -> shift launch 4 times and
    each shift -> normal launch twice. A launch takes a few µs on the device, so the
    CUDA-event time of back-to-back launches reads the host's enqueue rate; the profiler's
    device time of one request's 24 launches stands beside it."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    dtypes = (torch.float32, BF16)
    totals = {dt: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0) for dt in dtypes}
    request = {dt: [] for dt in dtypes}  # (launches per request, launch) of one request
    for pair in zip(*(repartition_cases(cfg, device, dtype=dt) for dt in dtypes)):
        k, h, w, c, from_shift, _, _ = pair[0]
        per_request = 2 if from_shift else 4
        launch = {dt: functools.partial(twp.repartition_windows, case[5], (h, w), WINDOW,
                                        from_shift, not from_shift)
                  for dt, case in zip(dtypes, pair)}
        events = {dt: [] for dt in dtypes}
        for dt in (*dtypes, *reversed(dtypes)):
            events[dt].append(time_ms(launch[dt], iters=50))
        for dt, (*_, xw, perm) in zip(dtypes, pair):
            ms = sum(events[dt]) / len(events[dt])
            plain = time_ms(lambda: twp.repartition_windows_plain(xw, (h, w), WINDOW, from_shift,
                                                                  not from_shift), iters=20)
            library = time_ms(lambda: repartition_library(xw, perm), iters=50)
            bound, _ = repartition_bound_ms(h, w, c, dtype=dt)
            print(f"[time] K2{tag(dt)} stage {k} {h}x{w} C={c} shift {from_shift} -> "
                  f"{not from_shift}: {ms:.4f} ms ({events[dt][0]:.4f}, {events[dt][1]:.4f} in "
                  f"turns with the other dtype), plain {plain:.4f} ms, index_select {library:.4f} "
                  f"ms, bound {bound:.4f} ms (bytes) | {card}", flush=True)
            for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                           ("library_ms", library)):
                totals[dt][key] += per_request * v
            request[dt].append((per_request, launch[dt],
                                functools.partial(repartition_library, xw, perm)))
    # the host path of one launch: the wrapper, its launcher with and without the device
    # context and the Stream object made per call, and the library call
    for dt, (k, h, w, c, from_shift, xw, perm) in zip(dtypes, (next(repartition_cases(cfg, device, dtype=dt))
                                                          for dt in dtypes)):
        args = ((h, w), WINDOW, from_shift, not from_shift)
        wrapper, launch, old, library = host_us((
            lambda: twp.repartition_windows(xw, *args), lambda: twp._launch(xw, *args),
            lambda: k2_launch_with_context(xw, *args), lambda: repartition_library(xw, perm)))
        print(f"[host] K2{tag(dt)} stage {k} {h}x{w} C={c}: {wrapper:.2f} us a call of "
              f"repartition_windows, its launch {launch:.2f} us (with the device context and a "
              f"Stream per call, as before: {old:.2f} us), index_select {library:.2f} us; medians of 5 "
              f"rounds in turns of 200 calls each, no sync | {card}", flush=True)
    results = {}
    for dt in dtypes:
        name, t = f"K2{tag(dt)}", totals[dt]
        dev, lib_dev = _repartition_device_ms(request[dt])
        print(f"[time] {name} per 512x512 request under cuda_pack (24 launches): {t['ms']:.3f} ms "
              f"by events, {dev} of device time (profiler), plain {t['plain_ms']:.3f} ms, "
              f"index_select {t['library_ms']:.3f} ms by events, {lib_dev} of device time "
              f"(profiler), bound {t['bound_ms']:.4f} ms | {card}", flush=True)
        results[name] = dict(t, bound_by="bytes")
    return results


def time_kernels(cfg, device, card, dtype=torch.float32):
    """K3, K1 and K4's times per 512² request in ``dtype``, by kernel name."""
    return {f"K3{tag(dtype)}": time_attention(cfg, device, card, dtype),
            **time_fused_block(cfg, device, card, dtype)}


def in_turns(served, ir, vis, rounds):
    """``rounds`` fuse_y calls per fuser, the fusers taking turns, so that a change in the
    host's speed during the run falls on all of them alike: each fuser's wall times (ms)
    and peak device memory (MiB)."""
    walls = {name: [] for name in served}
    peaks = dict.fromkeys(served, 0.0)
    for _ in range(rounds):
        for name, f in served.items():
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            f.fuse_y(ir, vis)
            walls[name].append(1e3 * (time.perf_counter() - t))
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated() / 2**20)
    return walls, peaks


def latency(served, card):
    """Per-pair latency of fuse_y at 512² bs=1 after one warm-up call each, the fusers in
    turns. Returns the medians and the inputs."""
    rng = np.random.default_rng(SEED)
    ir = rng.random((1, *SERVE_HW, 1), dtype=np.float32)
    vis = rng.random((1, *SERVE_HW, 1), dtype=np.float32)
    for f in served.values():
        f.fuse_y(ir, vis)
    walls, peaks = in_turns(served, ir, vis, LATENCY_SAMPLES)
    median_ms = {name: float(np.median(w)) for name, w in walls.items()}
    for name, w in walls.items():
        print(f"[latency] fuse_y 512x512 bs=1 ({name}), {LATENCY_SAMPLES} requests in turns: "
              f"median {median_ms[name]:.2f} ms/pair, min {min(w):.2f}, max {max(w):.2f}, "
              f"peak memory {peaks[name]:.0f} MiB | {card}", flush=True)
    return median_ms, ir, vis


def throughput(served, card):
    """Pairs per second of fuse_y on 512² batches of THROUGHPUT_BATCH: one checked call
    per fuser, then THROUGHPUT_ROUNDS timed calls each, the fusers in turns; the host
    copies in and out are part of the call, as in serving."""
    rng = np.random.default_rng(SEED + 1)
    shape = (THROUGHPUT_BATCH, *SERVE_HW, 1)
    ir, vis = rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)
    for f in served.values():
        check_fused(f.fuse_y(ir, vis), shape)
    walls, peaks = in_turns(served, ir, vis, THROUGHPUT_ROUNDS)
    for name, w in walls.items():
        median = float(np.median(w))
        print(f"[throughput] fuse_y 512x512 bs={THROUGHPUT_BATCH} ({name}), {THROUGHPUT_ROUNDS} "
              f"calls in turns: {1e3 * THROUGHPUT_BATCH / median:.2f} pairs/s (median {median:.1f} "
              f"ms per call, min {min(w):.1f}, max {max(w):.1f}), peak memory {peaks[name]:.0f} MiB "
              f"| {card}", flush=True)


KERNEL_FAMILIES = (  # (family, substrings of the device kernel's name), first match wins
    ("csrc K3 forward (attention, projection; K1's and K4's split-route attention)",
     ("k3_attention_kernel", "k3_proj_kernel")),
    ("csrc K1/K4 forward (block, LN1/LN2, proj/fc2, fc1)",
     ("k4_fused_kernel", "k4_ln_kernel", "k4_rows_kernel", "k4_fc1")),
    ("csrc K1/K4 backward (fused route: recompute, MLP, attention, LN1; split route: MLP, g_ln + LN1; "
     "fused_block_bwd*.cu; the split route's recompute and attention blocks count as K1/K4 fwd and K3 bwd)",
     ("block_fwd_kernel", "block_mlp_bwd_kernel", "split_mlp_bwd_kernel", "block_bwd_attn_kernel",
      "ln1_bwd_kernel", "gln_ln1_kernel")),
    ("csrc K3 backward (window blocks, g_x; window_attention_bwd.cu)",
     ("k3_bwd_kernel", "gx_kernel", "sum_sides_kernel")),
    ("csrc weight gradients and transposed weights of K1/K4/K3 bwd (window_bwd.cuh)",
     ("wgrad_rows_kernel", "::transposes)")),
    ("csrc GEMMs (q/k/v, proj, LN+fc1+ELU, fc2)", ("swin::gemm_kernel",)),
    ("csrc attention core", ("window_core_kernel",)),
    ("csrc re-partition (K2, and its halo form)", ("repartition_kernel", "repartition_halo_kernel")),
    ("csrc weight-gradient GEMMs (backward)", ("wgrad_kernel",)),
    ("csrc attention core backward", ("window_core_bwd_kernel",)),
    ("csrc LayerNorm fwd/bwd (backward)", ("ln_fwd_kernel", "ln_bwd_kernel")),
    ("csrc partial sums (backward)", ("reduce_chunks_kernel",)),
    ("csrc dropout masks", ("dropout_rows_kernel", "dropout_attn_kernel")),
    ("optimizer and foreach ops", ("multi_tensor",)),
    ("host-device copies", ("Memcpy", "Memset")),
    ("collectives (NCCL)", ("nccl",)),
    ("conv (cuDNN)", ("conv", "cudnn", "fprop", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "Kernel2")),
    ("reductions (LayerNorm statistics)", ("reduce",)),
    ("gathers (pads, rolls, partitions)", ("index", "roll", "gather", "copy", "cat")),
)


def trace(what, label, fn, wall_ms, card):
    """``fn`` once under torch.profiler (after one call outside it); device time by
    kernel family, the busiest kernels, and the device's idle share of ``wall_ms``. Returns
    (launches, device ms) of each device kernel by name (empty where the profiler recorded
    none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if total_ms == 0.0:
        print(f"[trace] {label}: the profiler recorded no device time: breakdown not measured | {card}")
        return {}
    families = {}
    for e in kernels:
        name = e.key.lower()
        family = next((f for f, keys in KERNEL_FAMILIES if any(k.lower() in name for k in keys)),
                      "other elementwise")
        ms, count = families.get(family, (0.0, 0))
        families[family] = (ms + e.self_device_time_total / 1e3, count + e.count)
    print(f"[trace] {what}: {sum(e.count for e in kernels)} device "
          f"kernels and copies, {total_ms:.3f} ms busy; idle share of the {wall_ms:.2f} ms "
          f"median {1 - total_ms / wall_ms:.3f} | {card}", flush=True)
    for family, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"[trace]   {label} {family}: {ms:.3f} ms in {count} launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[trace]   {label} top: {e.self_device_time_total / 1e3:.3f} ms x{e.count} "
              f"{e.key[:100]}", flush=True)
    return {e.key: (e.count, e.self_device_time_total / 1e3) for e in kernels}


def trace_request(impl, fuser, ir, vis, wall_ms, card):
    """One request's device time by kernel family (see :func:`trace`)."""
    trace(f"fuse_y 512x512 bs=1 ({impl})", impl, lambda: fuser.fuse_y(ir, vis), wall_ms, card)


# ---- the training path: one train step of the full model at 224x224, batch 20 ----------
# attention_impl -> kernel launches per train step at 224², forward and backward (stage 4
# is a 7x7 map: the composition under every configuration)
TRAIN_CONFIGS = {
    "cuda_pack": {"K1": 32, "K1 bwd": 32, "K2": 24, "K2 bwd": 24},
    "cuda": {"K3": 32, "K3 bwd": 32},
    "cuda_block": {"K4": 32, "K4 bwd": 32},
}
TRAIN_MAIN_PATH = {"K3 bwd": "cuda", "K1 bwd": "cuda_pack", "K2 bwd": "cuda_pack",
                   "K4 bwd": "cuda_block"}


def train_block_backward(cfg, device, card):
    """K1 bwd (windows layout) and K4 bwd (image layout) against autograd of their plain
    version in every stage 0-3 x role x shift x cross block of a 224² batch-20 step, each
    repeated bit for bit on the route ``block_bwd_plan`` names ("fused" at stages 0-1, "split"
    at 2-3), with their times; each block runs once per step. Then the same at the 8 stage-4
    blocks of a 448² batch-5 step (C = 384, the split route at pitch 48), each also timed in
    turns with the twenty launches of ``csrc/fused_block.cu`` (``_launch_bwd_five``), which no
    step runs any more."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    results = {}
    for name, layout in (("K1", "windows"), ("K4", "image")):
        totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        by, worst, worst_own, smallest = {}, 0.0, 0.0, 1.0
        for case, x, weights in block_cases(cfg, device, True, TRAIN_HW, TRAIN_BATCH):
            xl, kw = fused_args(case, x, layout)
            k, h, w, c, heads, d, role, hidden, shift, cross = case
            route = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross).route
            if route != ("fused" if k < 2 else "split"):
                raise AssertionError(f"{name} bwd stage {k} {role}: the plan routes {route!r}")
            g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(k)).to(device)
            got = tfb._launch_bwd(g, xl, weights, kw)
            again = tfb._launch_bwd(g, xl, weights, kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name} bwd stage {k} {role}: a repeat gave other bits")
            del again
            ref = tfb.fused_block_bwd_plain(g, xl, *weights, **kw)
            check = assert_grads_close(got, ref, ("x", *tfb.WEIGHT_NAMES), f"{name} bwd stage {k} {role}")
            err, smallest = check.worst, min(smallest, check.smallest)
            worst, worst_own = max(worst, err), max(worst_own, check.worst_own)
            del got, ref
            bound, bound_by = block_bound_ms(h, w, c, heads, d, hidden, TRAIN_BATCH, backward=True)
            ms = time_ms(lambda: tfb._launch_bwd(g, xl, weights, kw), iters=5, warmup=1)
            plain = time_ms(lambda: tfb.fused_block_bwd_plain(g, xl, *weights, **kw), iters=2, warmup=1)
            print(f"[time] {name} bwd stage {k} {role} {h}x{w}x{TRAIN_BATCH} C={c} hidden={hidden} ({route}) "
                  f"shift={shift} cross={cross}: max_abs_err {err:.3e}, {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {bound:.4f} ms ({bound_by}) | {card}", flush=True)
            for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
                totals[key] += v
            by[bound_by] = by.get(bound_by, 0.0) + bound
        print(f"[check] {name} bwd: worst max_abs_err {worst:.3e} over 32 cases, "
              f"{worst_own:.3e} of a gradient's own largest; every gradient but bk's (exactly "
              f"0) held to its own scale, the smallest {smallest:.3e} of its call's largest; "
              f"every case repeated bit for bit", flush=True)
        print(f"[time] {name} bwd per 224x224 batch-20 step (32 launches): {totals['ms']:.3f} ms, "
              f"plain {totals['plain_ms']:.3f} ms, bound {totals['bound_ms']:.4f} ms | {card}", flush=True)
        results[f"{name} bwd"] = dict(totals, bound_by=max(by, key=by.get), library_ms=None, worst=worst)
        torch.cuda.empty_cache()
        s4 = dict(ms=0.0, old_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        s4_worst = 0.0
        for case, x, weights in block_cases(cfg, device, False, TRAIN448_HW, TRAIN448_BATCH, stages=(4,)):
            xl, kw = fused_args(case, x, layout)
            k, h, w, c, heads, d, role, hidden, shift, cross = case
            route = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross).route
            what = f"{name} bwd stage 4 of 448x448 {role} shift={shift} cross={cross}"
            if route != "split":
                raise AssertionError(f"{what}: the plan routes {route!r}")
            g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(k + hidden)).to(device)
            got = tfb._launch_bwd(g, xl, weights, kw)
            again = tfb._launch_bwd(g, xl, weights, kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{what}: a repeat gave other bits")
            del again
            ref = tfb.fused_block_bwd_plain(g, xl, *weights, **kw)
            err = assert_grads_close(got, ref, ("x", *tfb.WEIGHT_NAMES), what).worst
            s4_worst = max(s4_worst, err)
            del got, ref
            bound, _ = block_bound_ms(h, w, c, heads, d, hidden, TRAIN448_BATCH, backward=True)
            old, ms = _in_turns(lambda: tfb._launch_bwd_five(g, xl, weights, kw),
                                lambda: tfb._launch_bwd(g, xl, weights, kw), 5, 1)
            plain = time_ms(lambda: tfb.fused_block_bwd_plain(g, xl, *weights, **kw), iters=2, warmup=1)
            print(f"[time] {name} bwd stage 4 of 448x448: {h}x{w}x{TRAIN448_BATCH} C={c} hidden={hidden} ({route}) "
                  f"shift={shift} cross={cross}: max_abs_err {err:.3e}, {ms:.4f} ms, twenty launches {old:.4f} "
                  f"ms (in turns), plain {plain:.4f} ms, bound {bound:.4f} ms | {card}", flush=True)
            for key, v in (("ms", ms), ("old_ms", old), ("plain_ms", plain), ("bound_ms", bound)):
                s4[key] += v
        results[f"{name} bwd"]["worst"] = max(worst, s4_worst)
        print(f"[time] {name} bwd stage 4 per 448x448 batch-{TRAIN448_BATCH} step (8 launches, the split route): "
              f"{s4['ms']:.3f} ms, twenty launches {s4['old_ms']:.3f} ms (in turns), plain {s4['plain_ms']:.3f} ms, "
              f"bound {s4['bound_ms']:.4f} ms; worst max_abs_err {s4_worst:.3e}, every case repeated bit for "
              f"bit | {card}", flush=True)
        torch.cuda.empty_cache()
    return results


def train_attention_backward(cfg, device, card):
    """K3 bwd without dropout (``csrc/window_attention_bwd.cu``) against autograd of its plain
    version at stages 0-3 of a 224² batch-20 step (each shift x cross variant runs twice per
    step: encoder and decoder) and at the C=384 stage 4 of a 448² batch-5 step (14x14) and of a
    512² step (21x21, batch 20; d = 48, the tiled core), each case repeated bit for bit, with its
    times in turns with the three-launch backward of ``csrc/window_attention.cu``
    (``_launch_bwd_three``) and the plain version's."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    totals = dict(ms=0.0, old_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    by, worst, worst_own, smallest = {}, 0.0, 0.0, 1.0
    geometries = [(*geo, TRAIN_HW, TRAIN_BATCH) for geo in stage_geometries(cfg, TRAIN_HW)[:4]]
    geometries.append((*stage_geometries(cfg, TRAIN448_HW)[4], TRAIN448_HW, TRAIN448_BATCH))
    geometries.append((*stage_geometries(cfg, SERVE_HW)[4], SERVE_HW, TRAIN_BATCH))
    s4 = {}  # stage 4 of each map: (new, three-launch) ms per call summed over the 4 variants
    for k, h, w, c, heads, d, hw, batch in geometries:
        args = attention_inputs(h, w, c, heads, d, SEED + k, device, batch)
        g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(k)).to(device)
        bound, bound_by = attention_bound_ms(h, w, c, heads, d, batch, backward=True)
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                route = twa.bwd_plan(c, heads, d, WINDOW, cross, False).route
                what = f"K3 bwd stage {k} of {hw} ({route}) shift={shift} cross={cross}"
                got = twa._launch_bwd(g, args[0], args[1:], kw)
                again = twa._launch_bwd(g, args[0], args[1:], kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what}: a repeat gave other bits")
                del again
                ref = twa.window_attention_bwd_plain(g, *args, **kw)
                names = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
                check = assert_grads_close(got, ref, names, what)
                err, smallest = check.worst, min(smallest, check.smallest)
                worst, worst_own = max(worst, err), max(worst_own, check.worst_own)
                del got, ref
                old, ms = _in_turns(lambda: twa._launch_bwd_three(g, args[0], args[1:], kw),
                                    lambda: twa._launch_bwd(g, args[0], args[1:], kw), 5, 1)
                plain = time_ms(lambda: twa.window_attention_bwd_plain(g, *args, **kw), iters=2, warmup=1)
                print(f"[time] K3 bwd stage {k} of {hw[0]}x{hw[1]}: {h}x{w}x{batch} C={c} ({route}) "
                      f"shift={shift} cross={cross}: max_abs_err {err:.3e}, {ms:.4f} ms, three-launch "
                      f"{old:.4f} ms (in turns), plain {plain:.4f} ms, bound {bound:.4f} ms ({bound_by}) "
                      f"| {card}", flush=True)
                if hw == TRAIN_HW:
                    for key, v in (("ms", ms), ("old_ms", old), ("plain_ms", plain), ("bound_ms", bound)):
                        totals[key] += 2 * v
                    by[bound_by] = by.get(bound_by, 0.0) + 2 * bound
                else:
                    new_sum, old_sum = s4.get(hw, (0.0, 0.0))
                    s4[hw] = (new_sum + ms, old_sum + old)
        if hw != TRAIN_HW:
            new_sum, old_sum = s4[hw]
            print(f"[time] K3 bwd stage 4 of {hw[0]}x{hw[1]} batch {batch} (d = {d}, the tiled core), a call "
                  f"on average over shift x cross: {new_sum / 4:.4f} ms, three-launch {old_sum / 4:.4f} ms (in "
                  f"turns), bound {bound:.4f} ms; per step (8 calls) {2 * new_sum:.4f} ms against "
                  f"{2 * old_sum:.4f} | {card}", flush=True)
        torch.cuda.empty_cache()
    print(f"[check] K3 bwd: worst max_abs_err {worst:.3e} over {4 * len(geometries)} cases, "
          f"{worst_own:.3e} of a gradient's own largest; every gradient but bk's (exactly 0) "
          f"held to its own scale, the smallest {smallest:.3e} of its call's largest; every case "
          f"repeated bit for bit", flush=True)
    print(f"[time] K3 bwd per 224x224 batch-20 step under cuda (32 launches): {totals['ms']:.3f} ms, "
          f"three-launch {totals['old_ms']:.3f} ms (in turns), plain {totals['plain_ms']:.3f} ms, bound "
          f"{totals['bound_ms']:.4f} ms | {card}", flush=True)
    return dict(totals, bound_by=max(by, key=by.get), library_ms=None, worst=worst)


def k3_bwd_split(cfg, device, card, runs=2):
    """K3 bwd's device time per 224² batch-20 step by stage and by kernel, from torch.profiler
    (:func:`_profile_kernels`), and per stage by CUDA events: at each stage 0-3 x shift x cross
    call (each twice a step, encoder and decoder) and at the stage-4 shapes of a 448² batch-5
    step (twice a step) and of a 512² batch-20 step, the new backward (``_launch_bwd``:
    ``csrc/window_attention_bwd.cu``) and the three-launch backward (``_launch_bwd_three``), in
    turns (the new one first at every other call)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    forms = ("new", "three-launch")
    split, events = {f: {} for f in forms}, {f: {} for f in forms}
    geometries = [(*geo, TRAIN_HW, TRAIN_BATCH, 2) for geo in stage_geometries(cfg, TRAIN_HW)[:4]]
    geometries.append((*stage_geometries(cfg, TRAIN448_HW)[4], TRAIN448_HW, TRAIN448_BATCH, 2))
    geometries.append((*stage_geometries(cfg, SERVE_HW)[4], SERVE_HW, TRAIN_BATCH, 1))
    i = 0
    for k, h, w, c, heads, d, hw, batch, times in geometries:
        args = attention_inputs(h, w, c, heads, d, SEED + k, device, batch)
        g = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(k)).to(device)
        key = f"stage {k} of {hw[0]}x{hw[1]}"
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                calls = {"new": lambda: twa._launch_bwd(g, args[0], args[1:], kw),
                         "three-launch": lambda: twa._launch_bwd_three(g, args[0], args[1:], kw)}
                for form in (forms if i % 2 == 0 else reversed(forms)):
                    ms = time_ms(calls[form], iters=runs, warmup=1)
                    events[form][key] = events[form].get(key, 0.0) + times * ms
                    got = _profile_kernels(calls[form], runs)
                    if got is None:
                        print(f"[split] K3 bwd {form}: the profiler recorded no device time: not measured | {card}")
                        return
                    _add_parts(split[form].setdefault(key, {}), got, times)
                i += 1
        del args, g
        torch.cuda.empty_cache()
        for form in forms:
            parts = split[form][key]
            print(f"[split] K3 bwd {form} {key} {h}x{w}x{batch} C={c}, "
                  f"{'per step (8 calls)' if times == 2 else 'per 4 calls (shift x cross)'}: "
                  + ", ".join(f"{n} {ms:.4f} ms" for n, ms in parts.items())
                  + f", total {sum(parts.values()):.4f} ms of device time, {events[form][key]:.4f} ms by "
                  f"events | {card}", flush=True)
    step = {f: [key for key in split[f] if key.endswith(f"{TRAIN_HW[0]}x{TRAIN_HW[1]}")] for f in forms}
    busy = {f: sum(sum(split[f][key].values()) for key in step[f]) for f in forms}
    by_events = {f: sum(events[f][key] for key in step[f]) for f in forms}
    print(f"[split] K3 bwd per {TRAIN_HW[0]}x{TRAIN_HW[1]} batch-{TRAIN_BATCH} step (32 calls): new "
          f"{busy['new']:.4f} ms of device time ({by_events['new']:.4f} by events), three-launch "
          f"{busy['three-launch']:.4f} ms ({by_events['three-launch']:.4f}) | {card}", flush=True)


def train_repartition_backward(cfg, device, card):
    """K2 bwd (the kernel from the other geometry back) bit-exact against the plain
    inverse permutation and the library call at the four packed maps of a 224² batch-20
    step. The backward of a normal -> shift launch is a shift -> normal one: a step runs
    each shift -> normal backward 4 times and each normal -> shift backward twice."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    step = []  # (launches per step, kernel call, library call)
    for k, h, w, c, to_shift, g, perm in repartition_cases(cfg, device, TRAIN_HW, TRAIN_BATCH):
        # g is the gradient of a forward from ``not to_shift`` to ``to_shift``: it lies in
        # the ``to_shift`` geometry and goes back to the other
        fwd = (h, w), WINDOW, not to_shift, to_shift
        got = twp._launch(g, (h, w), WINDOW, to_shift, not to_shift)
        torch.cuda.synchronize()
        ref = twp.repartition_windows_bwd_plain(g, *fwd)
        if not torch.equal(got, ref) or not torch.equal(repartition_library(g, perm), ref):
            raise AssertionError(f"K2 bwd at stage {k} is not bit-exact")
        bound, _ = repartition_bound_ms(h, w, c, TRAIN_BATCH)
        ms = time_ms(lambda: twp._launch(g, (h, w), WINDOW, to_shift, not to_shift), iters=50)
        plain = time_ms(lambda: twp.repartition_windows_bwd_plain(g, *fwd), iters=20)
        library = time_ms(lambda: repartition_library(g, perm), iters=50)
        print(f"[time] K2 bwd stage {k} {h}x{w}x{TRAIN_BATCH} C={c} shift {to_shift} -> "
              f"{not to_shift}: bit-exact, {ms:.4f} ms, plain {plain:.4f} ms, index_select "
              f"{library:.4f} ms, bound {bound:.4f} ms (bytes) | {card}", flush=True)
        per_step = 4 if to_shift else 2
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound), ("library_ms", library)):
            totals[key] += per_step * v
        step.append((per_step, functools.partial(twp._launch, g, (h, w), WINDOW, to_shift, not to_shift),
                     functools.partial(repartition_library, g, perm)))
    print("[check] K2 bwd: bit-exact at every packed map, both directions", flush=True)
    dev, lib_dev = _repartition_device_ms(step)
    print(f"[time] K2 bwd per 224x224 batch-20 step under cuda_pack (24 launches): "
          f"{totals['ms']:.3f} ms by events, {dev} of device time (profiler), plain "
          f"{totals['plain_ms']:.3f} ms, index_select {totals['library_ms']:.3f} ms by events, "
          f"{lib_dev} of device time (profiler), bound {totals['bound_ms']:.4f} ms | {card}", flush=True)
    return dict(totals, bound_by="bytes", worst=0.0)


def state_bytes(state) -> int:
    """Device bytes a train state holds: parameters, buffers, gradients and Adam's
    moments."""
    model = state.model
    tensors = [*model.parameters(), *model.buffers(),
               *(p.grad for p in model.parameters() if p.grad is not None),
               *(t for per in state.optimizer.state.values() for t in per.values()
                 if torch.is_tensor(t))]
    return sum(t.numel() * t.element_size() for t in tensors if t.device.type == "cuda")


def train_configs(flat, device, card):
    """The training main paths: the first step of the full model at 224² batch 20 under
    each kernel configuration with its launch counts (read right after that step),
    checked against the torch composition's first step on the card (loss terms to 1e-5
    relative, every parameter's gradient present, finite and within the gradient
    tolerance); then TRAIN_STEPS timed steps each, in turns, and one profiled step.
    Returns the backward kernels' launches, the states and steps, the inputs, the torch
    composition's first step (terms, gradients) and the median ms per step by
    configuration."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED)
    ir = torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
    vis = torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
    names = ("torch", *TRAIN_CONFIGS)
    states, steps, first = {}, {}, {}
    launches = {}
    for impl in names:
        cfg = Config(model=ModelConfig(attention_impl=impl))
        states[impl] = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
        steps[impl] = make_train_step(cfg)
        torch.cuda.synchronize()
        reset_counts()
        terms = steps[impl](states[impl], ir, vis)
        torch.cuda.synchronize()
        if impl != "torch":
            got = read_counts(impl)
            expected = {name: 0 for name in got}
            expected.update(TRAIN_CONFIGS[impl])
            print(f"[train] {impl} first step: launches {got}", flush=True)
            if got != expected:
                raise AssertionError(f"{impl} train step: launches {got}, expected {expected}")
            for name, n in got.items():
                if TRAIN_MAIN_PATH.get(name) == impl:
                    launches[name] = n
        grads = {}
        for pname, p in states[impl].model.named_parameters():
            if p.grad is None or not torch.isfinite(p.grad).all():
                raise AssertionError(f"{impl}: the gradient of {pname} is missing or not finite")
            grads[pname] = p.grad.detach().clone()
        first[impl] = ({k: float(v) for k, v in terms.items()}, grads)
        print(f"[train] {impl} first step: " + ", ".join(f"{k} {v:.7g}" for k, v in first[impl][0].items())
              + f"; all {len(grads)} parameter gradients present and finite", flush=True)
    ref_terms, ref_grads = first["torch"]
    for impl in TRAIN_CONFIGS:
        terms, grads = first[impl]
        for k, v in terms.items():
            if abs(v - ref_terms[k]) > 1e-5 * abs(ref_terms[k]):
                raise AssertionError(f"{impl} step 1 {k} {v} vs torch composition {ref_terms[k]}")
        check = assert_grads_close([grads[n] for n in ref_grads], list(ref_grads.values()),
                                   list(ref_grads), f"{impl} step 1")
        rel = max(abs(terms[k] - ref_terms[k]) / max(abs(ref_terms[k]), 1e-30) for k in terms)
        held = len(ref_grads) - len(check.zeros) - check.floored
        print(f"[parity] {impl} train step 1 vs torch composition on the card: loss terms max "
              f"relative difference {rel:.3e}, gradients max_abs_err {check.worst:.3e}; of "
              f"{len(ref_grads)} gradients {held} held to their own scale, {check.floored} to "
              f"1e-8 of the largest (the smallest is {check.smallest:.3e} of it; the worst "
              f"error {check.worst_own:.3e} of a gradient's own largest), {len(check.zeros)} "
              f"exactly 0 (key biases, head conv1 bias) to the largest (their rounding noise "
              f"{check.zero_noise:.3e} of it)", flush=True)
    fp32_first = first["torch"]
    del first

    walls = {impl: [] for impl in names}
    peaks = dict.fromkeys(names, 0.0)
    for _ in range(TRAIN_STEPS):
        for impl in names:
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            steps[impl](states[impl], ir, vis)
            torch.cuda.synchronize()
            walls[impl].append(1e3 * (time.perf_counter() - t))
            peaks[impl] = max(peaks[impl], torch.cuda.max_memory_allocated() / 2**20)
    for impl in names:
        w = walls[impl]
        median = float(np.median(w))
        label = "torch composition" if impl == "torch" else impl
        print(f"[train] step 224x224 bs={TRAIN_BATCH} ({label}), {TRAIN_STEPS} steps in turns: "
              f"median {median:.2f} ms/step, min {min(w):.2f}, max {max(w):.2f}, peak memory "
              f"{peaks[impl]:.0f} MiB | {card}", flush=True)
        trace(f"train step 224x224 bs={TRAIN_BATCH} ({label})", f"train {label}",
              lambda: steps[impl](states[impl], ir, vis), median, card)
    medians = {impl: float(np.median(walls[impl])) for impl in names}
    return launches, states, steps, (ir, vis), fp32_first, medians


# attention_impl -> kernel launches per train step at 448² batch 5: stage 4 (14x14, C = 384) runs
# the kernels too, K3 under cuda_pack (stage 4 is not packed)
TRAIN448_CONFIGS = {
    "cuda_pack": {"K1": 32, "K1 bwd": 32, "K2": 24, "K2 bwd": 24, "K3": 8, "K3 bwd": 8},
    "cuda": {"K3": 40, "K3 bwd": 40},
    "cuda_block": {"K4": 40, "K4 bwd": 40},
}
TRAIN448_DROP = {"K4 drop": 40, "K4 drop bwd": 40}  # the cuda_block dropout step at 448²


def _no_old_kernels(counts, label):
    """A traced step launched no kernel of ``csrc/fused_block.cu`` or ``csrc/window_attention.cu``
    (and, with the stage-4 blocks on the kernels, no composition mask): raises otherwise."""
    kernels = FIVE_BWD_KERNELS + FIVE_FWD_KERNELS + THREE_BWD_KERNELS + ("dropout_rows_kernel", "dropout_attn_kernel")
    old = {name: n for name, (n, _) in counts.items() if any(k in name for k in kernels)}
    print(f"[trace]   train {label}: kernels of fused_block.cu, window_attention.cu and the composition's "
          f"masks {sum(old.values())}", flush=True)
    if old:
        raise AssertionError(f"{label}: old or composition kernels ran: {old}")


def stage4_families(cfg, device, card, runs=2):
    """Stage 4's device ms in a 448² batch-5 step by kernel family (:data:`KERNEL_FAMILIES`),
    from torch.profiler: the forward and backward of the step's 8 stage-4 blocks as the
    step launches them, K4 (``cuda_block``) and K3 (``cuda``, and ``cuda_pack``, which does not
    pack stage 4), the 8 blocks' calls in one session, each block at its shapes and inputs of
    its scale."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    def family(name):
        return next((f for f, keys in KERNEL_FAMILIES if any(k.lower() in name.lower() for k in keys)),
                    "other elementwise")

    calls = {"cuda_block (K4)": [], "cuda (K3)": []}
    for case, x, weights in block_cases(cfg, device, False, TRAIN448_HW, TRAIN448_BATCH, stages=(4,)):
        k, h, w, c, heads, d, role, hidden, shift, cross = case
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(hidden + shift)).to(device)
        _, kw = fused_args(case, x, "image")
        akw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
        calls["cuda_block (K4)"].append(functools.partial(
            lambda x, g, weights, kw: (tfb._launch_fwd(x, weights, kw), tfb._launch_bwd(g, x, weights, kw)),
            x, g, weights, kw))
        calls["cuda (K3)"].append(functools.partial(
            lambda x, g, weights, kw: (twa._launch_fwd(x, weights, kw), twa._launch_bwd(g, x, weights, kw)),
            x, g, weights[2:11], akw))
    for name, fns in calls.items():
        got = _profile_kernels(lambda: [fn() for fn in fns], runs)
        if got is None:
            print(f"[train] 448x448 bs={TRAIN448_BATCH} stage 4 {name}: the profiler recorded no device time: not "
                  f"measured | {card}", flush=True)
            continue
        families = {}
        for kernel, ms in got.items():
            families[family(kernel)] = families.get(family(kernel), 0.0) + ms
        print(f"[train] 448x448 bs={TRAIN448_BATCH} stage 4 {name}, forward and backward of the 8 blocks: "
              f"{sum(families.values()):.4f} ms of device time: "
              + ", ".join(f"{f} {ms:.4f} ms" for f, ms in sorted(families.items(), key=lambda kv: -kv[1]))
              + f" | {card}", flush=True)


def train_448(flat, device, card):
    """The training main paths at a 448² crop, batch 5, where stage 4 (C = 384) runs the kernels
    (K4's backward on the split route, K3's backward at d = 48 on the tiled core): the first step
    under each configuration with its exact launches, stage 4's included, against the torch
    composition's first step on the card (as :func:`train_configs`); TRAIN_STEPS steps each in
    turns and one traced step each, which must launch no kernel of ``csrc/fused_block.cu`` or
    ``csrc/window_attention.cu``; stage 4's device time by kernel family
    (:func:`stage4_families`); then one ``cuda_block`` step with every dropout ratio
    DROP_RATIOS, its exact launches, repeated from a second state bit for bit, and traced the
    same way."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED + 448)
    ir = torch.from_numpy(rng.random((TRAIN448_BATCH, *TRAIN448_HW, 1), dtype=np.float32)).to(device)
    vis = torch.from_numpy(rng.random((TRAIN448_BATCH, *TRAIN448_HW, 1), dtype=np.float32)).to(device)
    label_hw = f"{TRAIN448_HW[0]}x{TRAIN448_HW[1]} bs={TRAIN448_BATCH}"
    names = ("torch", *TRAIN448_CONFIGS)
    states, steps, first = {}, {}, {}
    for impl in names:
        cfg = Config(model=ModelConfig(attention_impl=impl))
        states[impl] = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
        steps[impl] = make_train_step(cfg)
        torch.cuda.synchronize()
        reset_counts()
        terms = steps[impl](states[impl], ir, vis)
        torch.cuda.synchronize()
        if impl != "torch":
            got = {**read_counts(impl), **read_mask_counts()}
            expected = dict.fromkeys(got, 0)
            expected.update(TRAIN448_CONFIGS[impl])
            print(f"[train] 448 {impl} first step: launches {got}", flush=True)
            if got != expected:
                raise AssertionError(f"{impl} 448 train step: launches {got}, expected {expected}")
        grads = _grads(states[impl].model)
        if len(grads) != sum(1 for _ in states[impl].model.parameters()) or \
                not all(torch.isfinite(v).all() for v in grads.values()):
            raise AssertionError(f"{impl} 448: a gradient is missing or not finite")
        first[impl] = ({k: float(v) for k, v in terms.items()}, grads)
        if impl == "torch":
            torch.cuda.empty_cache()
    ref_terms, ref_grads = first.pop("torch")
    for impl, (terms, grads) in first.items():
        for k, v in terms.items():
            if abs(v - ref_terms[k]) > 1e-5 * abs(ref_terms[k]):
                raise AssertionError(f"{impl} 448 step 1 {k} {v} vs torch composition {ref_terms[k]}")
        check = assert_grads_close([grads[n] for n in ref_grads], list(ref_grads.values()), list(ref_grads),
                                   f"{impl} 448 step 1")
        rel = max(abs(terms[k] - ref_terms[k]) / max(abs(ref_terms[k]), 1e-30) for k in terms)
        print(f"[parity] 448 {impl} train step 1 vs torch composition on the card: loss terms max relative "
              f"difference {rel:.3e}, gradients max_abs_err {check.worst:.3e} (the worst {check.worst_own:.3e} "
              f"of a gradient's own largest; {len(check.zeros)} exactly 0) | {card}", flush=True)
    del first, ref_grads
    torch.cuda.empty_cache()

    walls = {impl: [] for impl in names}
    for _ in range(TRAIN_STEPS):
        for impl in names:
            t = time.perf_counter()
            steps[impl](states[impl], ir, vis)
            torch.cuda.synchronize()
            walls[impl].append(1e3 * (time.perf_counter() - t))
    for impl in names:
        w = walls[impl]
        median = float(np.median(w))
        label = "torch composition" if impl == "torch" else impl
        print(f"[train] step {label_hw} ({label}), {TRAIN_STEPS} steps in turns: median {median:.2f} ms/step, "
              f"min {min(w):.2f}, max {max(w):.2f} | {card}", flush=True)
        counts = trace(f"train step {label_hw} ({label})", f"train 448 {label}",
                       lambda: steps[impl](states[impl], ir, vis), median, card)
        if impl == "torch":
            continue
        if not counts:
            raise AssertionError(f"{impl} 448: the profiler recorded no kernels: the old launches' absence not read")
        _no_old_kernels(counts, f"448 {impl}")
    del states, steps
    torch.cuda.empty_cache()
    stage4_families(ModelConfig(), device, card)

    ratios = dict(zip(("attention_drop_ratio", "linear_after_att_drop_ratio", "mlp_drop_ratio"), DROP_RATIOS))
    cfg = Config(model=ModelConfig(attention_impl="cuda_block", **ratios))
    step = make_train_step(cfg)
    runs = []
    for repeat in range(2):
        state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
        torch.cuda.synchronize()
        reset_counts()
        torch.use_deterministic_algorithms(True)
        try:
            terms = step(state, ir, vis)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        got = {**read_counts("cuda_block"), **read_mask_counts()}
        expected = dict.fromkeys(got, 0)
        expected.update(TRAIN448_DROP)
        if got != expected:
            raise AssertionError(f"cuda_block dropout 448 step: launches {got}, expected {expected}")
        grads = _grads(state.model)
        if not all(torch.isfinite(v).all() for v in grads.values()):
            raise AssertionError("cuda_block dropout 448: a gradient is not finite")
        runs.append(({k: v.item() for k, v in terms.items()}, grads))
    (terms_a, grads_a), (terms_b, grads_b) = runs
    same = terms_a == terms_b and all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
    print(f"[train] 448 dropout cuda_block first step: launches {got}; "
          + ", ".join(f"{k} {v:.7g}" for k, v in terms_a.items())
          + f"; all {len(grads_a)} gradients finite; repeated from a second state: bit-identical {same}", flush=True)
    if not same:
        raise AssertionError("cuda_block dropout 448 step repeated differs")
    del runs, grads_a, grads_b
    w = []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        step(state, ir, vis)
        torch.cuda.synchronize()
        w.append(1e3 * (time.perf_counter() - t))
    median = float(np.median(w))
    label = f"cuda_block, dropout {DROP_RATIOS}"
    print(f"[train] step {label_hw} ({label}), {TRAIN_STEPS} steps: median {median:.2f} ms/step | {card}",
          flush=True)
    counts = trace(f"train step {label_hw} ({label})", f"train 448 {label}", lambda: step(state, ir, vis),
                   median, card)
    if not counts:
        raise AssertionError("cuda_block dropout 448: the profiler recorded no kernels")
    _no_old_kernels(counts, f"448 {label}")
    del state, step
    torch.cuda.empty_cache()


def dropout_train(flat, device, card, states, steps, inputs):
    """The dropout main paths after the steps without dropout: the first dropout step per
    configuration (:func:`dropout_first_steps`), then TRAIN_STEPS timed steps of each
    configuration with and without dropout, all in turns, and one profiled dropout step
    each. A step's peak memory is printed as read and, beside it, less the other
    configurations' train states resident in this run. Returns the dropout kernels'
    launches."""
    ir, vis = inputs
    drop_states, drop_steps, launches = dropout_first_steps(flat, device, ir, vis, card)
    states, steps = {**states, **drop_states}, {**steps, **drop_steps}
    names = (*TRAIN_DROP_CONFIGS, *drop_steps)
    walls = {impl: [] for impl in names}
    peaks, own = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    for _ in range(TRAIN_STEPS):
        for impl in names:
            others = torch.cuda.memory_allocated() - state_bytes(states[impl])
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            steps[impl](states[impl], ir, vis)
            torch.cuda.synchronize()
            walls[impl].append(1e3 * (time.perf_counter() - t))
            peak = torch.cuda.max_memory_allocated()
            peaks[impl] = max(peaks[impl], peak / 2**20)
            own[impl] = max(own[impl], (peak - others) / 2**20)
    median = {impl: float(np.median(w)) for impl, w in walls.items()}
    for impl in names:
        w = walls[impl]
        base = impl.split()[0]
        label = f"{base}, dropout {DROP_RATIOS}" if impl in drop_steps else impl
        versus = (f" ({median[impl] / median[base] - 1:+.1%} against the step without dropout in "
                  f"the same turns)" if impl in drop_steps else "")
        print(f"[train] step 224x224 bs={TRAIN_BATCH} ({label}), {TRAIN_STEPS} steps in turns with "
              f"and without dropout: median {median[impl]:.2f} ms/step{versus}, min {min(w):.2f}, "
              f"max {max(w):.2f}, peak memory {peaks[impl]:.0f} MiB ({own[impl]:.0f} MiB less "
              f"the other configurations' train states) | {card}", flush=True)
    for impl in drop_steps:
        base = impl.split()[0]
        label = f"{base}, dropout {DROP_RATIOS}"
        counts = trace(f"train step 224x224 bs={TRAIN_BATCH} ({label})", f"train {label}",
                       lambda: steps[impl](states[impl], ir, vis), median[impl], card)
        if not counts:
            print(f"[trace]   train {label}: no kernels recorded, the old launches' absence not read", flush=True)
        elif base in ("cuda_pack", "cuda_block"):  # K1/K4 drop fwd and bwd on the redesigned routes alone
            old = {name: n for name, (n, _) in counts.items() if any(k in name for k in FIVE_BWD_KERNELS)}
            old_fwd = {name: n for name, (n, _) in counts.items() if any(k in name for k in FIVE_FWD_KERNELS)}
            dropout_rows = sum(n for name, (n, _) in counts.items() if "dropout_rows_kernel" in name)
            masks = TRAIN_DROP_MASKS[base]["mask tokens"] + TRAIN_DROP_MASKS[base]["mask tokens bwd"]
            print(f"[trace]   train {label}: fused_block.cu backward kernels {sum(old.values())}, forward "
                  f"kernels {sum(old_fwd.values())}, dropout_rows_kernel {dropout_rows} (the composition's "
                  f"token masks: {masks})", flush=True)
            if old or old_fwd or dropout_rows > masks:
                raise AssertionError(f"{base} dropout step: fused_block.cu's backward ran: {old}, its forward: "
                                     f"{old_fwd}, dropout_rows_kernel x{dropout_rows}")
        else:
            check_k3_drop_trace(counts, label, card)
    return launches


def k3_drop_kernels(cfg, bf16=False) -> int:
    """K3's forward kernels in a ``cuda`` dropout step at 224²: 8 calls a stage at stages 0-3
    (encoder and decoder, shift x cross), each the kernels of ``fwd_plan(..., drop=True)``'s
    route (one fused, two split)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    return sum(8 * twa.fwd_plan(c, heads, d, WINDOW, False, bf16, True).launches
               for _, _, _, c, heads, d in stage_geometries(cfg, TRAIN_HW)[:4])


def check_k3_drop_trace(counts, label, card, bf16=False):
    """A ``cuda`` dropout step's trace: K3's dropout forward and backward on the redesigned
    kernels alone (no kernel of ``csrc/window_attention.cu``, forward or backward), K3's forward
    kernels as many as the plan reckons; prints the composition's mask kernels' device ms, the
    token masks' apart from the attention weights'."""
    from swin_unet_image_fusion_tpu_torch import ModelConfig

    old = {name: n for name, (n, _) in counts.items() if any(k in name for k in FIVE_FWD_KERNELS + THREE_BWD_KERNELS)}
    k3 = sum(n for name, (n, _) in counts.items() if "k3_attention_kernel" in name or "k3_proj_kernel" in name)
    expected = k3_drop_kernels(ModelConfig(), bf16)
    masks = {kernel: [sum(v[i] for name, v in counts.items() if kernel in name) for i in (0, 1)]
             for kernel in ("dropout_rows_kernel", "dropout_attn_kernel")}
    bound = token_mask_step_bound(ModelConfig(), 2 if bf16 else 4)
    print(f"[trace]   train {label}: window_attention.cu forward and backward kernels {sum(old.values())}, K3 "
          f"forward kernels {k3} (the plan: {expected}); "
          + ", ".join(f"{kernel} {ms:.3f} ms in {n} launches" for kernel, (n, ms) in masks.items())
          + f"; the token masks {masks['dropout_rows_kernel'][1] / bound:.2f}x their bound {bound:.4f} ms "
          f"| {card}", flush=True)
    if old or k3 != expected:
        raise AssertionError(f"{label}: window_attention.cu's kernels ran: {old}; K3 forward kernels {k3}, "
                             f"the plan {expected}")


# ---- dropout training: the hash-dropout forms of K3, K1 and K4 --------------------------
DROP_RATIOS = (0.1, 0.1, 0.1)  # attention, proj, MLP: a test setting (the reference's are 0)
# kernels that only csrc/fused_block.cu's twenty-launch backward runs in a cuda_pack or
# cuda_block step (its recompute's LN1 and LN2, the core backward, the LayerNorm backwards,
# its weight-gradient GEMMs); its dropout_rows_kernel launches are counted apart
FIVE_BWD_KERNELS = ("swin::ln_fwd_kernel", "window_core_bwd_kernel", "swin::ln_bwd_kernel", "swin::wgrad_kernel")
# kernels that only csrc/fused_block.cu's five-launch forward and csrc/window_attention.cu's
# three-launch forward run (their GEMMs and attention core), and that only csrc/window_attention.cu's
# three-launch backward runs in a cuda step (its core backward and weight-gradient GEMMs)
FIVE_FWD_KERNELS = ("swin::gemm_kernel", "window_core_kernel")
THREE_BWD_KERNELS = ("window_core_bwd_kernel", "swin::wgrad_kernel")
DROP_CHECK_RATES = (0.1, 0.5)  # at 0.5 a mismatched mask cannot hide inside the tolerance
DROP_SEED = 4_242_421
# attention_impl -> the dropout step's launches at 224²: the dropout forms replace the
# forms without dropout one for one (K2 has no dropout)
TRAIN_DROP_CONFIGS = {
    "cuda_pack": {"K1 drop": 32, "K1 drop bwd": 32, "K2": 24, "K2 bwd": 24},
    "cuda": {"K3 drop": 32, "K3 drop bwd": 32},
    "cuda_block": {"K4 drop": 32, "K4 drop bwd": 32},
}
DROP_MAIN_PATH = {f"{name} drop{bwd}": impl for name, impl in
                  (("K3", "cuda"), ("K1", "cuda_pack"), ("K4", "cuda_block")) for bwd in ("", " bwd")}
# attention_impl -> the composition's mask launches in the dropout step (csrc/dropout_mask.cu),
# forward and on the gradient: the 8 stage-4 blocks' attention weights and 3 token sites
# (proj, MLP hidden, MLP out) each; under cuda also the 3 token sites of the 32 blocks of
# stages 0-3, whose attention weights K3 masks
TRAIN_DROP_MASKS = {
    "cuda_pack": {"mask tokens": 24, "mask tokens bwd": 24, "mask attention": 8, "mask attention bwd": 8},
    "cuda": {"mask tokens": 120, "mask tokens bwd": 120, "mask attention": 8, "mask attention bwd": 8},
    "cuda_block": {"mask tokens": 24, "mask tokens bwd": 24, "mask attention": 8, "mask attention bwd": 8},
}
MASK_MAIN_PATH = "cuda"  # the configuration whose dropout step gives the masks' launches
PARITY_HW, PARITY_BATCH = (112, 112), 2  # the full-width dropout step on the card vs the CPU


def hash_ops(h, w, c, heads, hidden, batch, attention_only, window=WINDOW):
    """Integer operations of the hash masks of one dropout launch (both streams): HASH_OPS
    per masked element, each keep decision once: the attention weights (heads x T x T per
    window), proj, the MLP hidden and out. The least the function needs, forward and backward
    alike: a backward that recomputes its forward can keep the recompute's bits for its own
    use, as the redesigned K1/K4 dropout backward keeps the attention's."""
    tokens = 2 * batch * h * w
    attention = tokens * heads * window[0] * window[1]
    if attention_only:
        return HASH_OPS * attention
    return HASH_OPS * (attention + tokens * c + tokens * hidden + tokens * c)


def _keep_fractions(key, hw, shift, rate, seed, heads, hidden, c, batch, sites):
    """Kept share of each site's mask for one launch (the masks the kernel and its plain
    version draw)."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
    from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

    out = {}
    if "attention" in sites:
        keep = dl.attention_keep(seed, rate, key, dl.windows_table(key), 2, batch, heads)
        out["attention"] = (keep.sum().item(), keep.numel())
    for site, name, cols in ((hd.SITE_PROJ, "proj", c), (hd.SITE_MLP_HIDDEN, "hidden", hidden),
                             (hd.SITE_MLP_OUT, "out", c)):
        if name in sites:
            keep = dl.token_keep(seed, site, rate, key, 2, batch, cols)
            out[name] = (keep.sum().item(), keep.numel())
    return out


def _print_keep(name, kept, card):
    for rate, sites in kept.items():
        shares = ", ".join(f"{site} {k / n:.6f} of {n}" for site, (k, n) in sites.items())
        print(f"[check] {name} drop rate {rate}: keep fraction {shares} (expected {1 - rate:.6f}) "
              f"| {card}", flush=True)


def _turns(fns, iters, warmup):
    """Mean ms of each launch in ``fns``, timed in turns: in order, then in reverse."""
    first = [time_ms(fn, iters, warmup) for fn in fns]
    second = [time_ms(fn, iters, warmup) for fn in reversed(fns)][::-1]
    return tuple((a + b) / 2 for a, b in zip(first, second))


def _in_turns(nodrop, drop, iters, warmup, other=None):
    """(without dropout, with dropout) mean ms of two launches timed in turns (without,
    with, with, without); with ``other``, (without, with, other) in turns (without, with,
    other, other, with, without)."""
    return _turns((nodrop, drop) if other is None else (nodrop, drop, other), iters, warmup)


def _queued_turns(fns, iters):
    """Mean device ms of each launch in ``fns`` by :func:`queued_ms`, in turns: in order,
    then in reverse."""
    first = [queued_ms(fn, iters) for fn in fns]
    second = [queued_ms(fn, iters) for fn in reversed(fns)][::-1]
    return tuple((a + b) / 2 for a, b in zip(first, second))


def _new_versus():
    """The sums of a token-mask phase's comparisons with the kernel's first form."""
    return dict(new_ms=0.0, old_ms=0.0, queued_ms=0.0, old_queued_ms=0.0, device_ms=0.0,
                old_device_ms=0.0, read_bound_ms=0.0, unread=0, slower_queued=0, slower_device=0,
                lost=[])


def _versus(tally, what, weight, bound, new_ms, old_ms, queued, old_queued, dev, old_dev):
    """Add a shape that a step launches ``weight`` times to ``tally``: its launch and the first
    form's in turns by events, by events with the launch queue filled ahead, and by the
    profiler's device time. A shape that the profiler did not read on either side stays out
    of both device sums and of the bound they are held to. Shapes slower than the first form
    are counted on each clock, and those slower by events listed."""
    for key, v in (("new_ms", new_ms), ("old_ms", old_ms), ("queued_ms", queued),
                   ("old_queued_ms", old_queued)):
        tally[key] += weight * v
    tally["slower_queued"] += queued > old_queued
    read = dev is not None and old_dev is not None
    if new_ms > old_ms:
        tally["lost"].append(f"{what}: {new_ms:.4f} ms against {old_ms:.4f} by events; queue filled "
                             f"{queued:.4f} against {old_queued:.4f}; device time "
                             + (f"{dev:.4f} against {old_dev:.4f}" if read else "not read"))
    if not read:
        tally["unread"] += 1
        return
    tally["slower_device"] += dev > old_dev
    for key, v in (("device_ms", dev), ("old_device_ms", old_dev), ("read_bound_ms", bound)):
        tally[key] += weight * v


def _versus_lines(name, tally, cases, card):
    """Print a token-mask phase's per-step comparison with the kernel's first form."""
    t = tally
    ratio = t["device_ms"] / t["read_bound_ms"] if t["read_bound_ms"] else float("nan")
    print(f"[time] {name} per step against the kernel's first form (a thread an element), in turns: "
          f"{t['new_ms']:.3f} ms against {t['old_ms']:.3f} ms by events (the host's launch rate where a "
          f"launch is shorter than its host path); {t['queued_ms']:.3f} against {t['old_queued_ms']:.3f} ms "
          f"by events with the launch queue filled ahead; device time {t['device_ms']:.3f} against "
          f"{t['old_device_ms']:.3f} ms (profiler) over the {cases - t['unread']} of {cases} shapes read on "
          f"both sides, {ratio:.2f}x their bound {t['read_bound_ms']:.4f} ms; slower than the first form: "
          f"{len(t['lost'])} of {cases} shapes by events, {t['slower_queued']} with the queue filled, "
          f"{t['slower_device']} by device time | {card}", flush=True)
    for line in t["lost"]:
        print(f"[time] {name} slower by events than the first form at {line} | {card}", flush=True)


def check_dropout_kernels(cfg, device, card):
    """The dropout forms of K1 (windows layout, packed stages) and K4 (image layout) with
    every site at each rate of DROP_CHECK_RATES, and of K3 (the attention site), forward
    and backward, against their plain versions with the same seed at every stage 0-3 x
    role x shift x cross shape of a 224² batch-20 step (fp32 atol/rtol 1e-4; gradients by
    ``testing.assert_grads_close``), with the keep fraction of each site; K1's and K4's
    forward on the dropout form of ``csrc/fused_block_fwd.cu``'s route (one launch at stages
    0-1, six at 2-3) and backward on the dropout form of the route ``block_bwd_plan`` names
    (fused at stages 0-1, split at 2-3), K3's forward on the dropout form of
    ``csrc/window_attention_fwd.cu``'s route (one launch at stages 0-1, two at 2-3) and
    backward on ``csrc/window_attention_bwd.cu``'s (fused at stages 0-1, split at 2-3), each of
    these cases repeated bit for bit; then each form timed at the step's ratios in turns with
    the form without dropout and the old launches it replaced (``csrc/fused_block.cu``'s
    five-launch forward and twenty-launch backward, ``csrc/window_attention.cu``'s three-launch
    forward and backward), per case, per stage and per step. Returns the worst errors and the
    per-step times by kernel name."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    worst, results = {}, {}
    for name, layout in (("K1", "windows"), ("K4", "image")):
        totals = {part: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, nodrop_ms=0.0, old_ms=0.0) for part in ("", " bwd")}
        by = {part: {} for part in totals}
        stage_ms = {part: {} for part in totals}  # stage -> (dropout form, old launches, without dropout)
        kept, errs, cases = {}, {part: 0.0 for part in totals}, 0
        # the blocks of stages 0-3, as train_block_backward (stage 4's 7x7 map is gated to
        # the composition at 224²)
        for case, x, weights in block_cases(cfg, device, True, TRAIN_HW, TRAIN_BATCH):
            cases += 1
            xl, kw = fused_args(case, x, layout)
            k, h, w, c, heads, d, role, hidden, shift, cross = case
            route = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, True).route
            if route != ("fused" if k < 2 else "split"):
                raise AssertionError(f"{name} drop bwd stage {k} {role}: the plan routes {route!r}")
            fwd_route = tfb.block_fwd_plan(c, heads, d, hidden, WINDOW, cross, False, True).route
            if fwd_route != ("fused" if k < 2 else "split"):
                raise AssertionError(f"{name} drop stage {k} {role}: the forward's plan routes {fwd_route!r}")
            routes = {"": fwd_route, " bwd": route}
            g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(k + 7)).to(device)
            seed = DROP_SEED + 100 * k + 10 * shift + cross
            for rate in DROP_CHECK_RATES:
                dkw = dict(kw, drop_rates=(rate,) * 3, drop_seed=seed)
                what = (f"[{name.lower()} drop] stage {k} {role} {h}x{w}x{TRAIN_BATCH} C={c} "
                        f"hidden={hidden} shift={shift} cross={cross} rate {rate}")
                out = tfb.fused_block(xl, *weights, **dkw)
                again = tfb.fused_block(xl, *weights, **dkw)
                torch.cuda.synchronize()
                err, _ = compare_kernel(out, tfb.fused_block_plain(xl, *weights, **dkw), what + f" ({fwd_route})")
                if not torch.equal(out, again):
                    raise AssertionError(f"{what} ({fwd_route}): a repeat gave other bits")
                got = tfb._launch_bwd(g, xl, weights, dkw)
                again = tfb._launch_bwd(g, xl, weights, dkw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what} bwd ({route}): a repeat gave other bits")
                del again
                check = assert_grads_close(got, tfb.fused_block_bwd_plain(g, xl, *weights, **dkw),
                                           ("x", *tfb.WEIGHT_NAMES), what + " bwd")
                print(f"{what} bwd ({route}): max_abs_err {check.worst:.3e}, {check.worst_own:.3e} of a "
                      f"gradient's own largest; forward and backward repeated bit for bit", flush=True)
                errs[""], errs[" bwd"] = max(errs[""], err), max(errs[" bwd"], check.worst)
                key = tfb.block_keying(layout, (h, w), WINDOW, shift, heads, d, device)
                for site, kn in _keep_fractions(key, (h, w), shift, rate, seed, heads, hidden, c,
                                                TRAIN_BATCH, ("attention", "proj", "hidden", "out")).items():
                    sk, sn = kept.setdefault(rate, {}).get(site, (0, 0))
                    kept[rate][site] = (sk + kn[0], sn + kn[1])
                del out, got
            dkw = dict(kw, drop_rates=DROP_RATIOS, drop_seed=seed)
            for part, launch, old, plain, iters, old_name in (
                    ("", lambda a: tfb.fused_block(xl, *weights, **a), lambda: tfb._launch_five(xl, weights, dkw),
                     lambda: tfb.fused_block_plain(xl, *weights, **dkw), 5, "five launches"),
                    (" bwd", lambda a: tfb._launch_bwd(g, xl, weights, a),
                     lambda: tfb._launch_bwd_five(g, xl, weights, dkw),
                     lambda: tfb.fused_block_bwd_plain(g, xl, *weights, **dkw), 3, "twenty launches")):
                # in turns with the route without dropout and the old launches with dropout
                nodrop, ms, old_ms = _in_turns(lambda: launch(kw), lambda: launch(dkw), iters, 1, old)
                st = stage_ms[part].setdefault(k, [0.0, 0.0, 0.0])
                st[0], st[1], st[2] = st[0] + ms, st[1] + old_ms, st[2] + nodrop
                plain_ms = time_ms(plain, iters=2, warmup=1)
                ops = hash_ops(h, w, c, heads, hidden, TRAIN_BATCH, False)
                bound, bound_by = block_bound_ms(h, w, c, heads, d, hidden, TRAIN_BATCH,
                                                 backward=part == " bwd", int_ops=ops)
                print(f"[time] {name} drop{part} stage {k} {role} {h}x{w}x{TRAIN_BATCH} C={c} "
                      f"hidden={hidden} shift={shift} cross={cross} ({routes[part]}): {ms:.4f} ms, {old_name} "
                      f"{old_ms:.4f} ms ({ms / old_ms - 1:+.1%}), without dropout {nodrop:.4f} ms (in turns, "
                      f"{ms / nodrop - 1:+.1%}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) "
                      f"| {card}", flush=True)
                for key_, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("nodrop_ms", nodrop),
                                ("old_ms", old_ms)):
                    totals[part][key_] += v
                by[part][bound_by] = by[part].get(bound_by, 0.0) + bound
            torch.cuda.empty_cache()
        _print_keep(name, kept, card)
        for part, old_name in (("", "five launches"), (" bwd", "twenty launches")):
            for k, (ms, old_ms, nodrop) in sorted(stage_ms[part].items()):
                print(f"[time] {name} drop{part} stage {k} per 224x224 batch-20 step (8 launches, "
                      f"{'fused' if k < 2 else 'split'} route): {ms:.3f} ms, {old_name} {old_ms:.3f} ms "
                      f"({ms / old_ms - 1:+.1%}), without dropout {nodrop:.3f} ms ({ms / nodrop - 1:+.1%}), in "
                      f"turns | {card}", flush=True)
        for part, t in totals.items():
            old_name = "twenty launches" if part else "five launches"
            print(f"[check] {name} drop{part}: worst max_abs_err {errs[part]:.3e} over "
                  f"{cases} blocks x rates {DROP_CHECK_RATES}; every case repeated bit for bit", flush=True)
            print(f"[time] {name} drop{part} per 224x224 batch-20 step ({cases} launches): {t['ms']:.3f} ms, "
                  f"{old_name} {t['old_ms']:.3f} ms ({t['ms'] / t['old_ms'] - 1:+.1%}), without dropout "
                  f"{t['nodrop_ms']:.3f} ms ({t['ms'] / t['nodrop_ms'] - 1:+.1%}), plain {t['plain_ms']:.3f} ms, "
                  f"bound {t['bound_ms']:.4f} ms ({t['ms'] / t['bound_ms']:.1f}x) | {card}", flush=True)
            results[f"{name} drop{part}"] = dict(t, bound_by=max(by[part], key=by[part].get),
                                                 library_ms=None)
            worst[f"{name} drop{part}"] = errs[part]

    totals = {part: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, nodrop_ms=0.0, old_ms=0.0) for part in ("", " bwd")}
    by = {part: {} for part in totals}
    stage_ms = {part: {} for part in totals}  # stage -> (dropout form, three launches, without dropout) per step
    kept, errs, cases = {}, {part: 0.0 for part in totals}, 0
    names = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
    for k, h, w, c, heads, d in stage_geometries(cfg, TRAIN_HW)[:4]:
        x, *weights = attention_inputs(h, w, c, heads, d, SEED + k, device, TRAIN_BATCH)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(k + 9)).to(device)
        for shift in (False, True):
            for cross in (False, True):
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                seed = DROP_SEED + 100 * k + 10 * shift + cross + 1
                routes = {"": twa.fwd_plan(c, heads, d, WINDOW, cross, False, True).route,
                          " bwd": twa.bwd_plan(c, heads, d, WINDOW, cross, False, True).route}
                for part, route in routes.items():
                    if route != ("fused" if k < 2 else "split"):
                        raise AssertionError(f"K3 drop{part} stage {k}: the plan routes {route!r}")
                cases += 1
                for rate in DROP_CHECK_RATES:
                    dkw = dict(kw, attn_drop_rate=rate, drop_seed=seed)
                    what = (f"[k3 drop] stage {k} {h}x{w}x{TRAIN_BATCH} C={c} shift={shift} "
                            f"cross={cross} rate {rate}")
                    out = twa.window_attention(x, *weights, **dkw)
                    again = twa.window_attention(x, *weights, **dkw)
                    torch.cuda.synchronize()
                    err, _ = compare_kernel(out, twa.window_attention_plain(x, *weights, **dkw),
                                            f"{what} ({routes['']})")
                    if not torch.equal(out, again):
                        raise AssertionError(f"{what} ({routes['']}): a repeat gave other bits")
                    got = twa._launch_bwd(g, x, weights, dkw)
                    again = twa._launch_bwd(g, x, weights, dkw)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{what} bwd ({routes[' bwd']}): a repeat gave other bits")
                    del again
                    check = assert_grads_close(got, twa.window_attention_bwd_plain(g, x, *weights, **dkw),
                                               names, what + " bwd")
                    print(f"{what} bwd ({routes[' bwd']}): max_abs_err {check.worst:.3e}, {check.worst_own:.3e} "
                          f"of a gradient's own largest; forward and backward repeated bit for bit", flush=True)
                    errs[""], errs[" bwd"] = max(errs[""], err), max(errs[" bwd"], check.worst)
                    key = twa.attention_keying((h, w), WINDOW, shift, heads, d, device)
                    for site, kn in _keep_fractions(key, (h, w), shift, rate, seed, heads, 0, c,
                                                    TRAIN_BATCH, ("attention",)).items():
                        sk, sn = kept.setdefault(rate, {}).get(site, (0, 0))
                        kept[rate][site] = (sk + kn[0], sn + kn[1])
                    del out, got
                dkw = dict(kw, attn_drop_rate=DROP_RATIOS[0], drop_seed=seed)
                for part, launch, old, plain, iters in (
                        ("", lambda a: twa.window_attention(x, *weights, **a),
                         lambda: twa._launch_three(x, weights, dkw),
                         lambda: twa.window_attention_plain(x, *weights, **dkw), 5),
                        (" bwd", lambda a: twa._launch_bwd(g, x, weights, a),
                         lambda: twa._launch_bwd_three(g, x, weights, dkw),
                         lambda: twa.window_attention_bwd_plain(g, x, *weights, **dkw), 3)):
                    # in turns with the redesigned form without dropout and the three launches with dropout
                    nodrop, ms, old_ms = _in_turns(lambda: launch(kw), lambda: launch(dkw), iters, 1, old)
                    st = stage_ms[part].setdefault(k, [0.0, 0.0, 0.0])
                    st[0], st[1], st[2] = st[0] + 2 * ms, st[1] + 2 * old_ms, st[2] + 2 * nodrop
                    plain_ms = time_ms(plain, iters=2, warmup=1)
                    ops = hash_ops(h, w, c, heads, 0, TRAIN_BATCH, True)
                    bound, bound_by = attention_bound_ms(h, w, c, heads, d, TRAIN_BATCH,
                                                         backward=part == " bwd", int_ops=ops)
                    print(f"[time] K3 drop{part} stage {k} {h}x{w}x{TRAIN_BATCH} C={c} shift={shift} "
                          f"cross={cross} ({routes[part]}): {ms:.4f} ms, three launches {old_ms:.4f} ms "
                          f"({ms / old_ms - 1:+.1%}), without dropout {nodrop:.4f} ms (in turns, "
                          f"{ms / nodrop - 1:+.1%}), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}) "
                          f"| {card}", flush=True)
                    for key_, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                                    ("nodrop_ms", nodrop), ("old_ms", old_ms)):
                        totals[part][key_] += 2 * v  # encoder and decoder
                    by[part][bound_by] = by[part].get(bound_by, 0.0) + 2 * bound
        torch.cuda.empty_cache()
    _print_keep("K3", kept, card)
    for part in totals:
        for k, (ms, old_ms, nodrop) in sorted(stage_ms[part].items()):
            launches = twa.fwd_plan(*stage_geometries(cfg, TRAIN_HW)[k][3:], WINDOW, False, False, True).launches
            print(f"[time] K3 drop{part} stage {k} per 224x224 batch-20 step (8 calls, "
                  f"{'fused' if k < 2 else 'split'} route{'' if part else f', {launches} kernels a call'}): "
                  f"{ms:.3f} ms, three launches {old_ms:.3f} ms ({ms / old_ms - 1:+.1%}), without dropout "
                  f"{nodrop:.3f} ms ({ms / nodrop - 1:+.1%}), in turns | {card}", flush=True)
    for part, t in totals.items():
        print(f"[check] K3 drop{part}: worst max_abs_err {errs[part]:.3e} over {cases} shapes "
              f"x rates {DROP_CHECK_RATES}; every case repeated bit for bit", flush=True)
        print(f"[time] K3 drop{part} per 224x224 batch-20 step under cuda ({2 * cases} calls): "
              f"{t['ms']:.3f} ms, three launches {t['old_ms']:.3f} ms ({t['ms'] / t['old_ms'] - 1:+.1%}), "
              f"without dropout {t['nodrop_ms']:.3f} ms ({t['ms'] / t['nodrop_ms'] - 1:+.1%}), plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['ms'] / t['bound_ms']:.1f}x) | {card}",
              flush=True)
        results[f"K3 drop{part}"] = dict(t, bound_by=max(by[part], key=by[part].get), library_ms=None)
        worst[f"K3 drop{part}"] = errs[part]
    return worst, results


def check_k3_drop_forward(cfg, device, card):
    """K3's dropout forward (``csrc/window_attention_fwd.cu``'s dropout form) at the shapes the
    224² step does not give: every stage of a 100x90 request (batch 1) and the 512² stage 4
    (a 21x21 map, C = 384, the split route at pitch 48), fp32 and bf16, every shift x cross
    case at each rate of DROP_CHECK_RATES, against the plain version (``compare_kernel``),
    each call repeated bit for bit, with the attention site's keep fraction. Returns the worst
    errors by kernel name."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    shapes = [("100x90", *geo) for geo in stage_geometries(cfg, (100, 90))]
    shapes.append(("512", *stage_geometries(cfg, SERVE_HW)[4]))
    worst, kept = {}, {}
    for where, k, h, w, c, heads, d in shapes:
        x32, *weights = attention_inputs(h, w, c, heads, d, SEED + 50 + k, device)
        for dtype in (torch.float32, BF16):
            x = x32.to(dtype)
            for shift in (False, True):
                for cross in (False, True):
                    route = twa.fwd_plan(c, heads, d, WINDOW, cross, dtype == BF16, True).route
                    seed = DROP_SEED + 500 + 100 * k + 10 * shift + cross
                    for rate in DROP_CHECK_RATES:
                        dkw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross,
                                   attn_drop_rate=rate, drop_seed=seed)
                        what = (f"[k3 drop{tag(dtype)}] {where} stage {k} {h}x{w} C={c} ({route}) shift={shift} "
                                f"cross={cross} rate {rate}")
                        out, again = twa.window_attention(x, *weights, **dkw), twa.window_attention(x, *weights, **dkw)
                        torch.cuda.synchronize()
                        err, _ = compare_kernel(out, twa.window_attention_plain(x, *weights, **dkw), what)
                        if not torch.equal(out, again):
                            raise AssertionError(f"{what}: a repeat gave other bits")
                        name = f"K3 drop{tag(dtype)}"
                        worst[name] = max(worst.get(name, 0.0), err)
                        if dtype == torch.float32:  # the masks do not depend on the dtype
                            key = twa.attention_keying((h, w), WINDOW, shift, heads, d, device)
                            for site, kn in _keep_fractions(key, (h, w), shift, rate, seed, heads, 0, c, 1,
                                                            ("attention",)).items():
                                sk, sn = kept.setdefault(rate, {}).get(site, (0, 0))
                                kept[rate][site] = (sk + kn[0], sn + kn[1])
        torch.cuda.empty_cache()
    _print_keep("K3 (100x90, 512² stage 4)", kept, card)
    print(f"[check] K3 drop at 100x90 (every stage) and the 512x512 stage 4 (C=384): worst "
          + ", ".join(f"{key} {v:.3e}" for key, v in worst.items())
          + f" over 4 shift x cross cases x rates {DROP_CHECK_RATES} a shape, each repeated bit for bit", flush=True)
    return worst


def check_drop_c384(cfg, device, card):
    """The new dropout forms at one C = 384 shape, stage 4 of a 512² request (a 21 x 21 map):
    K1's (windows layout) and K4's (image layout) dropout forward on ``csrc/fused_block_fwd.cu``'s
    six launches and K3's dropout backward on ``csrc/window_attention_bwd.cu``'s split route
    (pitch 48), fp32 and bf16, every shift x cross case at each rate of DROP_CHECK_RATES,
    against their plain versions (``compare_kernel``, ``assert_grads_close``; a bf16 backward
    by :func:`_check_bf16_grads`), each call repeated bit for bit. Returns the worst errors by
    kernel name."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    k, h, w, c, heads, d = stage_geometries(cfg, SERVE_HW)[4]
    hidden = c * cfg.mlp_hidden_dims_ratio
    worst = {}
    names = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
    for dtype in (torch.float32, BF16):
        x, *weights = block_inputs(h, w, c, heads, d, hidden, SEED + 40, device)
        ax, *aweights = attention_inputs(h, w, c, heads, d, SEED + 41, device)
        x, ax = x.to(dtype), ax.to(dtype)
        g = torch.randn(ax.shape, generator=torch.Generator().manual_seed(41)).to(device, dtype)
        for shift in (False, True):
            for cross in (False, True):
                case = (k, h, w, c, heads, d, "enc", hidden, shift, cross)
                seed = DROP_SEED + 400 + 10 * shift + cross
                for rate in DROP_CHECK_RATES:
                    for name, layout in (("K1", "windows"), ("K4", "image")):
                        xl, kw = fused_args(case, x, layout)
                        dkw = dict(kw, drop_rates=(rate,) * 3, drop_seed=seed)
                        route = tfb.block_fwd_plan(c, heads, d, hidden, WINDOW, cross,
                                                   tfb.rounds_operands(dtype, layout), True).route
                        what = (f"[{name.lower()} drop{tag(dtype)}] stage {k} {h}x{w} C={c} hidden={hidden} "
                                f"({route}) shift={shift} cross={cross} rate {rate}")
                        out, again = tfb.fused_block(xl, *weights, **dkw), tfb.fused_block(xl, *weights, **dkw)
                        torch.cuda.synchronize()
                        err, _ = compare_kernel(out, tfb.fused_block_plain(xl, *weights, **dkw), what)
                        if not torch.equal(out, again):
                            raise AssertionError(f"{what}: a repeat gave other bits")
                        key = f"{name} drop{tag(dtype)}"
                        worst[key] = max(worst.get(key, 0.0), err)
                    akw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross,
                               attn_drop_rate=rate, drop_seed=seed)
                    route = twa.bwd_plan(c, heads, d, WINDOW, cross, dtype == BF16, True).route
                    what = (f"[k3 drop bwd{tag(dtype)}] stage {k} {h}x{w} C={c} ({route}) shift={shift} "
                            f"cross={cross} rate {rate}")
                    got, again = twa._launch_bwd(g, ax, aweights, akw), twa._launch_bwd(g, ax, aweights, akw)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{what}: a repeat gave other bits")
                    ref = twa.window_attention_bwd_plain(g, ax, *aweights, **akw)
                    if dtype == BF16:
                        err = _check_bf16_grads(got, ref, names, what)
                    else:
                        err = assert_grads_close(got, ref, names, what).worst
                    print(f"{what}: max_abs_err {err:.3e}; repeated bit for bit", flush=True)
                    key = f"K3 drop bwd{tag(dtype)}"
                    worst[key] = max(worst.get(key, 0.0), err)
        torch.cuda.empty_cache()
    print(f"[check] the new dropout forms at C={c} ({h}x{w}, stage 4 of a 512x512 request): worst "
          + ", ".join(f"{key} {v:.3e}" for key, v in worst.items())
          + f" over 4 shift x cross cases x rates {DROP_CHECK_RATES}, each repeated bit for bit", flush=True)
    worst.update(check_stage4_backward(cfg, device, card))
    return worst


def check_stage4_backward(cfg, device, card):
    """The C = 384 backward at the 8 stage-4 blocks of a 448² batch-5 step (14 x 14, the encoder's
    and the decoder's MLP width x shift x cross), in the forms :func:`train_block_backward` and
    :func:`train_attention_backward` do not check: K1's (windows layout) and K4's (image layout)
    backward on the split route in bf16, and their dropout forms in fp32 and bf16 at each rate of
    DROP_CHECK_RATES; K3's backward (d = 48, the tiled core) in bf16, and its dropout form in fp32
    and bf16. Each against its plain version (``assert_grads_close``; a bf16 backward by
    :func:`_check_bf16_grads`), repeated bit for bit, and timed in turns with the twenty launches
    of ``csrc/fused_block.cu`` or the three of ``csrc/window_attention.cu``. Then K1's and K4's
    backward at TRAIN448_WIDE_BATCH (shift and cross, both MLP widths, fp32 and bf16, with and
    without dropout), where the stepped MLP backward's and the grouped g_ln product's blocks walk
    several 49-token tiles each, against the plain version and repeated bit for bit. Returns the
    worst errors by kernel name."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    worst, sums = {}, {}
    anames = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")

    def held(key, what, got, again, ref, names, new, old, old_name):
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: a repeat gave other bits")
        if got[0].dtype == BF16:
            err = _check_bf16_grads(got, ref, names, what)
        else:
            err = assert_grads_close(got, ref, names, what).worst
        old_ms, ms = _in_turns(old, new, 3, 1)
        print(f"{what}: max_abs_err {err:.3e}; repeated bit for bit; {ms:.4f} ms, {old_name} {old_ms:.4f} ms "
              f"(in turns) | {card}", flush=True)
        worst[key] = max(worst.get(key, 0.0), err)
        new_sum, old_sum = sums.get((key, old_name), (0.0, 0.0))
        sums[(key, old_name)] = (new_sum + ms, old_sum + old_ms)

    for dtype in (torch.float32, BF16):
        for rate in (0.0, *DROP_CHECK_RATES):
            if dtype == torch.float32 and not rate:
                continue  # train_block_backward and train_attention_backward check these
            form = (" drop bwd" if rate else " bwd") + tag(dtype)
            for case, x, weights in block_cases(cfg, device, False, TRAIN448_HW, TRAIN448_BATCH, stages=(4,)):
                k, h, w, c, heads, d, role, hidden, shift, cross = case
                g = torch.randn(x.shape, generator=torch.Generator().manual_seed(hidden + shift)).to(device, dtype)
                for name, layout in (("K1", "windows"), ("K4", "image")):
                    xl, kw = fused_args(case, x.to(dtype), layout)
                    gl = fused_args(case, g, layout)[0]
                    if rate:
                        kw = dict(kw, drop_rates=(rate,) * 3, drop_seed=DROP_SEED + 500 + 10 * shift + cross)
                    route = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, bool(rate)).route
                    what = (f"[{name.lower()}{form}] stage 4 of 448x448 {h}x{w}x{TRAIN448_BATCH} C={c} "
                            f"hidden={hidden} ({route}) shift={shift} cross={cross} rate {rate}")
                    if route != "split":
                        raise AssertionError(f"{what}: the plan routes {route!r}")
                    got, again = tfb._launch_bwd(gl, xl, weights, kw), tfb._launch_bwd(gl, xl, weights, kw)
                    torch.cuda.synchronize()
                    held(f"{name}{form}", what, got, again, tfb.fused_block_bwd_plain(gl, xl, *weights, **kw),
                         ("x", *tfb.WEIGHT_NAMES), lambda: tfb._launch_bwd(gl, xl, weights, kw),
                         lambda: tfb._launch_bwd_five(gl, xl, weights, kw), "twenty launches")
                    del got, again
                if role != "enc":
                    continue  # K3 has no MLP: one shape per shift x cross
                ax, *aweights = attention_inputs(h, w, c, heads, d, SEED + 44, device, TRAIN448_BATCH)
                ax = ax.to(dtype)
                akw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                if rate:
                    akw.update(attn_drop_rate=rate, drop_seed=DROP_SEED + 600 + 10 * shift + cross)
                route = twa.bwd_plan(c, heads, d, WINDOW, cross, dtype == BF16, bool(rate)).route
                what = (f"[k3{form}] stage 4 of 448x448 {h}x{w}x{TRAIN448_BATCH} C={c} ({route}) shift={shift} "
                        f"cross={cross} rate {rate}")
                got, again = twa._launch_bwd(g, ax, aweights, akw), twa._launch_bwd(g, ax, aweights, akw)
                torch.cuda.synchronize()
                held(f"K3{form}", what, got, again, twa.window_attention_bwd_plain(g, ax, *aweights, **akw), anames,
                     lambda: twa._launch_bwd(g, ax, aweights, akw), lambda: twa._launch_bwd_three(g, ax, aweights, akw),
                     "three launches")
                del got, again
            torch.cuda.empty_cache()
    # batch 20: 80 tiles a stream, so that the blocks of the stepped MLP backward and of the
    # grouped g_ln product walk several tiles each (at batch 5 a block holds one)
    for case, x, weights in block_cases(cfg, device, False, TRAIN448_HW, TRAIN448_WIDE_BATCH, stages=(4,)):
        k, h, w, c, heads, d, role, hidden, shift, cross = case
        if not (shift and cross):
            continue
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(hidden)).to(device)
        for dtype in (torch.float32, BF16):
            for rate in (0.0, DROP_CHECK_RATES[0]):
                form = (" drop bwd" if rate else " bwd") + tag(dtype)
                plan = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, bool(rate))
                tiles, blocks = TRAIN448_WIDE_BATCH * h * w // 49, plan.blocks(2, TRAIN448_WIDE_BATCH, h, w,
                                                                                tfb._sm_count(x.device))
                for name, layout in (("K1", "windows"), ("K4", "image")):
                    xl, kw = fused_args(case, x.to(dtype), layout)
                    gl = fused_args(case, g.to(dtype), layout)[0]
                    if rate:
                        kw = dict(kw, drop_rates=(rate,) * 3, drop_seed=DROP_SEED + 700 + hidden)
                    what = (f"[{name.lower()}{form}] stage 4 of 448x448 {h}x{w}x{TRAIN448_WIDE_BATCH} C={c} "
                            f"hidden={hidden} ({plan.route}, steps {plan.split_steps}, blocks {blocks} for {tiles} "
                            f"tiles) shift={shift} cross={cross} rate {rate}")
                    if plan.route != "split" or plan.split_steps == (1, 1) or max(blocks[0], blocks[2]) >= tiles:
                        raise AssertionError(f"{what}: not the stepped split route with blocks walking tiles")
                    got, again = tfb._launch_bwd(gl, xl, weights, kw), tfb._launch_bwd(gl, xl, weights, kw)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{what}: a repeat gave other bits")
                    ref = tfb.fused_block_bwd_plain(gl, xl, *weights, **kw)
                    names = ("x", *tfb.WEIGHT_NAMES)
                    err = (_check_bf16_grads(got, ref, names, what) if dtype == BF16 else
                           assert_grads_close(got, ref, names, what).worst)
                    print(f"{what}: max_abs_err {err:.3e}; repeated bit for bit | {card}", flush=True)
                    worst[f"{name}{form}"] = max(worst.get(f"{name}{form}", 0.0), err)
                    del got, again, ref
        torch.cuda.empty_cache()
    for (key, old_name), (new_sum, old_sum) in sums.items():
        calls = 8 if key.startswith(("K1", "K4")) else 4
        rates = 1 if "drop" not in key else len(DROP_CHECK_RATES)
        print(f"[time] {key} stage 4 of a 448x448 batch-{TRAIN448_BATCH} step, per step (8 calls; the mean over "
              f"{calls} shapes x {rates} rates, times 8): {8 * new_sum / (calls * rates):.4f} ms, {old_name} "
              f"{8 * old_sum / (calls * rates):.4f} ms (in turns) | {card}", flush=True)
    print("[check] the C = 384 backward at stage 4 of a 448x448 batch-5 step (K1 and K4 also at batch 20): worst "
          + ", ".join(f"{key} {v:.3e}" for key, v in worst.items())
          + f"; each case repeated bit for bit (dropout at rates {DROP_CHECK_RATES})", flush=True)
    return worst


def mask_bound_ms(elements, table_tokens, elem_bytes=4):
    """Least time for one launch of a composition mask: each element read and written once
    and the keying table read once, against the hash's integer work and the scale's
    multiply."""
    return _bound(elements, 2 * elem_bytes * elements + 8 * table_tokens,
                  int_ops=HASH_OPS * elements)


def token_mask_step_bound(cfg, elem_bytes=4):
    """The bound of the token masks of a ``cuda`` dropout step at 224² batch 20: proj and MLP
    out (8 launches a stage and keying) and each MLP hidden (2), forward and on the gradient."""
    total = 0.0
    for k, h, w, c, _, _ in stage_geometries(cfg, TRAIN_HW):
        for cols, per_step in ((c, 8), *((hidden, 2) for _, hidden in mlp_hiddens(cfg, k))):
            elements = 2 * TRAIN_BATCH * h * w * cols
            total += 2 * 2 * per_step * mask_bound_ms(elements, h * w, elem_bytes)[0]  # both keyings
    return total


def check_mask_kernels(cfg, device, card):
    """The composition's dropout masks (csrc/dropout_mask.cu) against their plain versions
    at the shapes of the 224² batch-20 dropout step under cuda: every token site (proj and
    MLP out of C columns, the encoder's and the decoder's MLP hidden) of stages 0-4 and
    the attention weights of the stage-4 blocks, normal and shifted keyings, rates of
    DROP_CHECK_RATES; forward and on a gradient, bit for bit (both compute ``keep ? x *
    scale : 0``), with the keep fraction of each site; the token kernel's first form (a
    thread an element, :func:`token_mask_first_form`) bit for bit too. Then each timed at
    the step's ratios, the token kernel in turns with its first form by CUDA events, by CUDA
    events with the launch queue filled ahead and by the profiler's device time, and its host
    µs a call beside the host path it replaced; per
    step a shape counts as often as the step launches it, twice (forward and gradient).
    Returns the worst errors and the per-step times by kernel name."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
    from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
    from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

    def check(what, launch, plain, x, g, rate):
        xg = x.detach().requires_grad_()
        out = launch(xg)
        (got,) = torch.autograd.grad(out, xg, g)
        torch.cuda.synchronize()
        xr = x.detach().requires_grad_()
        ref = plain(xr)
        (ref_g,) = torch.autograd.grad(ref, xr, g)
        same = torch.equal(out, ref) and torch.equal(got, ref_g)
        kept = (out != 0).sum().item()
        print(f"{what} rate {rate}: forward and gradient bit-exact {same}, keep fraction "
              f"{kept / out.numel():.6f} of {out.numel()}", flush=True)
        if not same:
            raise AssertionError(f"{what} rate {rate}: the mask kernel differs from its plain "
                                 f"version (max_abs_err {(out - ref).abs().max().item():.3e})")
        return kept, out.numel()

    geos = stage_geometries(cfg, TRAIN_HW)
    worst, results = {}, {}
    for name, cases in (("mask tokens", [
            (k, h, w, c, heads, d, shift, cols, per_step)
            for k, h, w, c, heads, d in geos for shift in (False, True)
            for cols, per_step in ((c, 8), *((hidden, 2) for _, hidden in mlp_hiddens(cfg, k)))]),
            ("mask attention", [(*geos[-1], shift, None, 4) for shift in (False, True)])):
        totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        tally, by, kept = _new_versus(), {}, {}
        for k, h, w, c, heads, d, shift, cols, per_step in cases:
            key = dl.keying("k4", (h, w), WINDOW, shift, heads, d, device)
            gen = torch.Generator().manual_seed(SEED + 31 * k + cols if cols else SEED + k)
            if cols:
                shape = (2, TRAIN_BATCH, h, w, cols)
                site = hd.SITE_MLP_HIDDEN if cols != c else hd.SITE_PROJ
                fns = lambda r: (functools.partial(dm.token_dropout, seed=DROP_SEED + k, site=site,
                                                   rate=r, key=key),
                                 functools.partial(dm.token_dropout_plain, seed=DROP_SEED + k,
                                                   site=site, rate=r, key=key))
                what = f"[mask tokens] stage {k} {h}x{w}x{TRAIN_BATCH} cols={cols} shift={shift}"
            else:
                n_win = (h // WINDOW[0]) * (w // WINDOW[1])
                shape = (2, TRAIN_BATCH * n_win, heads, T, T)
                fns = lambda r: (functools.partial(dm.attention_dropout, seed=DROP_SEED + k, rate=r,
                                                   key=key),
                                 functools.partial(dm.attention_dropout_plain, seed=DROP_SEED + k,
                                                   rate=r, key=key))
                what = f"[mask attention] stage {k} {h}x{w}x{TRAIN_BATCH} heads={heads} shift={shift}"
            x = torch.randn(shape, generator=gen).to(device)
            g = torch.randn(shape, generator=gen).to(device)
            for rate in DROP_CHECK_RATES:
                kn = check(what, *fns(rate), x, g, rate)
                sk, sn = kept.get(rate, (0, 0))
                kept[rate] = (sk + kn[0], sn + kn[1])
                if cols and not torch.equal(token_mask_first_form(x, DROP_SEED + k, site, rate, key),
                                            fns(rate)[1](x)):
                    raise AssertionError(f"{what} rate {rate}: the first form of the kernel differs")
            launch, plain = fns(DROP_RATIOS[0])
            bound, bound_by = mask_bound_ms(x.numel(), h * w)
            if cols:  # the wrapper; its launch in turns with the first form's by events, by events with
                # the launch queue filled ahead, and by the profiler's device time
                args = (x, DROP_SEED + k, site, DROP_RATIOS[0], key)
                new, old = lambda: dm._launch_tokens(*args), lambda: token_mask_first_form(*args)
                ms, new_ms, old_ms = _turns((lambda: launch(x), new, old), 20, 3)
                queued, old_queued = _queued_turns((new, old), 20)
                dev, old_dev = kernel_ms(new), kernel_ms(old)
                _versus(tally, f"stage {k} cols={cols} shift={shift}", 2 * per_step, bound, new_ms, old_ms,
                        queued, old_queued, dev, old_dev)
                versus = (f" (the wrapper); its launch {new_ms:.4f} ms against the first form's {old_ms:.4f} ms in "
                          f"turns, {queued:.4f} against {old_queued:.4f} ms with the launch queue filled ahead; "
                          f"device time {'not read' if dev is None else f'{dev:.4f} ms'} against "
                          f"{'not read' if old_dev is None else f'{old_dev:.4f} ms'} (profiler)")
            else:
                ms, versus = time_ms(lambda: launch(x), iters=20), ""
            plain_ms = time_ms(lambda: plain(x), iters=5)
            print(f"[time] {name} stage {k} {h}x{w}x{TRAIN_BATCH} {tuple(shape[2:])} shift={shift}: "
                  f"{ms:.4f} ms{versus}, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}), "
                  f"{2 * per_step} launches per step | {card}", flush=True)
            for key_, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound)):
                totals[key_] += 2 * per_step * v
            by[bound_by] = by.get(bound_by, 0.0) + 2 * per_step * bound
            if cols and k == len(geos) - 1 and cols == c and shift:  # the host path at the smallest map
                args = (DROP_SEED + k, site, DROP_RATIOS[0], key)
                us = host_us((lambda: dm.token_dropout(x, *args), lambda: dm._launch_tokens(x, *args),
                              lambda: token_mask_with_context(x, *args)))
                print(f"[host] mask tokens stage {k} {tuple(shape)}: {us[0]:.2f} us a call of token_dropout, its "
                      f"launch {us[1]:.2f} us (the arguments built anew, the device context and a Stream per call, "
                      f"as before: {us[2]:.2f} us); medians of 5 rounds in turns of 200 calls each, no sync "
                      f"| {card}", flush=True)
            del x, g
        for rate, (k_, n_) in kept.items():
            print(f"[check] {name} rate {rate}: keep fraction {k_ / n_:.6f} of {n_} (expected "
                  f"{1 - rate:.6f}) | {card}", flush=True)
        n = 2 * sum(case[-1] for case in cases)
        print(f"[check] {name}: bit-exact against its plain version, forward and gradient, in "
              f"{len(cases)} shapes x rates {DROP_CHECK_RATES}", flush=True)
        print(f"[time] {name} per 224x224 batch-20 dropout step under {MASK_MAIN_PATH} ({n} "
              f"launches): {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, bound "
              f"{totals['bound_ms']:.4f} ms | {card}", flush=True)
        if name == "mask tokens":
            _versus_lines(name, tally, len(cases), card)
        results[name] = dict(totals, bound_by=max(by, key=by.get), library_ms=None)
        worst[name] = 0.0
        torch.cuda.empty_cache()
    return worst, results


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}


def dropout_first_steps(flat, device, ir, vis, card):
    """The dropout main paths: the first step of the full model at 224² batch 20 under
    each configuration with every ratio DROP_RATIOS, its exact launch counts (read right
    after it), every gradient present and finite, and the same step from a second state
    with the same seeds bit-identical (loss terms and gradients; both steps under
    ``torch.use_deterministic_algorithms(True)``, so that the gradient of the gathered
    relative-position bias and the head's convolutions sum in a fixed order as the kernels
    do; the timed steps run in PyTorch's default mode). Returns the states, steps and the
    dropout and mask kernels' launches."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    states, steps, launches = {}, {}, {}
    ratios = dict(zip(("attention_drop_ratio", "linear_after_att_drop_ratio", "mlp_drop_ratio"),
                      DROP_RATIOS))
    for impl, per_step in TRAIN_DROP_CONFIGS.items():
        cfg = Config(model=ModelConfig(attention_impl=impl, **ratios))
        label = f"{impl} drop"
        steps[label] = make_train_step(cfg)
        runs = []
        for repeat in range(2):
            state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
            torch.cuda.synchronize()
            reset_counts()
            torch.use_deterministic_algorithms(True)  # an op without a deterministic form raises
            try:
                terms = steps[label](state, ir, vis)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            if repeat == 0:
                got = {**read_counts(impl), **read_mask_counts()}
                expected = {name: 0 for name in got}
                expected.update(per_step)
                expected.update(TRAIN_DROP_MASKS[impl])
                print(f"[train] dropout {impl} first step: launches {got}", flush=True)
                if got != expected:
                    raise AssertionError(f"{impl} dropout train step: launches {got}, expected {expected}")
                launches.update({n: c for n, c in got.items() if DROP_MAIN_PATH.get(n) == impl})
                if impl == MASK_MAIN_PATH:  # one kernel each, forward and on the gradient
                    for name in ("mask tokens", "mask attention"):
                        launches[name] = got[name] + got[f"{name} bwd"]
                states[label] = state
            grads = _grads(state.model)
            missing = [n for n, p in state.model.named_parameters()
                       if n not in grads or not torch.isfinite(grads[n]).all()]
            if missing:
                raise AssertionError(f"{impl} dropout: gradients missing or not finite: {missing}")
            runs.append(({k: v.item() for k, v in terms.items()}, grads))
        (terms_a, grads_a), (terms_b, grads_b) = runs
        same = terms_a == terms_b and all(torch.equal(grads_a[n], grads_b[n]) for n in grads_a)
        differ = [n for n in grads_a if not torch.equal(grads_a[n], grads_b[n])]
        print(f"[train] dropout {impl} first step: " + ", ".join(f"{k} {v:.7g}" for k, v in terms_a.items())
              + f"; all {len(grads_a)} parameter gradients present and finite; the same step "
              f"repeated from a second state: bit-identical {same}", flush=True)
        if not same:
            raise AssertionError(f"{impl} dropout step repeated differs: terms {terms_a} vs "
                                 f"{terms_b}, gradients {differ}")
        del runs, grads_a, grads_b
        torch.cuda.empty_cache()
    return states, steps, launches


def dropout_parity(flat, card):
    """One dropout train step of the full-width model at 112² batch 2 under each
    configuration on the card against the same configuration on the CPU (the plain
    versions) with the same block seeds: the hash masks make the two the same function.
    Loss terms to 1e-5 relative, every gradient by ``testing.assert_grads_close``."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED + 5)
    ir, vis = (torch.from_numpy(rng.random((PARITY_BATCH, *PARITY_HW, 1), dtype=np.float32))
               for _ in range(2))
    seeds = [(2_654_435_761 * (i + 1)) % (1 << 24) for i in range(40)]
    ratios = dict(zip(("attention_drop_ratio", "linear_after_att_drop_ratio", "mlp_drop_ratio"),
                      DROP_RATIOS))
    for impl in TRAIN_DROP_CONFIGS:
        cfg = Config(model=ModelConfig(attention_impl=impl, **ratios))
        out = {}
        for device in (DEVICE, "cpu"):
            t = time.perf_counter()
            state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
            terms = make_train_step(cfg)(state, ir.to(device), vis.to(device), seeds=seeds)
            out[device] = ({k: v.item() for k, v in terms.items()},
                           {n: g.cpu() for n, g in _grads(state.model).items()})
            print(f"[parity] dropout {impl} step at {PARITY_HW[0]}x{PARITY_HW[1]} bs={PARITY_BATCH} "
                  f"on {device}: {time.perf_counter() - t:.1f} s", flush=True)
            del state
        (terms, grads), (ref_terms, ref_grads) = out[DEVICE], out["cpu"]
        rel = max(abs(terms[k] - ref_terms[k]) / max(abs(ref_terms[k]), 1e-30) for k in terms)
        if rel > 1e-5 or set(grads) != set(ref_grads):
            raise AssertionError(f"dropout {impl}: card {terms} vs CPU {ref_terms}")
        check = assert_grads_close([grads[n] for n in ref_grads], list(ref_grads.values()),
                                   list(ref_grads), f"dropout {impl} card vs CPU")
        print(f"[parity] dropout {impl} train step, card vs CPU with the same seeds: loss terms "
              f"max relative difference {rel:.3e}, gradients max_abs_err {check.worst:.3e} "
              f"({check.worst_own:.3e} of a gradient's own largest, {len(ref_grads)} gradients) "
              f"| {card}", flush=True)
        torch.cuda.empty_cache()


# ---- bf16 training: the bf16 backward forms and the bf16 dropout forms ------------------
# attention_impl -> the bf16 step's launches at 224² (as in fp32, every form in bf16)
TRAIN_BF16_CONFIGS = {
    "cuda_pack": {"K1 bf16": 32, "K1 bwd bf16": 32, "K2 bf16": 24, "K2 bwd bf16": 24},
    "cuda": {"K3 bf16": 32, "K3 bwd bf16": 32},
    "cuda_block": {"K4 bf16": 32, "K4 bwd bf16": 32},
}
TRAIN_BF16_DROP_CONFIGS = {
    "cuda_pack": {"K1 drop bf16": 32, "K1 drop bwd bf16": 32, "K2 bf16": 24, "K2 bwd bf16": 24},
    "cuda": {"K3 drop bf16": 32, "K3 drop bwd bf16": 32},
    "cuda_block": {"K4 drop bf16": 32, "K4 drop bwd bf16": 32},
}
# the composition's token sites are bf16 in a bf16 step; its attention weights stay fp32
# (the softmax is fp32), so their masks are the fp32 kernel's
TRAIN_BF16_DROP_MASKS = {
    impl: {"mask tokens bf16": masks["mask tokens"], "mask tokens bwd bf16": masks["mask tokens bwd"],
           "mask attention": masks["mask attention"], "mask attention bwd": masks["mask attention bwd"]}
    for impl, masks in TRAIN_DROP_MASKS.items()}
BF16_MAIN_PATH = {**{name: impl for impl, per in TRAIN_BF16_CONFIGS.items() for name in per
                     if "bwd" in name},
                  **{name: impl for impl, per in TRAIN_BF16_DROP_CONFIGS.items() for name in per
                     if "drop" in name}}


def _check_bf16_grads(got, ref, names, what):
    """A bf16 backward kernel's outputs against its plain version's: g_x (bf16) by the
    bf16 kernel criteria of :func:`compare_kernel`, every weight gradient (fp32) by
    ``testing.assert_grads_close``. Returns the worst absolute error."""
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    if got[0].dtype != BF16 or any(g.dtype != torch.float32 for g in got[1:]):
        raise AssertionError(f"{what}: g_x {got[0].dtype}, weight gradients "
                             f"{sorted({str(g.dtype) for g in got[1:]})}")
    err, _ = compare_kernel(got[0], ref[0], what + " g_x")
    check = assert_grads_close(got[1:], ref[1:], names[1:], what)
    return max(err, check.worst)


def _keep_masks_match(got, fp32, names, cross, what):
    """The keep masks of a bf16 dropout form against the fp32 form's: its backward is the
    fp32 backward at the upcast inputs, the same kernels in the same order, so every
    weight gradient must equal the fp32 dropout kernel's bit for bit (a mask that differs in
    one element moves some sum), but for the LN1 scale and bias under cross, which sum the
    q side and the k/v side in another order (JAX rounds the two sides of g_x apart).
    Returns the share of all weight-gradient elements equal bit for bit."""
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    same = sum((a == b).sum().item() for a, b in zip(got[1:], fp32[1:]))
    share = same / sum(a.numel() for a in got[1:])
    print(f"{what} bwd against the fp32 dropout form at the upcast inputs: {share:.4%} of the "
          f"weight-gradient elements equal bit for bit", flush=True)
    apart = ("ln1_scale", "ln1_bias") if cross else ()
    differ = [n for n, a, b in zip(names[1:], got[1:], fp32[1:]) if n not in apart and not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"{what}: the bf16 dropout form's gradients of {differ} differ from "
                             f"the fp32 form's at the upcast inputs: its keep masks are not the same")
    assert_grads_close(got[1:], fp32[1:], names[1:], what + " vs fp32")
    return share


def _new_totals():
    return dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, fp32_ms=0.0)


def _add(totals, by, ms, plain_ms, bound, bound_by, fp32_ms, times=1):
    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("fp32_ms", fp32_ms)):
        totals[key] += times * v
    by[bound_by] = by.get(bound_by, 0.0) + times * bound


def _summary(name, totals, by, launches, card, results):
    t = totals
    print(f"[time] {name} per 224x224 batch-20 step ({launches} launches): {t['ms']:.3f} ms, fp32 "
          f"form {t['fp32_ms']:.3f} ms ({t['ms'] / t['fp32_ms'] - 1:+.1%}, in turns), plain "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms | {card}", flush=True)
    results[name] = dict(t, bound_by=max(by, key=by.get), library_ms=None)


def check_bf16_blocks(cfg, device, card):
    """The bf16 forms of K1 (windows layout, packed stages) and K4 (image layout) at every
    stage 0-3 x role x shift x cross block of a 224² batch-20 step: the backward without
    dropout and with every site at each rate of DROP_CHECK_RATES, and the dropout forward,
    against their plain bf16 versions (the fp32 backward at the upcast inputs, g_x rounded
    as JAX rounds it); the keep masks against the fp32 dropout form's
    (:func:`_keep_masks_match`); every backward on the route ``block_bwd_plan`` names (with
    dropout its dropout form) and repeated bit for bit; then each form timed in turns with its
    fp32 form, the dropout backward also with the twenty-launch bf16 dropout backward.
    Returns the worst errors and per-step times."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    names = ("x", *tfb.WEIGHT_NAMES)
    worst, results = {}, {}
    for name, layout in (("K1", "windows"), ("K4", "image")):
        forms = (" bwd bf16", " drop bf16", " drop bwd bf16")
        totals, by = {f: _new_totals() for f in forms}, {f: {} for f in forms}
        errs, bits, cases = dict.fromkeys(forms, 0.0), 1.0, 0
        for case, x, weights in block_cases(cfg, device, True, TRAIN_HW, TRAIN_BATCH):
            cases += 1
            xl, kw = fused_args(case, x.to(BF16), layout)
            k, h, w, c, heads, d, role, hidden, shift, cross = case
            g = torch.randn(xl.shape, generator=torch.Generator().manual_seed(k + 11)).to(device, BF16)
            seed = DROP_SEED + 100 * k + 10 * shift + cross + 2
            for drop in (False, True):
                route = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, drop).route
                if route != ("fused" if k < 2 else "split"):
                    raise AssertionError(f"{name} bwd bf16 stage {k} {role} dropout {drop}: the plan routes "
                                         f"{route!r}")
            label = (f"stage {k} {role} {h}x{w}x{TRAIN_BATCH} C={c} hidden={hidden} ({route}) shift={shift} "
                     f"cross={cross}")
            for rate in (0.0, *DROP_CHECK_RATES):
                dkw = dict(kw, drop_rates=(rate,) * 3, drop_seed=seed) if rate else kw
                what = f"[{name.lower()} bf16] {label} rate {rate}"
                if rate:
                    out, again = tfb.fused_block(xl, *weights, **dkw), tfb.fused_block(xl, *weights, **dkw)
                    torch.cuda.synchronize()
                    err, _ = compare_kernel(out, tfb.fused_block_plain(xl, *weights, **dkw), what)
                    if not torch.equal(out, again):
                        raise AssertionError(f"{what}: a repeat of the dropout forward gave other bits")
                    errs[" drop bf16"] = max(errs[" drop bf16"], err)
                    del out, again
                got = tfb._launch_bwd(g, xl, weights, dkw)
                # the fused route at stages 0-1, the split route at 2-3, each in its dropout form
                # at a rate
                again = tfb._launch_bwd(g, xl, weights, dkw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what} bwd: a repeat gave other bits")
                del again
                torch.cuda.synchronize()
                err = _check_bf16_grads(got, tfb.fused_block_bwd_plain(g, xl, *weights, **dkw), names,
                                        what + " bwd")
                form = " drop bwd bf16" if rate else " bwd bf16"
                errs[form] = max(errs[form], err)
                if rate == DROP_CHECK_RATES[-1]:  # the keep masks of the fp32 dropout form
                    fp32 = tfb._launch_bwd(g.float(), xl.float(), weights, dkw)
                    bits = min(bits, _keep_masks_match(got, fp32, names, cross, what))
                    del fp32
                del got
            dkw = dict(kw, drop_rates=DROP_RATIOS, drop_seed=seed)
            x32, g32 = xl.float(), g.float()
            for form, launch, launch32, plain, iters in (
                    (" bwd bf16", lambda: tfb._launch_bwd(g, xl, weights, kw),
                     lambda: tfb._launch_bwd(g32, x32, weights, kw),
                     lambda: tfb.fused_block_bwd_plain(g, xl, *weights, **kw), 3),
                    (" drop bf16", lambda: tfb.fused_block(xl, *weights, **dkw),
                     lambda: tfb.fused_block(x32, *weights, **dkw),
                     lambda: tfb.fused_block_plain(xl, *weights, **dkw), 5),
                    (" drop bwd bf16", lambda: tfb._launch_bwd(g, xl, weights, dkw),
                     lambda: tfb._launch_bwd(g32, x32, weights, dkw),
                     lambda: tfb.fused_block_bwd_plain(g, xl, *weights, **dkw), 3)):
                twenty = ""
                if form == " drop bwd bf16":  # also in turns with the twenty launches
                    fp32_ms, ms, five = _in_turns(launch32, launch, iters, 1,
                                                  lambda: tfb._launch_bwd_five(g, xl, weights, dkw))
                    twenty = f", twenty launches {five:.4f} ms ({ms / five - 1:+.1%})"
                    totals[form]["five_ms"] = totals[form].get("five_ms", 0.0) + five
                elif form == " drop bf16":  # also with the five launches and the form without dropout
                    fp32_ms, ms, five, nodrop = _turns(
                        (launch32, launch, lambda: tfb._launch_five(xl, weights, dkw),
                         lambda: tfb.fused_block(xl, *weights, **kw)), iters, 1)
                    twenty = (f", five launches {five:.4f} ms ({ms / five - 1:+.1%}), without dropout "
                              f"{nodrop:.4f} ms ({ms / nodrop - 1:+.1%})")
                    totals[form]["five_ms"] = totals[form].get("five_ms", 0.0) + five
                    totals[form]["nodrop_ms"] = totals[form].get("nodrop_ms", 0.0) + nodrop
                else:
                    fp32_ms, ms = _in_turns(launch32, launch, iters, 1)
                plain_ms = time_ms(plain, iters=1, warmup=1)
                backward = "bwd" in form
                ops = hash_ops(h, w, c, heads, hidden, TRAIN_BATCH, False) if "drop" in form else 0
                bound, bound_by = block_bound_ms(h, w, c, heads, d, hidden, TRAIN_BATCH, backward=backward,
                                                 dtype=BF16, layout=layout, int_ops=ops)
                print(f"[time] {name}{form} {label}: {ms:.4f} ms, fp32 form {fp32_ms:.4f} ms (in turns, "
                      f"{ms / fp32_ms - 1:+.1%}){twenty}, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
                      f"({bound_by}) | {card}", flush=True)
                _add(totals[form], by[form], ms, plain_ms, bound, bound_by, fp32_ms)
            del x32, g32
            torch.cuda.empty_cache()
        for form in forms:
            print(f"[check] {name}{form}: worst max_abs_err {errs[form]:.3e} over {cases} blocks"
                  + (f" x rates {DROP_CHECK_RATES}" if "drop" in form else "")
                  + ("; every case repeated bit for bit" if "bwd" in form else ""), flush=True)
            if "five_ms" in totals[form]:
                t = totals[form]
                nodrop = (f", without dropout {t['nodrop_ms']:.3f} ms ({t['ms'] / t['nodrop_ms'] - 1:+.1%})"
                          if "nodrop_ms" in t else "")
                print(f"[time] {name}{form} per 224x224 batch-20 step: {t['ms']:.3f} ms, "
                      f"{'twenty' if 'bwd' in form else 'five'} launches {t['five_ms']:.3f} ms "
                      f"({t['ms'] / t['five_ms'] - 1:+.1%}, in turns){nodrop}, {t['ms'] / t['bound_ms']:.1f}x the "
                      f"bound | {card}", flush=True)
            _summary(f"{name}{form}", totals[form], by[form], cases, card, results)
            worst[f"{name}{form}"] = errs[form]
        print(f"[check] {name} drop bf16: the keep masks are the fp32 form's: at rate "
              f"{DROP_CHECK_RATES[-1]} the bf16 backward's weight gradients equal the fp32 dropout "
              f"kernel's at the upcast inputs bit for bit, but LN1's under cross (at least "
              f"{bits:.4%} of all the elements)", flush=True)
    return worst, results


def check_bf16_attention(cfg, device, card):
    """The bf16 forms of K3 at stages 0-3 of a 224² batch-20 step, every shift x cross
    variant (each runs twice per step, encoder and decoder): the backward without dropout
    (``csrc/window_attention_bwd.cu``, repeated bit for bit) and with the attention site at
    each rate of DROP_CHECK_RATES, and the dropout forward (``csrc/window_attention_fwd.cu``'s
    dropout form, repeated bit for bit), against their plain bf16 versions; the keep masks
    against the fp32 dropout form's; each form timed in turns with its fp32 form, the backward
    without dropout also with the three-launch backward, the dropout forms also with the three
    launches and the bf16 form without dropout, per case, stage and step."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    names = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
    forms = (" bwd bf16", " drop bf16", " drop bwd bf16")
    totals, by = {f: _new_totals() for f in forms}, {f: {} for f in forms}
    errs, bits, cases = dict.fromkeys(forms, 0.0), 1.0, 0
    worst, results = {}, {}
    three = [0.0, 0.0]  # the bf16 backward per step: three-launch, new (in turns)
    stage_ms = {}  # stage -> K3 drop bf16 (dropout form, three launches, without dropout) per step
    for k, h, w, c, heads, d in stage_geometries(cfg, TRAIN_HW)[:4]:
        x, *weights = attention_inputs(h, w, c, heads, d, SEED + k, device, TRAIN_BATCH)
        x = x.to(BF16)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(k + 13)).to(device, BF16)
        x32, g32 = x.float(), g.float()
        for shift in (False, True):
            for cross in (False, True):
                cases += 1
                kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                seed = DROP_SEED + 100 * k + 10 * shift + cross + 3
                label = f"stage {k} {h}x{w}x{TRAIN_BATCH} C={c} shift={shift} cross={cross}"
                for rate in (0.0, *DROP_CHECK_RATES):
                    dkw = dict(kw, attn_drop_rate=rate, drop_seed=seed) if rate else kw
                    what = f"[k3 bf16] {label} rate {rate}"
                    if rate:
                        route = twa.fwd_plan(c, heads, d, WINDOW, cross, True, True).route
                        if route != ("fused" if k < 2 else "split"):
                            raise AssertionError(f"K3 drop bf16 stage {k}: the plan routes {route!r}")
                        out, again = twa.window_attention(x, *weights, **dkw), twa.window_attention(x, *weights, **dkw)
                        torch.cuda.synchronize()
                        err, _ = compare_kernel(out, twa.window_attention_plain(x, *weights, **dkw),
                                                f"{what} ({route})")
                        if not torch.equal(out, again):
                            raise AssertionError(f"{what} ({route}): a repeat gave other bits")
                        errs[" drop bf16"] = max(errs[" drop bf16"], err)
                        del out, again
                    got = twa._launch_bwd(g, x, weights, dkw)
                    again = twa._launch_bwd(g, x, weights, dkw)
                    torch.cuda.synchronize()
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(f"{what} bwd: a repeat gave other bits")
                    del again
                    err = _check_bf16_grads(got, twa.window_attention_bwd_plain(g, x, *weights, **dkw),
                                            names, what + " bwd")
                    form = " drop bwd bf16" if rate else " bwd bf16"
                    errs[form] = max(errs[form], err)
                    if rate == DROP_CHECK_RATES[-1]:
                        fp32 = twa._launch_bwd(g32, x32, weights, dkw)
                        bits = min(bits, _keep_masks_match(got, fp32, names, False, what))
                    del got
                dkw = dict(kw, attn_drop_rate=DROP_RATIOS[0], drop_seed=seed)
                for form, launch, launch32, plain, iters in (
                        (" bwd bf16", lambda: twa._launch_bwd(g, x, weights, kw),
                         lambda: twa._launch_bwd(g32, x32, weights, kw),
                         lambda: twa.window_attention_bwd_plain(g, x, *weights, **kw), 3),
                        (" drop bf16", lambda: twa.window_attention(x, *weights, **dkw),
                         lambda: twa.window_attention(x32, *weights, **dkw),
                         lambda: twa.window_attention_plain(x, *weights, **dkw), 5),
                        (" drop bwd bf16", lambda: twa._launch_bwd(g, x, weights, dkw),
                         lambda: twa._launch_bwd(g32, x32, weights, dkw),
                         lambda: twa.window_attention_bwd_plain(g, x, *weights, **dkw), 3)):
                    extra = ""
                    if "drop" in form:  # also with the three launches and the form without dropout
                        old, nodrop_fn = ((lambda: twa._launch_bwd_three(g, x, weights, dkw),
                                           lambda: twa._launch_bwd(g, x, weights, kw)) if "bwd" in form else
                                          (lambda: twa._launch_three(x, weights, dkw),
                                           lambda: twa.window_attention(x, *weights, **kw)))
                        fp32_ms, ms, old_ms, nodrop = _turns((launch32, launch, old, nodrop_fn), iters, 1)
                        extra = (f", three launches {old_ms:.4f} ms ({ms / old_ms - 1:+.1%}), without dropout "
                                 f"{nodrop:.4f} ms ({ms / nodrop - 1:+.1%})")
                        for key_, v in (("old_ms", old_ms), ("nodrop_ms", nodrop)):
                            totals[form][key_] = totals[form].get(key_, 0.0) + 2 * v
                        if form == " drop bf16":
                            st = stage_ms.setdefault(k, [0.0, 0.0, 0.0])
                            st[0], st[1], st[2] = st[0] + 2 * ms, st[1] + 2 * old_ms, st[2] + 2 * nodrop
                    else:
                        fp32_ms, ms = _in_turns(launch32, launch, iters, 1)
                    plain_ms = time_ms(plain, iters=1, warmup=1)
                    if form == " bwd bf16":  # the three-launch backward, in turns with the new one
                        three_ms, new_ms = _in_turns(lambda: twa._launch_bwd_three(g, x, weights, kw), launch,
                                                     iters, 1)
                        three[0] += 2 * three_ms
                        three[1] += 2 * new_ms
                        print(f"[time] K3 bwd bf16 {label}: {new_ms:.4f} ms, three-launch {three_ms:.4f} ms "
                              f"(in turns) | {card}", flush=True)
                    backward = "bwd" in form
                    ops = hash_ops(h, w, c, heads, 0, TRAIN_BATCH, True) if "drop" in form else 0
                    bound, bound_by = attention_bound_ms(h, w, c, heads, d, TRAIN_BATCH, backward=backward,
                                                         dtype=BF16, int_ops=ops)
                    print(f"[time] K3{form} {label}: {ms:.4f} ms, fp32 form {fp32_ms:.4f} ms (in "
                          f"turns, {ms / fp32_ms - 1:+.1%}){extra}, plain {plain_ms:.4f} ms, bound "
                          f"{bound:.4f} ms ({bound_by}) | {card}", flush=True)
                    _add(totals[form], by[form], ms, plain_ms, bound, bound_by, fp32_ms, times=2)
        del x, g, x32, g32
        torch.cuda.empty_cache()
    for k, (ms, old_ms, nodrop) in sorted(stage_ms.items()):
        print(f"[time] K3 drop bf16 stage {k} per 224x224 batch-20 step (8 calls, {'fused' if k < 2 else 'split'} "
              f"route): {ms:.3f} ms, three launches {old_ms:.3f} ms ({ms / old_ms - 1:+.1%}), without dropout "
              f"{nodrop:.3f} ms ({ms / nodrop - 1:+.1%}), in turns | {card}", flush=True)
    for form in forms:
        print(f"[check] K3{form}: worst max_abs_err {errs[form]:.3e} over {cases} shapes"
              + (f" x rates {DROP_CHECK_RATES}" if "drop" in form else "")
              + "; every case repeated bit for bit", flush=True)
        if "old_ms" in totals[form]:
            t = totals[form]
            print(f"[time] K3{form} per 224x224 batch-20 step: {t['ms']:.3f} ms, three launches {t['old_ms']:.3f} ms "
                  f"({t['ms'] / t['old_ms'] - 1:+.1%}), without dropout {t['nodrop_ms']:.3f} ms "
                  f"({t['ms'] / t['nodrop_ms'] - 1:+.1%}), in turns | {card}", flush=True)
        _summary(f"K3{form}", totals[form], by[form], 2 * cases, card, results)
        worst[f"K3{form}"] = errs[form]
    print(f"[time] K3 bwd bf16 per 224x224 batch-20 step ({2 * cases} launches): new {three[1]:.3f} ms, "
          f"three-launch {three[0]:.3f} ms (in turns) | {card}", flush=True)
    print(f"[check] K3 drop bf16: the keep masks are the fp32 form's: at rate "
          f"{DROP_CHECK_RATES[-1]} the bf16 backward's weight gradients equal the fp32 dropout "
          f"kernel's at the upcast inputs bit for bit ({bits:.4%} of the elements)", flush=True)
    return worst, results


def check_bf16_repartition(cfg, device, card):
    """K2 bwd on bf16 gradients bit-exact against the plain inverse permutation and the
    library call at the packed maps of a 224² batch-20 step, timed in turns with fp32."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp

    totals, by = dict(_new_totals(), library_ms=0.0), {}
    step = []  # (launches per step, kernel call, library call)
    for k, h, w, c, to_shift, g, perm in repartition_cases(cfg, device, TRAIN_HW, TRAIN_BATCH, BF16):
        fwd = (h, w), WINDOW, not to_shift, to_shift
        got = twp._launch(g, (h, w), WINDOW, to_shift, not to_shift)
        torch.cuda.synchronize()
        ref = twp.repartition_windows_bwd_plain(g, *fwd)
        if (got.dtype != BF16 or not torch.equal(got, ref)
                or not torch.equal(repartition_library(g, perm), ref)):
            raise AssertionError(f"K2 bwd bf16 at stage {k} is not bit-exact")
        g32 = g.float()
        fp32_ms, ms = _in_turns(lambda: twp._launch(g32, (h, w), WINDOW, to_shift, not to_shift),
                                lambda: twp._launch(g, (h, w), WINDOW, to_shift, not to_shift), 50, 3)
        plain = time_ms(lambda: twp.repartition_windows_bwd_plain(g, *fwd), iters=10)
        library = time_ms(lambda: repartition_library(g, perm), iters=50)
        bound, _ = repartition_bound_ms(h, w, c, TRAIN_BATCH, BF16)
        print(f"[time] K2 bwd bf16 stage {k} {h}x{w}x{TRAIN_BATCH} C={c} shift {to_shift} -> "
              f"{not to_shift}: bit-exact, {ms:.4f} ms, fp32 {fp32_ms:.4f} ms (in turns), plain "
              f"{plain:.4f} ms, index_select {library:.4f} ms, bound {bound:.4f} ms (bytes) | {card}",
              flush=True)
        times = 4 if to_shift else 2
        _add(totals, by, ms, plain, bound, "bytes", fp32_ms, times)
        totals["library_ms"] += times * library
        step.append((times, functools.partial(twp._launch, g, (h, w), WINDOW, to_shift, not to_shift),
                     functools.partial(repartition_library, g, perm)))
    print("[check] K2 bwd bf16: bit-exact at every packed map, both directions", flush=True)
    dev, lib_dev = _repartition_device_ms(step)
    print(f"[time] K2 bwd bf16 per 224x224 batch-20 step (24 launches): {dev} of device time "
          f"(profiler), index_select {lib_dev} of device time (profiler) | {card}", flush=True)
    results = {}
    _summary("K2 bwd bf16", totals, by, 24, card, results)
    results["K2 bwd bf16"]["library_ms"] = totals["library_ms"]
    return {"K2 bwd bf16": 0.0}, results


def check_bf16_masks(cfg, device, card):
    """The composition's mask kernels on bf16 tensors against their plain versions, forward
    and on a gradient, bit for bit, at the token sites of the 224² batch-20 bf16 dropout
    step under cuda (and the attention weights' bf16 form, which no bf16 step takes: the
    composition's softmax is fp32), with the elements kept equal to the fp32 masks' and the
    first form's (a thread an element); the token masks timed in turns with their fp32 form
    and their first form, by CUDA events with the launch queue filled ahead, and by the
    profiler's device time beside the first form's."""
    from swin_unet_image_fusion_tpu_torch.ops import dropout_layout as dl
    from swin_unet_image_fusion_tpu_torch.ops import dropout_mask as dm
    from swin_unet_image_fusion_tpu_torch.ops import hash_dropout as hd

    geos = stage_geometries(cfg, TRAIN_HW)
    totals, by, cases = _new_totals(), {}, 0
    tally = _new_versus()
    for k, h, w, c, heads, d in geos:
        for shift in (False, True):
            key = dl.keying("k4", (h, w), WINDOW, shift, heads, d, device)
            for cols, per_step in ((c, 8), *((hidden, 2) for _, hidden in mlp_hiddens(cfg, k))):
                cases += 1
                site = hd.SITE_MLP_HIDDEN if cols != c else hd.SITE_PROJ
                gen = torch.Generator().manual_seed(SEED + 37 * k + cols)
                x = torch.randn((2, TRAIN_BATCH, h, w, cols), generator=gen).to(device, BF16)
                g = torch.randn(x.shape, generator=gen).to(device, BF16)
                for rate in DROP_CHECK_RATES:
                    fn = functools.partial(dm.token_dropout, seed=DROP_SEED + k, site=site, rate=rate, key=key)
                    plain = functools.partial(dm.token_dropout_plain, seed=DROP_SEED + k, site=site,
                                              rate=rate, key=key)
                    xg = x.detach().requires_grad_()
                    out = fn(xg)
                    (got,) = torch.autograd.grad(out, xg, g)
                    xr = x.detach().requires_grad_()
                    ref = plain(xr)
                    (ref_g,) = torch.autograd.grad(ref, xr, g)
                    fp32 = fn(x.float())
                    first = token_mask_first_form(x, DROP_SEED + k, site, rate, key)
                    same = (out.dtype == BF16 and torch.equal(out, ref) and torch.equal(got, ref_g)
                            and torch.equal(out, fp32.to(BF16)) and torch.equal(first, ref))
                    if not same:
                        raise AssertionError(f"[mask tokens bf16] stage {k} cols={cols} shift={shift} "
                                             f"rate {rate}: differs from its plain version or the fp32 mask")
                fn = functools.partial(dm._launch_tokens, seed=DROP_SEED + k, site=site,
                                       rate=DROP_RATIOS[1], key=key)
                old = functools.partial(token_mask_first_form, seed=DROP_SEED + k, site=site,
                                        rate=DROP_RATIOS[1], key=key)
                x32 = x.float()
                fp32_ms, ms, old_ms = _in_turns(lambda: fn(x32), lambda: fn(x), 20, 3, other=lambda: old(x))
                queued, old_queued = _queued_turns((lambda: fn(x), lambda: old(x)), 20)
                dev, old_dev = kernel_ms(lambda: fn(x)), kernel_ms(lambda: old(x))
                plain_ms = time_ms(lambda: dm.token_dropout_plain(x, DROP_SEED + k, site, DROP_RATIOS[1],
                                                                  key), iters=3)
                bound, bound_by = mask_bound_ms(x.numel(), h * w, elem_bytes=2)
                _versus(tally, f"stage {k} cols={cols} shift={shift}", 2 * per_step, bound, ms, old_ms, queued,
                        old_queued, dev, old_dev)
                print(f"[time] mask tokens bf16 stage {k} {h}x{w}x{TRAIN_BATCH} cols={cols} "
                      f"shift={shift}: bit-exact, {ms:.4f} ms, fp32 {fp32_ms:.4f} ms and the first form "
                      f"{old_ms:.4f} ms (in turns); with the launch queue filled ahead {queued:.4f} ms against "
                      f"the first form's {old_queued:.4f} ms; device time "
                      f"{'not read' if dev is None else f'{dev:.4f} ms'} against the first form's "
                      f"{'not read' if old_dev is None else f'{old_dev:.4f} ms'} (profiler); plain "
                      f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}), {2 * per_step} launches per step "
                      f"| {card}", flush=True)
                _add(totals, by, ms, plain_ms, bound, bound_by, fp32_ms, 2 * per_step)
                del x, g
        torch.cuda.empty_cache()
    k, h, w, c, heads, d = geos[-1]
    for shift in (False, True):
        key = dl.keying("k4", (h, w), WINDOW, shift, heads, d, device)
        n_win = (h // WINDOW[0]) * (w // WINDOW[1])
        x = torch.rand((2, TRAIN_BATCH * n_win, heads, T, T), generator=torch.Generator().manual_seed(k))
        x = x.to(device, BF16)
        for rate in DROP_CHECK_RATES:
            out = dm.attention_dropout(x, DROP_SEED + k, rate, key)
            if not torch.equal(out, dm.attention_dropout_plain(x, DROP_SEED + k, rate, key)):
                raise AssertionError(f"[mask attention bf16] stage {k} shift={shift} rate {rate} differs")
    print(f"[check] mask tokens bf16: bit-exact against its plain version, forward and gradient, "
          f"keeping the fp32 mask's elements, in {cases} shapes x rates {DROP_CHECK_RATES}; the "
          f"attention weights' bf16 form bit-exact at stage 4", flush=True)
    _versus_lines("mask tokens bf16", tally, cases, card)
    results = {}
    _summary("mask tokens bf16", totals, by, 2 * TRAIN_DROP_MASKS["cuda"]["mask tokens"], card, results)
    return {"mask tokens bf16": 0.0}, results


def _first_bf16_step(cfg, flat, device, ir, vis, impl, counts, masks=None, repeat=False):
    """The first step of a fresh train state: its exact launches (``counts``, and with
    ``masks`` the mask kernels'), every fp32 gradient present and finite; with ``repeat``
    the step twice from fresh states under deterministic algorithms, bit-identical.
    Returns the state, the step, its terms and gradients, and its launches."""
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    step = make_train_step(cfg)
    runs = []
    for run in range(2 if repeat else 1):
        state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
        torch.cuda.synchronize()
        reset_counts()
        torch.use_deterministic_algorithms(repeat)  # an op without a deterministic form raises
        try:
            terms = step(state, ir, vis)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        got = read_counts(impl) if impl != "torch" else {}
        if masks is not None:
            got.update(read_mask_counts())
        expected = dict.fromkeys(got, 0)
        expected.update(counts)
        expected.update(masks or {})
        if got != expected:
            raise AssertionError(f"bf16 {impl} train step: launches {got}, expected {expected}")
        grads = _grads(state.model)
        bad = [n for n, p in state.model.named_parameters()
               if n not in grads or grads[n].dtype != torch.float32 or not torch.isfinite(grads[n]).all()]
        if bad:
            raise AssertionError(f"bf16 {impl}: gradients missing, not fp32 or not finite: {bad}")
        runs.append(({k: v.item() for k, v in terms.items()}, grads))
    if repeat:
        (ta, ga), (tb, gb) = runs
        differ = [n for n in ga if not torch.equal(ga[n], gb[n])]
        if ta != tb or differ:
            raise AssertionError(f"bf16 {impl} step repeated differs: {ta} vs {tb}, gradients {differ}")
    return state, step, runs[0][0], runs[0][1], got


def step_spread(a, b):
    """How far step ``a`` (terms, gradients) is from step ``b``: the largest relative
    loss-term difference, the largest gradient error relative to its tensor's largest
    magnitude (the step's largest for a gradient that is exactly 0 by construction), and
    the share of gradient elements off by more than 3e-2 of it (the numbers of
    ``tests/test_torch_bf16_train.py``)."""
    from swin_unet_image_fusion_tpu_torch.testing import exact_zero

    (terms_a, grads_a), (terms_b, grads_b) = a, b
    terms = max(abs(terms_a[k] - v) / max(abs(v), 1e-12) for k, v in terms_b.items())
    call = max(g.abs().max().item() for g in grads_b.values())
    worst, far, total = 0.0, 0, 0
    for name, ref in grads_b.items():
        scale = call if exact_zero(name) else max(ref.abs().max().item(), 1e-30)
        err = (grads_a[name] - ref).abs() / scale
        worst = max(worst, err.max().item())
        far += (err > 3e-2).sum().item()
        total += ref.numel()
    return terms, worst, far / total


def bf16_train(flat, device, card, states, steps, inputs, fp32_first):
    """bf16 training, the main paths of this slice: the first bf16 step of the full model
    at 224² batch 20 under the torch composition and each kernel configuration, with exact
    launch counts; each kernel configuration's held against the bf16 composition's and
    against the fp32 composition's first step at the same weights: as close to the fp32
    step, in each number of :func:`step_spread`, as twice the bf16 composition is, and to
    the bf16 composition as three times that (the triangle); then TRAIN_STEPS bf16 steps
    in turns with the fp32 steps, peak memory, and one profiled bf16 step each. Then the
    bf16 dropout step (every ratio 0.1) per configuration with exact launch counts (the
    dropout forms and the mask kernels), repeated bit for bit under deterministic
    algorithms. Returns the bf16 backward and dropout kernels' launches."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig

    ir, vis = inputs
    launches, first, bf16_states, bf16_steps = {}, {}, {}, {}
    for impl in ("torch", *TRAIN_BF16_CONFIGS):
        t = time.perf_counter()
        cfg = Config(model=ModelConfig(attention_impl=impl, compute_dtype="bfloat16"))
        state, step, terms, grads, got = _first_bf16_step(cfg, flat, device, ir, vis, impl,
                                                           TRAIN_BF16_CONFIGS.get(impl, {}))
        bf16_states[impl], bf16_steps[impl], first[impl] = state, step, (terms, grads)
        launches.update({n: c for n, c in got.items() if BF16_MAIN_PATH.get(n) == impl and "drop" not in n})
        print(f"[train] bf16 {impl} first step ({time.perf_counter() - t:.1f} s): launches "
              f"{ {n: c for n, c in got.items() if c} }; " + ", ".join(f"{k} {v:.7g}" for k, v in terms.items())
              + f"; all {len(grads)} parameter gradients present, fp32 and finite", flush=True)
    base = step_spread(first["torch"], fp32_first)
    print(f"[parity] bf16 torch composition step 1 vs the fp32 composition's: loss terms "
          f"{base[0]:.3e} relative, gradients worst {base[1]:.4f} of their own largest, "
          f"{base[2]:.4%} of the elements off by > 3e-2", flush=True)
    for impl in TRAIN_BF16_CONFIGS:
        to32 = step_spread(first[impl], fp32_first)
        to16 = step_spread(first[impl], first["torch"])
        print(f"[parity] bf16 {impl} step 1: vs the fp32 composition loss terms {to32[0]:.3e}, "
              f"gradients worst {to32[1]:.4f}, {to32[2]:.4%} off; vs the bf16 composition "
              f"{to16[0]:.3e}, {to16[1]:.4f}, {to16[2]:.4%} off (bounds {2 * base[0]:.3e}, "
              f"{2 * base[1]:.4f}, {2 * base[2]:.4%} and three times the composition's)", flush=True)
        if any(a > 2 * b for a, b in zip(to32, base)) or any(a > 3 * b for a, b in zip(to16, base)):
            raise AssertionError(f"bf16 {impl} step 1 is farther from the fp32 step ({to32}) or the "
                                 f"bf16 composition ({to16}) than the composition's spread {base} allows")
    del first

    names = tuple(TRAIN_BF16_CONFIGS)
    walls = {f"{impl}{dt}": [] for impl in names for dt in ("", " bf16")}
    peaks, own = dict.fromkeys(walls, 0.0), dict.fromkeys(walls, 0.0)
    for _ in range(TRAIN_STEPS):
        for impl in names:
            for dt, state, step in (("", states[impl], steps[impl]),
                                    (" bf16", bf16_states[impl], bf16_steps[impl])):
                others = torch.cuda.memory_allocated() - state_bytes(state)
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                step(state, ir, vis)
                torch.cuda.synchronize()
                walls[impl + dt].append(1e3 * (time.perf_counter() - t))
                peak = torch.cuda.max_memory_allocated()
                peaks[impl + dt] = max(peaks[impl + dt], peak / 2**20)
                own[impl + dt] = max(own[impl + dt], (peak - others) / 2**20)
    median = {k: float(np.median(w)) for k, w in walls.items()}
    for impl in names:
        w = walls[f"{impl} bf16"]
        print(f"[train] bf16 step 224x224 bs={TRAIN_BATCH} ({impl}), {TRAIN_STEPS} steps in turns "
              f"with fp32: median {median[impl + ' bf16']:.2f} ms/step (fp32 {median[impl]:.2f}, "
              f"{median[impl + ' bf16'] / median[impl] - 1:+.1%}), min {min(w):.2f}, max {max(w):.2f}, "
              f"peak memory {peaks[impl + ' bf16']:.0f} MiB as read, {own[impl + ' bf16']:.0f} MiB less "
              f"the other train states (fp32 {peaks[impl]:.0f}, {own[impl]:.0f} MiB) | {card}",
              flush=True)
        trace(f"train step 224x224 bs={TRAIN_BATCH} ({impl}, bf16)", f"train bf16 {impl}",
              lambda: bf16_steps[impl](bf16_states[impl], ir, vis), median[impl + " bf16"], card)
    del bf16_states, bf16_steps
    torch.cuda.empty_cache()

    ratios = dict(zip(("attention_drop_ratio", "linear_after_att_drop_ratio", "mlp_drop_ratio"),
                      DROP_RATIOS))
    for impl, per_step in TRAIN_BF16_DROP_CONFIGS.items():
        t = time.perf_counter()
        cfg = Config(model=ModelConfig(attention_impl=impl, compute_dtype="bfloat16", **ratios))
        state, step, terms, grads, got = _first_bf16_step(cfg, flat, device, ir, vis, impl, per_step,
                                                          TRAIN_BF16_DROP_MASKS[impl], repeat=True)
        launches.update({n: c for n, c in got.items() if BF16_MAIN_PATH.get(n) == impl and "drop" in n})
        if impl == MASK_MAIN_PATH:  # one kernel, forward and on the gradient
            launches["mask tokens bf16"] = got["mask tokens bf16"] + got["mask tokens bwd bf16"]
        print(f"[train] bf16 dropout {impl} first step ({time.perf_counter() - t:.1f} s, twice): "
              f"launches { {n: c for n, c in got.items() if c} }; "
              + ", ".join(f"{k} {v:.7g}" for k, v in terms.items())
              + f"; all {len(grads)} parameter gradients present, fp32 and finite; repeated from a "
              f"second state under deterministic algorithms: bit-identical", flush=True)
        if impl == "cuda":  # K3 drop (bwd) bf16 on the redesigned kernels alone
            walls = []
            for _ in range(3):
                t = time.perf_counter()
                step(state, ir, vis)
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t))
            label = f"bf16 cuda, dropout {DROP_RATIOS}"
            counts = trace(f"train step 224x224 bs={TRAIN_BATCH} ({label})", f"train {label}",
                           lambda: step(state, ir, vis), float(np.median(walls)), card)
            if counts:
                check_k3_drop_trace(counts, label, card, bf16=True)
            else:
                print(f"[trace]   train {label}: no kernels recorded, the old launches' absence not read", flush=True)
        del state, step, grads
        torch.cuda.empty_cache()
    return launches


# The Trainer's cell: the default model in fp32 under "auto" (K3 on the card) over seeded
# arrays, 2 epochs of 2 steps at 224x224 batch 20, validation every 2 steps, a checkpoint
# each epoch
TRAINER_PAIRS, TRAINER_IMAGE_HW, TRAINER_EPOCHS = 80, (256, 320), 2
TRAINER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_trainer"


def _trainer_config():
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.config import LogConfig, OptimConfig

    return Config(
        model=ModelConfig(),
        optim=OptimConfig(epochs=TRAINER_EPOCHS, batch_size=TRAIN_BATCH, training_set_ratio=0.5),
        log=LogConfig(vali_interval_in_iters=2, save_model_interval_in_epochs=1,
                      save_model_to_folder=str(TRAINER_DIR / "checkpoints"),
                      save_vali_results_to_folder=str(TRAINER_DIR / "vali"),
                      tensorboard_log_dir=str(TRAINER_DIR / "tb")))


def _trainer(cfg, device):
    from swin_unet_image_fusion_tpu_torch.testing import ArrayPairDataset
    from swin_unet_image_fusion_tpu_torch.train import Trainer

    dataset = ArrayPairDataset(TRAINER_PAIRS, TRAINER_IMAGE_HW, cfg.data, seed=SEED)
    return Trainer(cfg, device=device, dataset=dataset)


def _state_tensors(state):
    """A train state's tensors by name (model, Adam) and its counts, for bit comparisons."""
    opt = state.optimizer.state_dict()
    tensors = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for index, per in opt["state"].items():
        tensors.update({f"adam.{index}.{k}": v for k, v in per.items()})
    return tensors, (state.step, state.updates, state.notfinite, opt["param_groups"])


def _assert_states_equal(got, ref, what):
    tensors, counts = _state_tensors(got)
    ref_tensors, ref_counts = _state_tensors(ref)
    if counts != ref_counts:
        raise AssertionError(f"{what}: counts {counts[:3]} vs {ref_counts[:3]}, or Adam's groups differ")
    if set(tensors) != set(ref_tensors):
        raise AssertionError(f"{what}: other tensors: {sorted(set(tensors) ^ set(ref_tensors))[:5]}")
    for key, value in ref_tensors.items():
        if not torch.equal(tensors[key].to(value.device), value):
            raise AssertionError(f"{what}: {key} differs")
    return len(tensors)


def trainer_phases(device, card, bare_ms):
    """The training entry point as a user drives it: ``Trainer.start_train`` on the default
    model in fp32 (``"auto"``) over ``ArrayPairDataset`` (its augmentation, batching and
    prefetch are the real ones), with exact launch counts; then ``[resume]`` (a fresh
    ``Trainer`` loads the epoch-1 checkpoint: its state equals the one saved bit for bit, and
    one step of each on the same batch gives the same bits), ``[pth]`` (the trained model
    out through ``save_torch_checkpoint``, back through ``Fuser.from_checkpoint``: ``fuse_y``
    at 512x512 bit-equal to a ``Fuser`` over the trainer's weights, and the file loads back to
    the same state dict exactly) and ``[nonfinite]`` (a step with a NaN input pixel under
    ``skip_nonfinite_updates`` leaves the parameters bit-equal and counts 1). Returns the
    trainer run's launches."""
    import copy
    import importlib.util
    import os
    import shutil

    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
    from swin_unet_image_fusion_tpu_torch.config import OptimConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_to_jax
    from swin_unet_image_fusion_tpu_torch.models.torch_export import save_torch_checkpoint
    from swin_unet_image_fusion_tpu_torch.models.torch_import import load_torch_checkpoint
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    found = {name: importlib.util.find_spec(name) is not None for name in ("tensorboard", "matplotlib")}
    cfg = _trainer_config()
    impl = cfg.model.resolved_attention_impl(device)
    trainer = _trainer(cfg, device)
    train_step, eval_step, save = trainer.train_step, trainer.eval_step, trainer.save_checkpoint
    marks, evals, saves, snapshots = [], [], [], {}

    def timed_step(state, ir, vis):  # synchronised, as the bare [train] steps are timed
        t = time.perf_counter()
        terms = train_step(state, ir, vis)
        torch.cuda.synchronize()
        marks.append((trainer.current_epoch, t, time.perf_counter()))
        return terms

    def counted_eval(state, ir, vis):
        evals.append(ir.shape[0])
        return eval_step(state, ir, vis)

    def timed_save():
        t = time.perf_counter()
        path = save()
        saves.append((path, time.perf_counter() - t, os.path.getsize(path)))
        if trainer.current_epoch == 1:
            snapshots[1] = copy.deepcopy(trainer.state)  # the state just saved
        return path

    trainer.train_step, trainer.eval_step, trainer.save_checkpoint = timed_step, counted_eval, timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    trainer.start_train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    got = read_counts(impl)
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps = len(marks)
    expected = {name: 0 for name in got}
    expected.update({name: n * (steps + len(evals)) if " bwd" not in name else n * steps
                     for name, n in TRAIN_CONFIGS[impl].items()})
    print(f"[trainer] Trainer.start_train, default model fp32 attention_impl auto -> {impl}: "
          f"{TRAINER_EPOCHS} epochs x {trainer.iters_per_epoch} steps of {TRAIN_HW[0]}x{TRAIN_HW[1]} "
          f"bs={TRAIN_BATCH} over {TRAINER_PAIRS} array pairs of {TRAINER_IMAGE_HW}, {len(evals)} "
          f"validation batches: launches {got}", flush=True)
    if got != expected:
        raise AssertionError(f"Trainer: launches {got}, expected {expected}")
    if steps != TRAINER_EPOCHS * trainer.iters_per_epoch:
        raise AssertionError(f"Trainer ran {steps} steps")
    step_ms = [1e3 * (end - start) for _, start, end in marks]
    gaps = [1e3 * (b[1] - a[2]) for a, b in zip(marks, marks[1:]) if a[0] == b[0]]
    median = float(np.median(step_ms[1:]))
    gap = float(np.median(gaps)) if gaps else float("nan")
    t = time.perf_counter()
    loader_batches = sum(1 for _ in trainer.train_loader)
    loader_ms = 1e3 * (time.perf_counter() - t) / loader_batches
    print(f"[trainer] step: median {median:.2f} ms after the first ({', '.join(f'{m:.2f}' for m in step_ms)}), "
          f"the bare [train] {impl} step {bare_ms:.2f} ms ({median / bare_ms - 1:+.1%}); the loop's "
          f"wait for the next batch in an epoch {gap:.2f} ms; the loader alone {loader_ms:.2f} ms "
          f"per batch of {TRAIN_BATCH} (resized by "
          f"{'cv2' if importlib.util.find_spec('cv2') else 'numpy, cv2 absent'}), keeps up: "
          f"{loader_ms < median}; {TRAIN_BATCH * 1e3 / (median + gap):.1f} pairs/s; run wall "
          f"{wall:.2f} s; peak memory {peak:.0f} MiB; checkpoints "
          + ", ".join(f"{size} bytes in {seconds:.2f} s" for _, seconds, size in saves)
          + f"; tensorboard {'found' if found['tensorboard'] else 'absent'}, matplotlib "
          f"{'found' if found['matplotlib'] else 'absent'} | {card}", flush=True)

    # [resume]: the epoch-1 checkpoint into a fresh Trainer
    path, snapshot = saves[0][0], snapshots[1]
    resumed = _trainer(cfg, device)
    resumed.load_checkpoint(path)
    if resumed.current_epoch != 2:
        raise AssertionError(f"resumed at epoch {resumed.current_epoch}")
    held = _assert_states_equal(resumed.state, snapshot, "resume")
    counts = _state_tensors(snapshot)[1][:3]
    batch = next(iter(resumed.train_loader))
    ir, vis = (torch.from_numpy(batch[k]).to(device) for k in ("ir", "vis"))
    torch.use_deterministic_algorithms(True)  # an op without a deterministic form raises
    try:
        terms = [resumed.train_step(state, ir, vis) for state in (snapshot, resumed.state)]
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    if any(not torch.equal(terms[0][k], terms[1][k]) for k in terms[0]):
        raise AssertionError("resume: the next step's loss terms differ")
    stepped = _assert_states_equal(resumed.state, snapshot, "resume, after a step")
    print(f"[resume] a fresh Trainer from {os.path.basename(path)}: epoch {resumed.current_epoch}, "
          f"{held} tensors (model and Adam) and the counts (step, updates, notfinite) "
          f"{counts} bit-equal to the state saved; one step of each on "
          f"the same batch under deterministic algorithms: loss terms and all {stepped} tensors "
          f"bit-equal | {card}", flush=True)
    del resumed, snapshot, snapshots
    torch.cuda.empty_cache()

    # [pth]: the trained weights out as a reference .pth and back into a Fuser
    pth = str(TRAINER_DIR / "trained.pth")
    save_torch_checkpoint(pth, trainer.state.model, cfg.model, epoch=trainer.current_epoch)
    served = Config(model=cfg.model)
    from_pth = Fuser.from_checkpoint(served, pth, device=device)
    direct = Fuser(served, variables_to_jax(trainer.state.model.state_dict()), device=device)
    rng = np.random.default_rng(SEED + 7)
    ir, vis = (rng.random((1, *SERVE_HW, 1), dtype=np.float32) for _ in range(2))
    out, ref = from_pth.fuse_y(ir, vis), direct.fuse_y(ir, vis)
    check_fused(out, (1, *SERVE_HW, 1))
    if not np.array_equal(out, ref):
        raise AssertionError(f"pth: fuse_y differs from the trainer's weights by {np.abs(out - ref).max()}")
    loaded, epoch = load_torch_checkpoint(pth, cfg.model)
    trained = trainer.state.model.state_dict()
    if epoch != trainer.current_epoch or set(loaded) != set(trained) or any(
            not torch.equal(loaded[k], v.cpu()) for k, v in trained.items()):
        raise AssertionError("pth: the file does not load back to the trained state dict")
    print(f"[pth] save_torch_checkpoint of the trained model ({os.path.getsize(pth)} bytes) -> "
          f"Fuser.from_checkpoint on the card: fuse_y {SERVE_HW[0]}x{SERVE_HW[1]} bit-equal to a Fuser "
          f"over the trainer's weights; the file loads back to all {len(trained)} tensors exactly, "
          f"epoch {epoch} | {card}", flush=True)
    del from_pth, direct, trainer

    # [nonfinite]: a NaN input pixel under skip_nonfinite_updates
    guarded = Config(model=ModelConfig(), optim=OptimConfig(skip_nonfinite_updates=True))
    state = create_train_state(guarded, None, 100, device=device)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    ir, vis = (torch.from_numpy(np.random.default_rng(SEED + 8).random((TRAIN_BATCH, *TRAIN_HW, 1),
                                                                         dtype=np.float32)).to(device)
               for _ in range(2))
    ir[0, 0, 0, 0] = float("nan")
    terms = make_train_step(guarded)(state, ir, vis)
    if torch.isfinite(terms["total_loss"]) or (state.step, state.updates, state.notfinite) != (1, 0, 1):
        raise AssertionError(f"nonfinite: counts {(state.step, state.updates, state.notfinite)}")
    if any(not torch.equal(p, before[n]) for n, p in state.model.named_parameters()):
        raise AssertionError("nonfinite: a parameter moved")
    print(f"[nonfinite] one step with a NaN input pixel under skip_nonfinite_updates: loss "
          f"{float(terms['total_loss'])}, all {len(before)} parameters bit-equal, step 1, updates 0, "
          f"notfinite 1 | {card}", flush=True)
    del state, before
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return got


def cli_phase(card):
    """``python -m swin_unet_image_fusion_tpu_torch.train`` on a folder of image pairs, as a
    user starts training: one epoch of the default model at a 56x56 crop, batch 2, on the card.
    With cv2 the folder holds PNGs and the run must train and save its checkpoint; without it
    the dataset must raise the JAX package's "cv2 required for image decoding"."""
    import importlib.util
    import os
    import shutil

    folder = TRAINER_DIR / "cli_pairs"
    shutil.rmtree(folder, ignore_errors=True)
    have_cv2 = importlib.util.find_spec("cv2") is not None
    rng = np.random.default_rng(SEED + 10)
    for sub, shape in (("ir", (64, 72)), ("vis", (64, 72, 3))):
        os.makedirs(folder / sub)
        for i in range(4):
            path = str(folder / sub / f"{i}.png")
            if have_cv2:
                import cv2
                cv2.imwrite(path, (rng.random(shape) * 255).astype(np.uint8))
            else:
                Path(path).write_bytes(b"not decoded without cv2")
    args = [sys.executable, "-m", "swin_unet_image_fusion_tpu_torch.train",
            f"data.training_dataset_folder={folder}", "optim.epochs=1", "optim.batch_size=2",
            "optim.training_set_ratio=1.0", "data.crop_size=(56, 56)",
            f"log.save_model_to_folder={folder / 'checkpoints'}", f"log.tensorboard_log_dir={folder / 'tb'}",
            f"log.save_vali_results_to_folder={folder / 'vali'}"]
    t = time.perf_counter()
    run = subprocess.run(args, capture_output=True, text=True, timeout=600,
                         cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t
    saved = sorted(os.listdir(folder / "checkpoints")) if (folder / "checkpoints").exists() else []
    if have_cv2 and (run.returncode != 0 or len(saved) != 1 or not saved[0].endswith("_epoch1")):
        raise AssertionError(f"cli: rc {run.returncode}, checkpoints {saved}:\n{run.stderr[-2000:]}")
    if not have_cv2 and (run.returncode == 0 or "cv2 required for image decoding" not in run.stderr):
        raise AssertionError(f"cli without cv2: rc {run.returncode}:\n{run.stderr[-2000:]}")
    what = (f"trained 2 steps and saved {saved[0]}" if have_cv2 else
            "cv2 absent: the dataset raised \"cv2 required for image decoding\"")
    print(f"[cli] python -m swin_unet_image_fusion_tpu_torch.train over 4 PNG pairs: rc "
          f"{run.returncode}, {what}, {seconds:.1f} s | {card}", flush=True)
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)


REMAT_CONFIGS = ("cuda_pack", "cuda_block", "cuda")


def remat_phase(device, card, rounds=TRAIN_STEPS):
    """``remat=True`` against ``remat=False`` at 224x224 batch 20 under each kernel
    configuration: the first step of each from the same weights and batch, under
    ``torch.use_deterministic_algorithms(True)``, the forward's launches doubled and the
    backward's not, every gradient held to the step's without remat
    (``testing.assert_grads_close``; bit-equality reported); then ``rounds`` steps of
    each in turns, ms per step and the step's peak memory above what it found allocated;
    and one ``cuda`` step with every dropout ratio 0.1 and the same seeds, remat on and
    off, gradients held likewise."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import init_variables
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    flat = init_variables(ModelConfig(), SEED)
    rng = np.random.default_rng(SEED + 9)
    ir, vis = (torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
               for _ in range(2))
    ratios = dict(zip(("attention_drop_ratio", "linear_after_att_drop_ratio", "mlp_drop_ratio"),
                      DROP_RATIOS))
    cases = [(impl, {}) for impl in REMAT_CONFIGS] + [("cuda", ratios)]
    for impl, drop in cases:
        label = f"{impl}{' dropout' if drop else ''}"
        states, steps, grads = {}, {}, {}
        for remat in (False, True):
            cfg = Config(model=ModelConfig(attention_impl=impl, remat=remat, **drop))
            states[remat] = create_train_state(cfg, flat, 100, device=device)
            steps[remat] = make_train_step(cfg)
            torch.cuda.synchronize()
            reset_counts()
            torch.use_deterministic_algorithms(True)  # the bias gather's gradient sums in a fixed order
            try:
                steps[remat](states[remat], ir, vis)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            counts = {k: v for k, v in read_counts(impl).items() if v}
            if not drop:
                per_step = TRAIN_CONFIGS[impl]
                expected = {k: n * (2 if remat and " bwd" not in k else 1) for k, n in per_step.items()}
                if counts != expected:
                    raise AssertionError(f"remat {remat} {impl}: launches {counts}, expected {expected}")
            print(f"[remat] {label} remat={remat} first step: launches {counts}", flush=True)
            grads[remat] = {n: p.grad.detach().clone() for n, p in states[remat].model.named_parameters()}
        names = list(grads[False])
        check = assert_grads_close([grads[True][n] for n in names], [grads[False][n] for n in names],
                                   names, f"remat {label}")
        bit_equal = all(torch.equal(grads[True][n], grads[False][n]) for n in names)
        print(f"[remat] {label}: all {len(names)} gradients with remat held to those without "
              f"(max_abs_err {check.worst:.3e}), bit-equal: {bit_equal} | {card}", flush=True)
        del grads
        if drop:
            del states, steps
            torch.cuda.empty_cache()
            continue
        walls = {False: [], True: []}
        peaks = {False: 0.0, True: 0.0}
        for _ in range(rounds):
            for remat in (False, True):
                torch.cuda.synchronize()
                resting = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                steps[remat](states[remat], ir, vis)
                torch.cuda.synchronize()
                walls[remat].append(1e3 * (time.perf_counter() - t))
                peaks[remat] = max(peaks[remat], (torch.cuda.max_memory_allocated() - resting) / 2**20)
        for remat in (False, True):
            w = walls[remat]
            print(f"[remat] step {TRAIN_HW[0]}x{TRAIN_HW[1]} bs={TRAIN_BATCH} ({impl}, remat={remat}), "
                  f"{rounds} steps in turns: "
                  f"median {float(np.median(w)):.2f} ms/step, min {min(w):.2f}, max {max(w):.2f}; the "
                  f"step's peak memory above the {resting / 2**20:.0f} MiB allocated before it "
                  f"{peaks[remat]:.0f} MiB | {card}", flush=True)
        del states, steps
        torch.cuda.empty_cache()


# The serving and evaluation surface: colour fusion, the test-folder entry point, tiled 2K/4K
# fusion, the Canny training step, the evaluation metrics and the FLOP count, all with the
# default model in fp32 under "auto" (K3 on the card)
COLOUR_ROUNDS = 20  # fuse_pair_ycrcb and fuse_y calls each at 512² bs=1, in turns
TEST_PAIRS, TEST_HW = 4, (480, 640)
TILE, OVERLAP, TILED_BATCH = 512, 64, 32
TILED_SIZES = {"2K": (2048, 2048), "4K": (2160, 3840)}
TILED_ROUNDS = 3  # timed calls per size and mode, fp32 and uint8 I/O in turns
TILED_CHUNKED_BATCH = 8  # the chunked run held against the unchunked one at 2K
UNTILED_HW = (1024, 1024)  # tiled against one forward of the whole image
CANNY_CALLS = 6
CANNY_STEPS = 6  # steps of each Canny phase form in turns
SERVING_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_serving"


def _have_cv2() -> bool:
    import importlib.util

    return importlib.util.find_spec("cv2") is not None


def _k3_only(counts, expected_k3, what):
    """The launches read after a run: ``expected_k3`` of K3's fp32 forward and nothing else."""
    got = {k: v for k, v in counts.items() if v}
    if got != {"K3": expected_k3}:
        raise AssertionError(f"{what}: launches {got}, expected {{'K3': {expected_k3}}}")


def colour_phase(fuser, plain_fuser, cpu_fuser, card):
    """``Fuser.fuse_pair_ycrcb`` (fp32, ``"auto"``): at 100x90 against the CPU port, at 512x512
    against the torch composition on the card and against host ``cv2.cvtColor`` of the card's
    fused Y, with K3's launches; then ms per pair against ``fuse_y`` in turns. Returns the
    512x512 inputs and RGB."""
    rng = np.random.default_rng(SEED + 20)
    for hw in ((100, 90), SERVE_HW):
        ir = rng.random((1, *hw, 1), dtype=np.float32)
        vis = rng.random((1, *hw, 3), dtype=np.float32)
        reset_counts()
        rgb = fuser.fuse_pair_ycrcb(ir, vis)
        torch.cuda.synchronize()
        _k3_only(read_counts("cuda"), CONFIGS["cuda"][hw]["K3"], f"fuse_pair_ycrcb {hw}")
        if rgb.shape != (1, *hw, 3) or not np.isfinite(rgb).all() or rgb.min() < 0 or rgb.max() > 1:
            raise AssertionError(f"fuse_pair_ycrcb {hw}: shape {rgb.shape}, range {rgb.min()} .. {rgb.max()}")
        ref = cpu_fuser if hw == (100, 90) else plain_fuser
        ref_rgb = ref.fuse_pair_ycrcb(ir, vis)
        err = float(np.abs(rgb - ref_rgb).max())
        print(f"[colour] fuse_pair_ycrcb {hw[0]}x{hw[1]}: K3 {CONFIGS['cuda'][hw]['K3']} launches; against "
              f"{'the CPU port' if hw == (100, 90) else 'the torch composition on the card'} "
              f"max_abs_err {err:.3e}", flush=True)
        np.testing.assert_allclose(rgb, ref_rgb, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    if _have_cv2():
        import cv2

        ycrcb = np.concatenate([fuser.fuse_y(ir, vis[..., :1]), vis[..., 1:]], axis=-1)[0]
        host = np.clip(cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2RGB), 0.0, 1.0)
        err = float(np.abs(rgb[0] - host).max())
        print(f"[colour] {SERVE_HW[0]}x{SERVE_HW[1]}: the card's colour rows against host cv2.cvtColor of the "
              f"card's fused Y: "
              f"max_abs_err {err:.3e}", flush=True)
        np.testing.assert_allclose(rgb[0], host, atol=2e-6, rtol=0)
    else:
        print("[colour] cv2 absent: the host cv2.cvtColor comparison was skipped", flush=True)
    walls = {"fuse_pair_ycrcb": [], "fuse_y": []}
    calls = {"fuse_pair_ycrcb": lambda: fuser.fuse_pair_ycrcb(ir, vis),
             "fuse_y": lambda: fuser.fuse_y(ir, vis[..., :1])}
    for _ in range(COLOUR_ROUNDS):
        for name, call in calls.items():
            t = time.perf_counter()
            call()
            walls[name].append(1e3 * (time.perf_counter() - t))
    med = {name: float(np.median(w)) for name, w in walls.items()}
    print(f"[colour] {SERVE_HW[0]}x{SERVE_HW[1]} bs=1, {COLOUR_ROUNDS} calls each in turns: fuse_pair_ycrcb median "
          f"{med['fuse_pair_ycrcb']:.2f} ms/pair (min {min(walls['fuse_pair_ycrcb']):.2f}), fuse_y "
          f"{med['fuse_y']:.2f} (min {min(walls['fuse_y']):.2f}), the colour path "
          f"{med['fuse_pair_ycrcb'] - med['fuse_y']:+.2f} ms | {card}", flush=True)
    colour_breakdown(fuser, ir, vis, med, card)
    return ir, vis, rgb


def colour_breakdown(fuser, ir, vis, med, card):
    """What ``fuse_pair_ycrcb`` adds to ``fuse_y`` at 512x512, piece by piece, each call
    synchronised on both sides, COLOUR_ROUNDS in turns: Cr/Cb to the card as it does it (a
    strided view of the YCrCb array copied from pageable memory; apart, for comparison,
    numpy's gather of that view and a contiguous array's copy), the concatenation,
    conversion and clip on the card, and the RGB's copy back beside the Y's; then one traced
    call of each path."""
    from swin_unet_image_fusion_tpu_torch.infer import ycrcb_to_rgb

    device = fuser.device
    y = torch.as_tensor(fuser.fuse_y(ir, vis[..., :1]), device=device)
    crcb_host = np.ascontiguousarray(vis[..., 1:3], np.float32)
    crcb = torch.as_tensor(crcb_host, device=device)
    rgb = torch.clamp(ycrcb_to_rgb(torch.cat([y, crcb], dim=-1)), 0.0, 1.0)
    pieces = {
        "Cr/Cb to the card as fuse_pair_ycrcb copies it": lambda: torch.as_tensor(
            np.asarray(vis[..., 1:3], np.float32), device=device),
        "(apart: numpy gathering the strided view)": lambda: np.ascontiguousarray(vis[..., 1:3], np.float32),
        "(apart: a contiguous array's pageable copy)": lambda: torch.as_tensor(crcb_host, device=device),
        "concatenation, conversion and clip on the card": lambda: torch.clamp(
            ycrcb_to_rgb(torch.cat([y, crcb], dim=-1)), 0.0, 1.0),
        "RGB (3 channels) to the host": lambda: rgb.cpu(),
        "Y (1 channel) to the host": lambda: y.cpu(),
    }
    walls = {name: [] for name in pieces}
    for _ in range(COLOUR_ROUNDS):
        for name, piece in pieces.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            piece()
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t))
    ms = {name: float(np.median(w)) for name, w in walls.items()}
    names = list(pieces)
    added = ms[names[0]] + ms[names[3]] + ms[names[4]] - ms[names[5]]
    print(f"[colour] {SERVE_HW[0]}x{SERVE_HW[1]} the colour path's pieces, {COLOUR_ROUNDS} calls each in turns, "
          f"synchronised medians: " + "; ".join(f"{name} {v:.3f} ms" for name, v in ms.items())
          + f"; added to fuse_y: {added:.3f} ms (Cr/Cb in + conversion + RGB out - Y out) against the "
          f"{med['fuse_pair_ycrcb'] - med['fuse_y']:+.2f} ms of the calls in turns | {card}", flush=True)
    busy = {}
    for name, call in (("fuse_pair_ycrcb", lambda: fuser.fuse_pair_ycrcb(ir, vis)),
                       ("fuse_y", lambda: fuser.fuse_y(ir, vis[..., :1]))):
        kernels = trace(f"{name} {SERVE_HW[0]}x{SERVE_HW[1]} bs=1 (cuda)", f"colour {name}", call, med[name], card)
        copies = sum(ms for key, (_, ms) in kernels.items() if "memcpy" in key.lower())
        busy[name] = (copies, sum(ms for _, ms in kernels.values()) - copies)
    if all(sum(v) for v in busy.values()):
        print("[colour] traced device time: " + ", ".join(
            f"{name} copies {c:.3f} ms, kernels {k:.3f} ms" for name, (c, k) in busy.items()) + f" | {card}",
              flush=True)


def test_phase(flat, device, card):
    """``python -m swin_unet_image_fusion_tpu_torch.infer`` as a user runs it, in a subprocess
    on the card, over TEST_PAIRS seeded 480x640 PNG pairs with a ``.pth`` the port wrote: the
    ``{orig}_MKX_SELF.jpg`` names, and each file decoded equal to ``save_image`` of the
    in-process ``fuse_pair_ycrcb`` of the same pair. Without cv2 nothing is decoded or
    written: it says so (the colour path ran on arrays in ``[colour]``)."""
    import os
    import shutil

    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.data.dataset import FusionPairDataset
    from swin_unet_image_fusion_tpu_torch.infer import Fuser, save_image
    from swin_unet_image_fusion_tpu_torch.models.from_jax import variables_from_jax
    from swin_unet_image_fusion_tpu_torch.models.torch_export import save_torch_checkpoint

    if not _have_cv2():
        print("[test] cv2 absent: the PNG decode and JPEG write of run_test were skipped", flush=True)
        return
    import cv2

    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    folder, out_dir, again = SERVING_DIR / "input", SERVING_DIR / "output", SERVING_DIR / "again"
    rng = np.random.default_rng(SEED + 21)
    for sub, shape in (("ir", TEST_HW), ("vis", (*TEST_HW, 3))):
        os.makedirs(folder / sub)
        for i in range(TEST_PAIRS):
            cv2.imwrite(str(folder / sub / f"pic{i}.png"), (rng.random(shape) * 255).astype(np.uint8))
    os.makedirs(again)
    pth = str(SERVING_DIR / "weights.pth")
    save_torch_checkpoint(pth, variables_from_jax(flat), ModelConfig())
    args = [sys.executable, "-m", "swin_unet_image_fusion_tpu_torch.infer", f"log.using_state_path={pth}",
            f"data.test_dataset_folder={folder}", f"data.test_result_folder={out_dir}"]
    t = time.perf_counter()
    run = subprocess.run(args, capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    seconds = time.perf_counter() - t
    names = sorted(os.listdir(out_dir)) if out_dir.exists() else []
    want = [f"pic{i}_MKX_SELF.jpg" for i in range(TEST_PAIRS)]
    if run.returncode != 0 or names != want:
        raise AssertionError(f"infer: rc {run.returncode}, files {names}:\n{run.stderr[-2000:]}")
    cfg = Config()
    fuser = Fuser.from_checkpoint(cfg, pth, device=device)
    dataset = FusionPairDataset(is_test=True, dataset_folder=str(folder), cfg=cfg.data)
    for i in range(TEST_PAIRS):
        item = dataset[i]
        save_image(fuser.fuse_pair_ycrcb(item["ir"][None], item["vis"][None])[0], str(again / f"{i}.jpg"))
        a, b = cv2.imread(str(out_dir / want[i])), cv2.imread(str(again / f"{i}.jpg"))
        if a is None or a.shape != (*TEST_HW, 3) or not np.array_equal(a, b):
            raise AssertionError(f"infer: {want[i]} differs from save_image of the in-process fuse_pair_ycrcb")
    print(f"[test] python -m swin_unet_image_fusion_tpu_torch.infer over {TEST_PAIRS} PNG pairs "
          f"{TEST_HW[0]}x{TEST_HW[1]}: rc 0, {names}, each decoded equal to save_image of the in-process "
          f"fuse_pair_ycrcb; {seconds:.1f} s with the process start | {card}", flush=True)
    shutil.rmtree(SERVING_DIR, ignore_errors=True)


def numpy_blend(fused, plan, h, w):
    """The JAX package's blend in numpy: each tile's fused Y times its 2-D ramp weight added
    row-major, times the inverse of the weights' sum."""
    from swin_unet_image_fusion_tpu_torch.parallel.tiled import _ramp_weights

    wy, wx = _ramp_weights(plan.th, plan.ys, h), _ramp_weights(plan.tw, plan.xs, w)
    acc = np.zeros((h, w, 1), np.float32)
    norm = np.zeros((h, w, 1), np.float32)
    for k, (y0, x0) in enumerate(plan.starts()):
        wgt = (wy[plan.ys.index(y0)][:, None] * wx[plan.xs.index(x0)][None, :])[:, :, None]
        acc[y0:y0 + plan.th, x0:x0 + plan.tw] += fused[k] * wgt
        norm[y0:y0 + plan.th, x0:x0 + plan.tw] += wgt
    return acc * (1.0 / np.maximum(norm, 1e-8)).astype(np.float32)


def _near_half_levels(u8, ref_u8, ref_float):
    """uint8 against float: at most one level apart, and apart only where the float value
    x 255 lies within 255 x 5e-4 of a half-integer. Returns the pixels apart."""
    diff = np.abs(u8.astype(int) - ref_u8.astype(int))
    scaled = np.clip(ref_float, 0, 1) * 255.0
    near = np.abs(scaled - np.floor(scaled) - 0.5) <= 255.0 * MODEL_ATOL
    if diff.max() > 1 or not near[diff != 0].all():
        raise AssertionError(f"tiled uint8: {int((diff > 1).sum())} pixels > 1 level apart, "
                             f"{int((diff != 0)[~near].sum())} apart away from a rounding edge")
    return int((diff != 0).sum())


def tiled_phase(flat, device, card):
    """``TiledFuser`` (tile 512, overlap 64, chunks of 32, fp32, ``"auto"``) at 2048x2048 and
    2160x3840: each chunk's fused tiles against the torch composition on the card, the blend
    against a numpy blend of the same tiles, exactly 40 K3 launches a chunk, chunks of 8
    against one batch at 2K, uint8 against float I/O; then s/image with the transfers and
    on the device alone, megapixels/s, peak memory and launches, fp32 and uint8 I/O in turns,
    and one traced 4K call; at 1024x1024 the SSIM and mean |difference| of tiled against
    untiled (printed: under random weights the model's context exceeds the 64-pixel halo).
    Returns the device seconds and tiles of the 4K fp32 run."""
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.infer import fused_y
    from swin_unet_image_fusion_tpu_torch.metrics import ssim
    from swin_unet_image_fusion_tpu_torch.parallel.tiled import TiledFuser

    model = ModelConfig()
    fusers = {mode: TiledFuser(model, flat, TILE, OVERLAP, TILED_BATCH, return_uint8=mode == "uint8",
                               device=device) for mode in ("fp32", "uint8")}
    plain = TiledFuser(ModelConfig(attention_impl="torch"), flat, TILE, OVERLAP, TILED_BATCH, device=device)
    f = fusers["fp32"]
    rng = np.random.default_rng(SEED + 22)
    result = {}
    for size, (h, w) in TILED_SIZES.items():
        ir8, vis8 = ((rng.random((h, w, 1)) * 255).astype(np.uint8) for _ in range(2))
        ir, vis = ir8.astype(np.float32) / 255.0, vis8.astype(np.float32) / 255.0
        plan = f.plan(h, w)
        chunks = -(-plan.n_tiles // TILED_BATCH)
        with torch.inference_mode():
            reset_counts()
            out = f.fuse(ir, vis)
            torch.cuda.synchronize()
            _k3_only(read_counts("cuda"), 40 * chunks, f"tiled {size}")
            check_fused(out[None], (1, h, w, 1))
            tiles_ir, tiles_vis = f.tiles(f._to_device(ir), plan), f.tiles(f._to_device(vis), plan)
            fused, worst = [], 0.0
            for c0 in range(0, plan.n_tiles, TILED_BATCH):
                a, b = tiles_ir[c0:c0 + TILED_BATCH], tiles_vis[c0:c0 + TILED_BATCH]
                reset_counts()
                got = fused_y(f.model, a, b)
                torch.cuda.synchronize()
                _k3_only(read_counts("cuda"), 40, f"tiled {size} chunk at tile {c0}")
                ref = fused_y(plain.model, a, b)
                worst = max(worst, (got - ref).abs().max().item())
                torch.testing.assert_close(got, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL)
                fused.append(got)
            fused = torch.cat(fused)
            blended = numpy_blend(fused.cpu().numpy(), plan, h, w)
            blend_err = float(np.abs(out - blended).max())
            np.testing.assert_allclose(out, blended, atol=1e-6, rtol=0)
            line = (f"[tiled] {size} {h}x{w}: {plan.n_tiles} tiles {plan.th}x{plan.tw} in {chunks} chunks "
                    f"(the last {plan.n_tiles - (chunks - 1) * TILED_BATCH}), K3 40 a chunk; chunks against the "
                    f"torch composition max_abs_err {worst:.3e}; the blend against numpy's {blend_err:.3e}")
            if size == "2K":
                chunked = TiledFuser(model, flat, TILE, OVERLAP, TILED_CHUNKED_BATCH, device=device).fuse(ir, vis)
                whole = TiledFuser(model, flat, TILE, OVERLAP, 0, device=device).fuse(ir, vis)
                np.testing.assert_allclose(chunked, whole, atol=MODEL_ATOL, rtol=MODEL_RTOL)
                line += (f"; chunks of {TILED_CHUNKED_BATCH} against one batch of {plan.n_tiles} max_abs_err "
                         f"{float(np.abs(chunked - whole).max()):.3e}")
            out8 = fusers["uint8"].fuse(ir8, vis8)
            apart = _near_half_levels(out8, np.round(np.clip(out, 0, 1) * 255).astype(np.uint8), out)
            print(f"{line}; uint8 I/O against float: {apart} pixels one level apart, each at a rounding edge",
                  flush=True)
            del tiles_ir, tiles_vis, fused
            torch.cuda.empty_cache()

            inputs = {"fp32": (ir, vis), "uint8": (ir8, vis8)}
            on_device = {mode: tuple(torch.as_tensor(a, device=device) for a in pair)
                         for mode, pair in inputs.items()}
            walls = {(mode, where): [] for mode in inputs for where in ("host", "device")}
            peaks = {}
            for _ in range(TILED_ROUNDS):
                for mode, fuser in fusers.items():
                    t = time.perf_counter()
                    fuser.fuse(*inputs[mode])
                    walls[(mode, "host")].append(time.perf_counter() - t)
                    torch.cuda.synchronize()
                    resting = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    t = time.perf_counter()
                    fuser.fuse_on_device(*on_device[mode])
                    torch.cuda.synchronize()
                    walls[(mode, "device")].append(time.perf_counter() - t)
                    _k3_only(read_counts("cuda"), 40 * chunks, f"tiled {size} {mode}")
                    peaks[mode] = max(peaks.get(mode, 0.0), (torch.cuda.max_memory_allocated() - resting) / 2**20)
            for mode in inputs:
                host, dev = (float(np.median(walls[(mode, where)])) for where in ("host", "device"))
                print(f"[tiled] {size} {h}x{w} {mode} I/O, tile {TILE} overlap {OVERLAP} max_batch {TILED_BATCH}, "
                      f"{TILED_ROUNDS} calls in turns: {host:.4f} s/image with the transfers "
                      f"({h * w / 1e6 / host:.2f} MP/s), {dev:.4f} s on the device alone "
                      f"({h * w / 1e6 / dev:.2f} MP/s, {plan.n_tiles / dev:.2f} tiles/s), peak memory above the "
                      f"{resting / 2**20:.0f} MiB allocated {peaks[mode]:.0f} MiB, K3 {40 * chunks} launches "
                      f"| {card}", flush=True)
            result[size] = (float(np.median(walls[("fp32", "device")])), plan.n_tiles)
            if size == "4K":
                a, b = on_device["fp32"]
                trace(f"tiled 4K {h}x{w} fp32 (device-resident)", "tiled 4K",
                      lambda: fusers["fp32"].fuse_on_device(a, b), 1e3 * result[size][0], card)
            del on_device
            torch.cuda.empty_cache()

    hw = UNTILED_HW
    ir, vis = (torch.from_numpy(rng.random((*hw, 1), dtype=np.float32)).to(device) for _ in range(2))
    with torch.inference_mode():
        tiled = f.fuse_on_device(ir, vis)
        whole = fused_y(f.model, ir[None], vis[None])[0]
        print(f"[tiled] {hw[0]}x{hw[1]} tiled ({f.plan(*hw).n_tiles} tiles) against one forward of the image: SSIM "
              f"{ssim(tiled[None], whole[None]).item():.5f}, mean |difference| "
              f"{(tiled - whole).abs().mean().item():.3e}, max {(tiled - whole).abs().max().item():.3e} "
              f"(printed, not asserted: random weights) | {card}", flush=True)
    del fusers, plain, model
    torch.cuda.empty_cache()
    return result


def canny_phase(flat, device, card):
    """The 224x224 batch-20 step with ``choose_canny_else_sobel=True`` under ``"auto"`` (K3
    forward and backward): finite; its loss terms against the torch composition's first
    step on the card to 1e-5 relative (the texture term, a count of edge pixels, also
    within the pixels where the two fused images' edge maps differ); the card's edge maps
    of the batch (the fused image, ir, vis) bit-equal to the CPU port's; the step with the
    texture term's one stacked ``canny`` call against the same step with three calls (the
    JAX package's form; step 1's terms equal) and the Sobel step, in turns; inside the step,
    each form's calls by CUDA events, host time and hysteresis chunks (device reads); each
    form's calls alone in turns; and traced Canny and Sobel steps and one stacked call, for
    the device time that the Canny step adds against its wall."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.config import LossConfig
    from swin_unet_image_fusion_tpu_torch.ops import edges
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED + 23)
    ir, vis = (torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
               for _ in range(2))
    canny_loss = LossConfig(choose_canny_else_sobel=True)
    cases = {"canny": Config(loss=canny_loss), "torch canny": Config(model=ModelConfig(attention_impl="torch"),
                                                                   loss=canny_loss), "sobel": Config()}
    states = {name: create_train_state(cfg, flat, 100, device=device) for name, cfg in cases.items()}
    steps = {name: make_train_step(cfg) for name, cfg in cases.items()}
    fusions = {}
    with torch.no_grad():  # the step's fused image (train mode, no dropout), on copies of the states
        for name in ("canny", "torch canny"):
            probe = create_train_state(cases[name], flat, 100, device=device)
            fusions[name] = torch.clamp(probe.model(ir, vis, train=True), 0.0, 1.0)
            del probe
    first = {}
    for name in cases:
        torch.cuda.synchronize()
        reset_counts()
        chunks = edges.HYSTERESIS_CHUNKS
        terms = {k: float(v) for k, v in steps[name](states[name], ir, vis).items()}
        torch.cuda.synchronize()
        if not all(np.isfinite(v) for v in terms.values()):
            raise AssertionError(f"{name} step: terms {terms}")
        got = {k: v for k, v in read_counts("cuda").items() if v}
        if got != ({} if name == "torch canny" else TRAIN_CONFIGS["cuda"]):
            raise AssertionError(f"{name} step: launches {got}")
        first[name] = terms
        print(f"[canny] {name} first step: " + ", ".join(f"{k} {v:.7g}" for k, v in terms.items())
              + f"; hysteresis chunks {edges.HYSTERESIS_CHUNKS - chunks}", flush=True)
    maps = {name: edges.canny(fusions[name])[1] for name in fusions}
    flips = int((maps["canny"] != maps["torch canny"]).sum())
    texture_bound = flips / maps["canny"].numel() * canny_loss.texture_scale
    for k, v in first["canny"].items():
        ref = first["torch canny"][k]
        slack = {"texture_loss": texture_bound, "total_loss": texture_bound * canny_loss.texture_loss_ratio}
        if abs(v - ref) > 1e-5 * abs(ref) + slack.get(k, 0.0):
            raise AssertionError(f"canny step 1 {k} {v} vs torch composition {ref} ({flips} edge pixels differ)")
    rel = {k: abs(v - first["torch canny"][k]) / max(abs(first["torch canny"][k]), 1e-30)
           for k, v in first["canny"].items()}
    print(f"[parity] canny train step 1 vs torch composition on the card: loss terms relative differences "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f"; the fused images' edge maps differ in {flips} of {maps['canny'].numel()} pixels", flush=True)
    on_card = [fusions["canny"], ir, vis]
    card_maps = [edges.canny(x)[1] for x in on_card]
    cpu_maps = [edges.canny(x.cpu())[1] for x in on_card]
    for label, a, b in zip(("fusion", "ir", "vis"), card_maps, cpu_maps):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"canny {label}: the card's edge map differs from the CPU's in "
                                 f"{int((a.cpu() != b).sum())} pixels")
    print(f"[canny] edge maps of the batch ({TRAIN_BATCH}x{TRAIN_HW[0]}x{TRAIN_HW[1]}: the fused image, ir, vis) "
          f"bit-equal card vs CPU; edge pixels {[int(m.sum()) for m in card_maps]}", flush=True)

    states["canny, three calls"] = create_train_state(cases["canny"], flat, 100, device=device)
    with _canny_calls(three=True):
        terms = {k: float(v) for k, v in steps["canny"](states["canny, three calls"], ir, vis).items()}
    if terms != first["canny"]:
        raise AssertionError(f"canny step 1 as three calls {terms} vs one stacked call {first['canny']}")
    # every form's steps in turns after an untimed round (the order reversed every other
    # round, so that a form follows itself or another), each step marked: host ms since the
    # step's start and the card's (a CUDA event) at the loss's and the texture term's entry
    # and exit, at the return and after the synchronise; the card's minus the host's is the
    # queue ahead of the card, zero where the card waits for the host. The canny calls'
    # spans on the card's timeline, host time and hysteresis chunks are recorded too.
    # Python's garbage collections (host ms before "loss in", and after it) and the caching
    # allocator's new device segments and retries are counted per step too.
    forms = {"canny": False, "canny, three calls": True, "sobel": None}
    walls = {name: [] for name in forms}
    timeline = {name: [] for name in forms}
    record = {name: [] for name in forms}
    host_costs = {name: [] for name in forms}
    after_form = {}  # (form, the form of the step before) -> the forward's host ms
    previous = None
    for round_ in range(CANNY_STEPS + 1):
        order = list(forms) if round_ % 2 == 0 else list(forms)[::-1]
        for name in order:
            three = forms[name]
            marks, collections = [], []
            before = torch.cuda.memory_stats()
            with _canny_calls(three=bool(three), record=record[name] if round_ else None), \
                    _step_marks(marks) as mark, _collections(collections):
                torch.cuda.synchronize()
                t = time.perf_counter()
                mark("start")
                steps["sobel" if three is None else "canny"](states[name], ir, vis)
                mark("returned")
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t)
                mark("synchronised")
            after = torch.cuda.memory_stats()
            if round_:
                walls[name].append(wall)
                _, t0, e0 = marks[0]
                timeline[name].append({label: (1e3 * (t - t0), e0.elapsed_time(e)) for label, t, e in marks[1:]})
                loss_in = next(t for label, t, _ in marks if label == "loss in")
                host_costs[name].append((
                    1e3 * sum(end - begin for begin, end, _ in collections if end <= loss_in),
                    1e3 * sum(end - begin for begin, end, _ in collections if end > loss_in),
                    sum(1 for _, _, generation in collections if generation == 2),
                    *(after.get(key, 0) - before.get(key, 0) for key in ("segment.all.allocated", "num_alloc_retries")),
                    before.get("inactive_split.all.current", 0)))
                after_form.setdefault((name, previous), []).append(1e3 * (loss_in - t0))
            previous = name
    med = {name: float(np.median(w)) for name, w in walls.items()}
    print(f"[canny] step {TRAIN_HW[0]}x{TRAIN_HW[1]} bs={TRAIN_BATCH} (cuda), {CANNY_STEPS} steps each in turns "
          f"after an untimed round: " + "; ".join(
              f"{name} median {med[name]:.2f} ms/step (min {min(walls[name]):.2f}; in order "
              + " ".join(f"{w:.1f}" for w in walls[name]) + ")" for name in forms)
          + f"; Canny over Sobel {med['canny'] - med['sobel']:+.2f} ms, as three calls "
          f"{med['canny, three calls'] - med['sobel']:+.2f} ms (step 1's terms equal bit for bit) | {card}",
          flush=True)
    for name in forms:
        labels = timeline[name][0]
        marked = {label: tuple(float(np.median([run[label][i] for run in timeline[name]])) for i in (0, 1))
                  for label in labels}
        line = (f"[canny] step timeline ({name}, medians; host / card ms since the start): "
                + ", ".join(f"{label} {h:.2f} / {d:.2f}" for label, (h, d) in marked.items()))
        costs = np.asarray(host_costs[name], dtype=np.float64)
        line += (f"; Python's garbage collections {float(np.median(costs[:, 0])):.2f} ms a step before the loss "
                 f"and {float(np.median(costs[:, 1])):.2f} after (medians; {costs[:, 2].sum():.0f} full collections "
                 f"in {CANNY_STEPS} steps); the allocator's new device segments {costs[:, 3].sum():.0f} and retries "
                 f"{costs[:, 4].sum():.0f} in {CANNY_STEPS} steps, {float(np.median(costs[:, 5])):.0f} split cached "
                 f"blocks at a step's start; the forward's host ms by the step before: " + ", ".join(
                     f"after {before_name} {float(np.median(v)):.2f} ({len(v)})"
                     for (form, before_name), v in sorted(after_form.items(), key=lambda kv: str(kv[0]))
                     if form == name))
        if record[name]:
            calls = record[name]
            line += (f"; {len(calls) // CANNY_STEPS} canny calls a step spanning "
                     f"{sum(a.elapsed_time(b) for a, b, _, _ in calls) / CANNY_STEPS:.3f} ms of the card's "
                     f"timeline (CUDA events around each), {1e3 * sum(h for _, _, h, _ in calls) / CANNY_STEPS:.3f} "
                     f"ms of host time in them, {sum(c for _, _, _, c in calls) / CANNY_STEPS:.1f} hysteresis "
                     f"chunks a step, each one device read")
        print(f"{line} | {card}", flush=True)

    x = fusions["canny"]
    stacked = torch.cat([x, ir, vis])
    calls = {"one call over the stacked fused, ir and vis batches": lambda: edges.canny(stacked),
             "three calls, one a batch": lambda: [edges.canny(b) for b in (x, ir, vis)]}
    call_ms = {name: [] for name in calls}
    call_chunks = {name: 0 for name in calls}
    for _ in range(CANNY_CALLS):
        for name, call in calls.items():
            torch.cuda.synchronize()
            chunks, t = edges.HYSTERESIS_CHUNKS, time.perf_counter()
            call()
            torch.cuda.synchronize()
            call_ms[name].append(1e3 * (time.perf_counter() - t))
            call_chunks[name] += edges.HYSTERESIS_CHUNKS - chunks
    print(f"[canny] alone, {CANNY_CALLS} times each in turns (host clock, synchronised): " + "; ".join(
        f"{name} median {float(np.median(call_ms[name])):.3f} ms, {call_chunks[name] / CANNY_CALLS:.1f} "
        f"hysteresis chunks of {edges.HYSTERESIS_CHUNK}" for name in calls) + f" | {card}", flush=True)

    busy = {}
    for name in ("canny", "sobel"):
        kernels = trace(f"{name} step {TRAIN_HW[0]}x{TRAIN_HW[1]} bs={TRAIN_BATCH} (cuda)", f"{name} step",
                        lambda: steps[name](states[name], ir, vis), med[name], card)
        busy[name] = (sum(ms for _, ms in kernels.values()), sum(n for n, _ in kernels.values()))
    one = float(np.median(call_ms[next(iter(calls))]))
    kernels = trace("canny, one stacked call", "canny call", lambda: edges.canny(stacked), one, card)
    if kernels and all(b for b, _ in busy.values()):
        call_busy = sum(ms for _, ms in kernels.values())
        print(f"[canny] traced: the Canny step {busy['canny'][0]:.3f} ms busy in {busy['canny'][1]} kernels, the "
              f"Sobel step {busy['sobel'][0]:.3f} ms in {busy['sobel'][1]}: {busy['canny'][0] - busy['sobel'][0]:+.3f} "
              f"ms of device work against {med['canny'] - med['sobel']:+.2f} ms of wall; one stacked canny call "
              f"{call_busy:.3f} ms busy in {sum(n for n, _ in kernels.values())} kernels of its {one:.3f} ms "
              f"| {card}", flush=True)
    del states, steps, fusions
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _collections(collections):
    """For the duration, each of Python's garbage collections appended to ``collections`` as
    (start, end host seconds, generation)."""
    import gc

    started = {}

    def callback(phase, info):
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            collections.append((started.pop("t"), time.perf_counter(), info["generation"]))

    gc.callbacks.append(callback)
    try:
        yield
    finally:
        gc.callbacks.remove(callback)


@contextlib.contextmanager
def _step_marks(marks):
    """Yields ``mark(label)``, which appends (label, host seconds, a recorded CUDA event) to
    ``marks``; for the duration, the train step's loss and its texture term mark their entry
    and exit ("loss in", "texture in", "texture out", "loss out")."""
    from swin_unet_image_fusion_tpu_torch import losses, train

    def mark(label):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((label, time.perf_counter(), event))

    def marked(fn, what):
        def call(*args, **kw):
            mark(f"{what} in")
            out = fn(*args, **kw)
            mark(f"{what} out")
            return out
        return call

    loss, texture = train.total_fusion_loss, losses.texture_term
    train.total_fusion_loss, losses.texture_term = marked(loss, "loss"), marked(texture, "texture")
    try:
        yield mark
    finally:
        train.total_fusion_loss, losses.texture_term = loss, texture


@contextlib.contextmanager
def _canny_calls(three=False, record=None):
    """``losses.canny`` for the duration: as it is (one call over the fused, ir and vis
    batches stacked), or with ``three`` as three calls, one a batch (the JAX package's form);
    with ``record``, each call's CUDA events, host seconds and hysteresis chunks appended."""
    from swin_unet_image_fusion_tpu_torch import losses
    from swin_unet_image_fusion_tpu_torch.ops import edges

    def one(x, **kw):
        if record is None:
            return edges.canny(x, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        chunks, t = edges.HYSTERESIS_CHUNKS, time.perf_counter()
        start.record()
        out = edges.canny(x, **kw)
        end.record()
        record.append((start, end, time.perf_counter() - t, edges.HYSTERESIS_CHUNKS - chunks))
        return out

    def patched(x, **kw):
        if not three:
            return one(x, **kw)
        return tuple(torch.cat(t) for t in zip(*(one(part, **kw) for part in x.chunk(3))))

    losses.canny = patched
    try:
        yield
    finally:
        losses.canny = edges.canny


def metrics_phase(ir, vis, rgb, device, card):
    """``score_fusion`` at 512x512 on the card against the CPU port (numpy terms equal,
    SSIM/PSNR to 1e-5 relative), and its ms."""
    from swin_unet_image_fusion_tpu_torch.eval_metrics import score_fusion

    fused, a, b = rgb[0].mean(-1), ir[0], vis[0, ..., 0]
    got = score_fusion(fused, a, b, device=device)
    ref = score_fusion(fused, a, b, device="cpu")
    for key, value in ref.items():
        close = abs(got[key] - value) <= 1e-5 * abs(value) if key[:4] in ("SSIM", "PSNR") else got[key] == value
        if not close:
            raise AssertionError(f"score_fusion {key}: card {got[key]} vs CPU {value}")
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        score_fusion(fused, a, b, device=device)
        walls.append(1e3 * (time.perf_counter() - t))
    print(f"[metrics] score_fusion {SERVE_HW[0]}x{SERVE_HW[1]} (SSIM/PSNR on the card): "
          + ", ".join(f"{k} {v:.6g}" for k, v in got.items())
          + f"; equal to the CPU's (SSIM/PSNR to 1e-5); median {float(np.median(walls)):.1f} ms a call | {card}",
          flush=True)


def flops_phase(tiled_4k, card):
    """``model_flops_per_pair`` at 512x512, and the 4K tiled run's achieved fp32 rate."""
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.utils.flops import mfu, model_flops_per_pair

    per_tile = model_flops_per_pair(ModelConfig(), (TILE, TILE))["total"]
    seconds, tiles = tiled_4k
    achieved, share = mfu(tiles / seconds, per_tile, PEAK_FP32_FLOPS / 1e12)
    print(f"[flops] model_flops_per_pair {TILE}x{TILE}: {per_tile / 1e9:.3f} GFLOP; 2160x3840 in one pass "
          f"{model_flops_per_pair(ModelConfig(), TILED_SIZES['4K'])['total'] / 1e9:.3f} GFLOP; the 4K tiled run "
          f"({tiles} tiles in {seconds:.4f} s on the device) {achieved:.3f} TFLOP/s, {share:.2%} of the "
          f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s fp32 peak | {card}", flush=True)


def serving_eval_phases(flat, device, card):
    """``[colour]``, ``[test]``, ``[tiled]``, ``[canny]``, ``[metrics]`` and ``[flops]``."""
    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig

    phase = Phases()
    fuser = Fuser(Config(), flat, device=device)
    plain = Fuser(Config(model=ModelConfig(attention_impl="torch")), flat, device=device)
    cpu = Fuser(Config(), flat, device="cpu")
    ir, vis, rgb = colour_phase(fuser, plain, cpu, card)
    del fuser, plain, cpu
    torch.cuda.empty_cache()
    phase("[colour]")
    test_phase(flat, device, card)
    phase("[test]")
    tiled = tiled_phase(flat, device, card)
    phase("[tiled]")
    canny_phase(flat, device, card)
    phase("[canny]")
    metrics_phase(ir, vis, rgb, device, card)
    flops_phase(tiled["4K"], card)
    phase("[metrics] and [flops]")


# --------------------------------------------------------------- multi-device phases
DIST_CONFIGS = ("cuda", "cuda_pack", "cuda_block")
DIST_STEPS = 10  # timed steps of each form in turns (bare, data-parallel)
WORLD2_STEPS = 3  # data-parallel steps each rank of the gloo world 2 takes
SPATIAL_HW = (1792, 1792)  # every stage of the default model splits into whole window rows for 2-8 bands
SPATIAL_BANDS = 4
SPATIAL_ROUNDS = 10
DIST_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dist"
# a SpatialFuser forward under cuda_pack at 1792² on one rank: stages 0-3 pack (8 blocks and
# 4 halo re-partitions a stage pair's encoder and decoder side), stage 4 (C = 384) runs the
# composition
SPATIAL_LAUNCHES = {"K1 band": 32, "K2 halo": 32}


def one_rank_group(device):
    """An in-process NCCL group of one rank on ``device``, joined through a FileStore."""
    import torch.distributed as dist

    DIST_DIR.mkdir(parents=True, exist_ok=True)
    store = DIST_DIR / "store_world1"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    return dist.group.WORLD


def _step_outputs(state, terms):
    """(terms, {name: gradient}, BatchNorm running statistics) of a step, cloned."""
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters() if p.grad is not None}
    bn = state.model.final_head.bn
    return {k: float(v) for k, v in terms.items()}, grads, (bn.mean.clone(), bn.var.clone())


def _hold_step(got, ref, what):
    """A data-parallel step's terms (1e-5 relative), gradients (``assert_grads_close``) and
    BatchNorm statistics (atol 1e-5, rtol 1e-4) against a step on the global batch; returns
    (terms' largest relative difference, gradients' max_abs_err, statistics' max_abs_err,
    bit-equal gradients)."""
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    (terms, grads, stats), (ref_terms, ref_grads, ref_stats) = got, ref
    rel = max(abs(terms[k] - ref_terms[k]) / max(abs(ref_terms[k]), 1e-30) for k in ref_terms)
    if rel > 1e-5:
        raise AssertionError(f"{what}: loss terms {terms} against {ref_terms}")
    names = list(ref_grads)
    check = assert_grads_close([grads[n].to(ref_grads[n].device) for n in names],
                               [ref_grads[n] for n in names], names, what)
    stat_err = max((a.to(b.device) - b).abs().max().item() for a, b in zip(stats, ref_stats))
    for a, b in zip(stats, ref_stats):
        torch.testing.assert_close(a.to(b.device), b, atol=1e-5, rtol=1e-4)
    equal = all(torch.equal(grads[n].to(ref_grads[n].device), ref_grads[n]) for n in names)
    return rel, check.worst, stat_err, equal


def dist_world1_phase(flat, device, card, group):
    """``[dist] world 1``: the data-parallel step (``make_train_step(cfg, group)``) over a
    one-rank NCCL group at 224² batch 20 under each kernel configuration: its first step
    with exact launches, held to the bare step's (terms, gradients, BatchNorm statistics),
    then DIST_STEPS steps of the two in turns with the overhead over the bare step, each
    step's wall and the host's time until the step returns (the device still running), and
    one step of each traced: the overhead split into device time by kernel family and the
    device's idle time."""
    from swin_unet_image_fusion_tpu_torch import Config, ModelConfig
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED)
    ir = torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
    vis = torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
    medians = {}
    for impl in DIST_CONFIGS:
        cfg = Config(model=ModelConfig(attention_impl=impl))
        forms = {"bare": make_train_step(cfg), "data-parallel": make_train_step(cfg, group)}
        states = {name: create_train_state(cfg, flat, iters_per_epoch=100, device=device) for name in forms}
        first = {}
        for name, step in forms.items():
            torch.cuda.synchronize()
            reset_counts()
            terms = step(states[name], ir, vis)
            torch.cuda.synchronize()
            got = read_counts(impl)
            expected = {k: 0 for k in got}
            expected.update(TRAIN_CONFIGS[impl])
            if got != expected:
                raise AssertionError(f"[dist] {impl} {name} step: launches {got}, expected {expected}")
            first[name] = _step_outputs(states[name], terms)
        rel, gerr, serr, equal = _hold_step(first["data-parallel"], first["bare"], f"[dist] {impl}")
        print(f"[dist] world 1 {impl} data-parallel step 1 against the bare step: launches "
              f"{TRAIN_CONFIGS[impl]}, loss terms max relative difference {rel:.3e}, gradients "
              f"max_abs_err {gerr:.3e} (bit-equal {equal}), BatchNorm statistics max_abs_err "
              f"{serr:.3e}", flush=True)
        walls = {name: [] for name in forms}
        hosts = {name: [] for name in forms}
        for _ in range(DIST_STEPS):
            for name, step in forms.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(states[name], ir, vis)
                hosts[name].append(1e3 * (time.perf_counter() - t))
                torch.cuda.synchronize()
                walls[name].append(1e3 * (time.perf_counter() - t))
        med = {name: float(np.median(w)) for name, w in walls.items()}
        host = {name: float(np.median(w)) for name, w in hosts.items()}
        medians[impl] = med
        dp = med["data-parallel"]
        print(f"[dist] world 1 {impl} 224x224 bs={TRAIN_BATCH}, {DIST_STEPS} steps in turns: bare "
              f"{med['bare']:.2f} ms/step, data-parallel {dp:.2f} ({100 * (dp / med['bare'] - 1):+.2f}%); "
              f"host time until the step returns: bare {host['bare']:.2f}, data-parallel "
              f"{host['data-parallel']:.2f} ms; all steps: "
              + "; ".join(f"{n} " + ", ".join(f"{v:.2f}" for v in w) for n, w in walls.items())
              + f" | {card}", flush=True)
        busy = {}
        for name, step in forms.items():
            kernels = trace(f"[dist] world 1 {impl} {name} step", f"{impl} {name}",
                            lambda: step(states[name], ir, vis), med[name], card)
            busy[name] = sum(ms for _, ms in kernels.values()) if kernels else None
        if None not in busy.values():
            extra = dp - med["bare"]
            dev = busy["data-parallel"] - busy["bare"]
            print(f"[dist] world 1 {impl} the data-parallel step's {extra:+.2f} ms over the bare step: "
                  f"device busy {busy['data-parallel']:.2f} against {busy['bare']:.2f} ms ({dev:+.2f}), "
                  f"device idle {dp - busy['data-parallel']:.2f} against "
                  f"{med['bare'] - busy['bare']:.2f} ms ({extra - dev:+.2f}) | {card}", flush=True)
        del forms, states, first
        torch.cuda.empty_cache()
    return medians


def dist_worker(rank: int, store: str, out: str) -> int:
    """One rank of ``[dist] world 2``: a gloo group of two processes on the one card, each
    taking WORLD2_STEPS data-parallel steps of the default model under ``"auto"`` at local batch
    TRAIN_BATCH / 2 (its half of the global batch); rank 0 saves its first step's terms,
    gradients and BatchNorm statistics, and every rank its step times."""
    import torch.distributed as dist
    from swin_unet_image_fusion_tpu_torch import Config
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    try:
        cfg = Config()
        state = create_train_state(cfg, random_variables(cfg.model, seed=SEED), iters_per_epoch=100,
                                   device=DEVICE)
        step = make_train_step(cfg, dist.group.WORLD)
        rng = np.random.default_rng(SEED)
        half = TRAIN_BATCH // 2
        ir, vis = (torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)
                                    [rank * half:(rank + 1) * half]).to(DEVICE) for _ in range(2))
        walls, first = [], None
        for i in range(WORLD2_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            terms = step(state, ir, vis)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t))
            if i == 0:
                first = _step_outputs(state, terms)
        terms, grads, stats = first
        torch.save({"terms": terms, "grads": {k: v.cpu() for k, v in grads.items()},
                    "stats": [s.cpu() for s in stats], "walls": walls}, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def dist_world2_phase(flat, device, card):
    """``[dist] world 2``: the data-parallel step over a gloo group of two processes on the one card
    (``dist_worker``), rank 0's first step held to the one-process step on the global batch
    of TRAIN_BATCH under ``"auto"``; the step times beside the bare global-batch step's."""
    import subprocess as sp

    from swin_unet_image_fusion_tpu_torch import Config
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(SEED)
    ir, vis = (torch.from_numpy(rng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
               for _ in range(2))
    cfg = Config()
    state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
    step = make_train_step(cfg)
    terms = step(state, ir, vis)
    ref = _step_outputs(state, terms)
    walls = []
    for _ in range(WORLD2_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, ir, vis)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    del state, step
    torch.cuda.empty_cache()

    DIST_DIR.mkdir(parents=True, exist_ok=True)
    store = DIST_DIR / "store_world2"
    store.unlink(missing_ok=True)
    outs = [DIST_DIR / f"world2_rank{r}.pt" for r in range(2)]
    procs = [sp.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-worker", str(r), str(store),
                       str(outs[r])], stdout=sp.PIPE, stderr=sp.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"[dist] world 2 rank {r} failed (gloo on CUDA tensors):\n{log[-4000:]}")
    saved = [torch.load(o, weights_only=False) for o in outs]
    got = (saved[0]["terms"], saved[0]["grads"], tuple(saved[0]["stats"]))
    rel, gerr, serr, equal = _hold_step(got, ref, "[dist] world 2 rank 0")
    print(f"[dist] world 2 (gloo, two processes on the one card, local batch {TRAIN_BATCH // 2}) data-parallel step 1 "
          f"of rank 0 against the one-process step on the global batch {TRAIN_BATCH}: loss terms max "
          f"relative difference {rel:.3e}, gradients max_abs_err {gerr:.3e} (bit-equal {equal}), "
          f"BatchNorm statistics max_abs_err {serr:.3e}", flush=True)
    for r, s in enumerate(saved):
        print(f"[dist] world 2 rank {r} step walls " + ", ".join(f"{v:.2f}" for v in s["walls"])
              + f" ms (median of steps 2-{WORLD2_STEPS} {float(np.median(s['walls'][1:])):.2f}); the bare "
              f"one-process step on the global batch {float(np.median(walls)):.2f} ms "
              f"({', '.join(f'{v:.2f}' for v in walls)}) | {card}", flush=True)
    for o in outs:
        o.unlink(missing_ok=True)
    store.unlink(missing_ok=True)


def _band_cases(cfg, device, dtype):
    """(stage, h, w, c, heads, d, hidden, shift, cross, x windows in the block's geometry,
    weights) of every packed block of a SPATIAL_HW request's encoder role, in ``dtype``."""
    from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_beneficial, pack_windows

    for k, h, w, c, heads, d in stage_geometries(cfg, SPATIAL_HW):
        if not pack_beneficial(c, w):
            continue
        hidden = mlp_hiddens(cfg, k)[0][1]
        x, *weights = block_inputs(h, w, c, heads, d, hidden, SEED + 40 + k, device)
        for shift in (False, True):
            for cross in (False, True):
                xw = pack_windows(x.to(dtype), WINDOW, shift).contiguous()
                yield k, h, w, c, heads, d, hidden, shift, cross, xw, weights


def halo_cat_form(part, halo, hw, window, from_shift, to_shift):
    """K2's halo form as it was first built: the band concatenated with the halo row, K2
    launched on that (n + 1)-row map, the halo row's output dropped by a copy (three passes
    and launches); kept for the timings in turns."""
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
    from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd

    side = spmd.halo_side(from_shift, to_shift)
    rows, w = spmd.band_hw(part, hw, window)
    ext = spmd._extended(part, halo, side, w // window[1])
    out = twp._launch(ext, (rows + window[0], w), window, from_shift, to_shift)
    return spmd._drop_halo(out, w // window[1], side)


def halo_bound_ms(n_rows, w, c, dtype):
    """Least time for one K2 halo launch on a band of ``n_rows`` window rows of a map ``w``
    wide (both streams): each output token copies one source token (of the band or of the
    halo row), read once and written once, so the band's n rows are read and written."""
    return repartition_bound_ms(n_rows * WINDOW[0], w, c, dtype=dtype)[0]



def check_band_forms(cfg, device, card):
    """``[spatial]``: for SPATIAL_BANDS bands of each packed stage map of a SPATIAL_HW
    request, fp32 and bf16, the K1 band form (every shift/cross block) and the K2 halo form
    (both directions) against the whole map's launch's matching windows (bit-equal) and
    against their plain versions; each band's time beside its plain version, the bound and,
    for K2, index_select's. The ms of a band are summed over a rank's launches of one
    request (each block twice, encoder and decoder side; each re-partition direction four
    times a stage). K2 halo: one launch a call by its counter and one operation on the stream,
    a kernel (no concatenation or copy: :func:`graph_operations`), the kernels' names by the
    profiler where it reads them, timed in turns with its first form
    (:func:`halo_cat_form`) and index_select on the extended map, by CUDA events and with the
    launch queue filled ahead, its device time by the profiler (a case it does not read
    stays out of the sum and of the bound held to it) and its host µs a call."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops import window_pack as twp
    from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd
    from swin_unet_image_fusion_tpu_torch.parallel.spatial import split_rows

    worst, times = {}, {}
    for dtype in (torch.float32, BF16):
        k1, k2 = f"K1 band{tag(dtype)}", f"K2 halo{tag(dtype)}"
        worst[k1] = worst[k2] = 0.0
        t1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None)
        t2 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
        bound_by = "bytes"
        for k, h, w, c, heads, d, hidden, shift, cross, xw, weights in _band_cases(cfg, device, dtype):
            kw = dict(window=WINDOW, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
            whole = tfb.fused_block(xw, *weights, layout="windows", hw=(h, w), **kw)
            nw = w // WINDOW[1]
            bands = split_rows(h // WINDOW[0], SPATIAL_BANDS)
            for r, (lo, hi) in enumerate(bands):
                part = xw[:, :, lo * nw:hi * nw].contiguous()
                out = spmd.fused_block_band(part, *weights, hw=(h, w), row0=lo, **kw)
                torch.cuda.synchronize()
                if not torch.equal(out, whole[:, :, lo * nw:hi * nw]):
                    err = (out.float() - whole[:, :, lo * nw:hi * nw].float()).abs().max().item()
                    raise AssertionError(f"K1 band{tag(dtype)} stage {k} band {r} shift={shift} cross={cross}: "
                                         f"not bit-equal to the whole map's windows (max_abs_err {err:.3e})")
                ref = spmd.fused_block_band_plain(part, *weights, hw=(h, w), row0=lo, **kw)
                err, _ = compare_kernel(out, ref, f"[k1 band{tag(dtype)}] stage {k} {h}x{w} band {r} rows "
                                                  f"{lo}-{hi} shift={shift} cross={cross}")
                worst[k1] = max(worst[k1], err)
                if r == 1:  # a middle band (row seam off under shift): the rank's time
                    ms = time_ms(lambda: spmd.fused_block_band(part, *weights, hw=(h, w), row0=lo, **kw), 20)
                    full = time_ms(lambda: tfb.fused_block(xw, *weights, layout="windows", hw=(h, w), **kw), 10)
                    plain = time_ms(lambda: spmd.fused_block_band_plain(part, *weights, hw=(h, w), row0=lo,
                                                                        **kw), 3)
                    bound, bound_by = block_bound_ms((hi - lo) * WINDOW[0], w, c, heads, d, hidden,
                                                     dtype=dtype, layout="windows")
                    print(f"[time] K1 band{tag(dtype)} stage {k} {h}x{w} C={c} shift={shift} cross={cross}, band "
                          f"{r} of {SPATIAL_BANDS} ({hi - lo} window rows): {ms:.4f} ms, the whole map "
                          f"{full:.4f} ms ({ms / full:.3f} of it), plain {plain:.4f} ms, bound {bound:.4f} ms "
                          f"({bound_by}) | {card}", flush=True)
                    for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound)):
                        t1[key] += 2 * v
            del whole
        t2.update(cat_ms=0.0, device_ms=0.0, read_bound_ms=0.0, queued_ms=0.0, cat_queued_ms=0.0,
                  library_queued_ms=0.0)
        unread = cases = 0
        for k, h, w, c, from_shift, xw, perm in repartition_cases(cfg, device, SPATIAL_HW, dtype=dtype):
            whole = twp.repartition_windows(xw, (h, w), WINDOW, from_shift, not from_shift)
            nh, nw = h // WINDOW[0], w // WINDOW[1]
            side = spmd.halo_side(from_shift, not from_shift)
            for r, (lo, hi) in enumerate(split_rows(nh, SPATIAL_BANDS)):
                row = (lo - 1) % nh if side < 0 else hi % nh
                part, halo = xw[:, :, lo * nw:hi * nw].contiguous(), xw[:, :, row * nw:(row + 1) * nw].contiguous()
                args = ((h, w), WINDOW, from_shift, not from_shift)
                out = spmd.repartition_halo(part, halo, *args)
                torch.cuda.synchronize()
                ref = spmd.repartition_halo_plain(part, halo, *args)
                if not (torch.equal(out, whole[:, :, lo * nw:hi * nw]) and torch.equal(out, ref)
                        and torch.equal(halo_cat_form(part, halo, *args), ref)):
                    raise AssertionError(f"K2 halo{tag(dtype)} stage {k} band {r} shift {from_shift}: not bit-equal")
                if r == 1:
                    ext = spmd._extended(part, halo, side, nw)
                    rows = (hi - lo + 1) * WINDOW[0]
                    ids = torch.arange(rows * w, dtype=torch.float32, device=device).reshape(1, 1, -1, T, 1)
                    eperm = twp.repartition_windows_plain(ids, (rows, w), WINDOW, from_shift,
                                                          not from_shift).reshape(-1).long()
                    call = functools.partial(spmd.repartition_halo, part, halo, *args)
                    cat_form = functools.partial(halo_cat_form, part, halo, *args)
                    before = spmd.HALO_LAUNCHES + spmd.BF16_HALO_LAUNCHES
                    call()
                    counted = spmd.HALO_LAUNCHES + spmd.BF16_HALO_LAUNCHES - before
                    operations, cat_operations = graph_operations(call), graph_operations(cat_form)
                    if counted != 1 or operations != ["kernel"]:
                        raise AssertionError(f"K2 halo{tag(dtype)} stage {k}: a call counted {counted} launches and "
                                             f"put {operations} on its stream, not one kernel")
                    kernels, cat_kernels = device_kernels(call), device_kernels(cat_form)
                    library_call = functools.partial(repartition_library, ext, eperm)
                    ms, cat_ms, library = _turns((call, cat_form, library_call), 50, 3)
                    queued = _queued_turns((call, cat_form, library_call), 20)
                    full = time_ms(lambda: twp.repartition_windows(xw, (h, w), WINDOW, from_shift,
                                                                   not from_shift), 50)
                    plain = time_ms(lambda: spmd.repartition_halo_plain(part, halo, *args), 10)
                    dev = kernel_ms(call, 20)
                    bound = halo_bound_ms(hi - lo, w, c, dtype)
                    print(f"[time] K2 halo{tag(dtype)} stage {k} {h}x{w} C={c} shift {from_shift} -> "
                          f"{not from_shift}, band {r} of {SPATIAL_BANDS} ({hi - lo} window rows and the halo row): "
                          f"{ms:.4f} ms, the concatenation form in turns {cat_ms:.4f} ms, index_select on the "
                          f"extended map in turns {library:.4f} ms; the whole map {full:.4f} ms ({ms / full:.3f} of "
                          f"it), plain {plain:.4f} ms; with the launch queue filled ahead {queued[0]:.4f} ms, the "
                          f"concatenation form {queued[1]:.4f} ms, index_select {queued[2]:.4f} ms; device time "
                          f"{'not read' if dev is None else f'{dev:.4f} ms'} (profiler), bound {bound:.4f} ms "
                          f"(bytes); a call's operations (a captured CUDA graph's nodes) {operations}, the "
                          f"concatenation form's {cat_operations}; their kernels by the profiler (None: not read) "
                          f"{kernels} and {cat_kernels} | {card}", flush=True)
                    cases += 1
                    unread += dev is None
                    for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound), ("library_ms", library),
                                   ("cat_ms", cat_ms), ("queued_ms", queued[0]), ("cat_queued_ms", queued[1]),
                                   ("library_queued_ms", queued[2])):
                        t2[key] += 4 * v
                    if dev is not None:  # an unread case stays out of the device sum and of its bound
                        t2["device_ms"] += 4 * dev
                        t2["read_bound_ms"] += 4 * bound
                    if k == 0 and from_shift:
                        us = host_us((call, cat_form, lambda: repartition_library(ext, eperm)))
                        print(f"[host] K2 halo{tag(dtype)} stage {k}: {us[0]:.2f} us a call of repartition_halo, the "
                              f"concatenation form {us[1]:.2f} us, index_select {us[2]:.2f} us; medians of 5 rounds in "
                              f"turns of 200 calls each, no sync | {card}", flush=True)
            del whole
        share = t2["read_bound_ms"] / t2["device_ms"] if t2["device_ms"] else float("nan")
        print(f"[time] K2 halo{tag(dtype)} a rank's 32 launches of a {SPATIAL_HW[0]}x{SPATIAL_HW[1]} request in "
              f"{SPATIAL_BANDS} bands: {t2['ms']:.4f} ms by events, the concatenation form in turns "
              f"{t2['cat_ms']:.4f} ms, index_select {t2['library_ms']:.4f} ms; with the launch queue filled ahead "
              f"{t2['queued_ms']:.4f} ms, {t2['cat_queued_ms']:.4f} ms and {t2['library_queued_ms']:.4f} ms; bound "
              f"{t2['bound_ms']:.4f} ms ({t2['bound_ms'] / t2['ms']:.1%} of the time by events, "
              f"{t2['bound_ms'] / t2['queued_ms']:.1%} with the queue filled); device time {t2['device_ms']:.4f} ms "
              f"(profiler) over the {cases - unread} of {cases} cases read, {share:.1%} of their bound "
              f"{t2['read_bound_ms']:.4f} ms | {card}", flush=True)
        for key in ("cat_ms", "device_ms", "read_bound_ms", "queued_ms", "cat_queued_ms", "library_queued_ms"):
            del t2[key]
        print(f"[check] K1 band{tag(dtype)} and K2 halo{tag(dtype)}: every band of {SPATIAL_BANDS} at every packed "
              f"stage of {SPATIAL_HW[0]}x{SPATIAL_HW[1]} bit-equal to the whole map's launch; K1 band against its "
              f"plain version max_abs_err {worst[k1]:.3e}, K2 halo bit-exact", flush=True)
        times[k1] = dict(t1, bound_by=bound_by)
        times[k2] = dict(t2, bound_by="bytes")
        torch.cuda.empty_cache()
    return worst, times


def spatial_phase(flat, device, card, group):
    """``[spatial]``: the band forms (:func:`check_band_forms`), then ``SpatialFuser`` under
    ``cuda_pack`` over the one-rank group at SPATIAL_HW: every stage banded, exact launches,
    against ``Fuser.fuse_y`` under ``cuda_pack`` and the torch composition on the card, timed
    in turns with ``fuse_y``. Returns the kernels' worst errors, times and the main path's
    launches."""
    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
    from swin_unet_image_fusion_tpu_torch.ops import window_pack_spmd as spmd
    from swin_unet_image_fusion_tpu_torch.parallel.spatial import SpatialFuser

    worst, times = check_band_forms(ModelConfig(), device, card)
    cfg = ModelConfig(attention_impl="cuda_pack")
    fuser = SpatialFuser(cfg, flat, group, device=device)
    rng = np.random.default_rng(SEED + 50)
    ir, vis = (rng.random((1, *SPATIAL_HW, 1), dtype=np.float32) for _ in range(2))
    torch.cuda.synchronize()
    reset_counts()
    spmd.BAND_LAUNCHES = spmd.HALO_LAUNCHES = 0
    out = fuser.fuse(ir, vis)
    torch.cuda.synchronize()
    launches = {"K1 band": spmd.BAND_LAUNCHES, "K2 halo": spmd.HALO_LAUNCHES}
    others = {k: v for k, v in read_counts("cuda_pack").items() if v}
    if launches != SPATIAL_LAUNCHES or others:
        raise AssertionError(f"SpatialFuser at {SPATIAL_HW}: launches {launches} and {others}, expected "
                             f"{SPATIAL_LAUNCHES} and no other kernel")
    if any(p[2] != "banded" for p in fuser.partitions):
        raise AssertionError(f"SpatialFuser at {SPATIAL_HW}: a stage ran replicated: {fuser.partitions}")
    whole = fuser.gather_rows(out, SPATIAL_HW[0]).cpu().numpy()
    check_fused(whole, (1, *SPATIAL_HW, 1))
    one = Fuser(Config(model=cfg), flat, device=device)
    plain = Fuser(Config(model=ModelConfig(attention_impl="torch")), flat, device=device)
    errs = {}
    for name, f in (("fuse_y cuda_pack", one), ("the torch composition", plain)):
        ref = f.fuse_y(ir, vis)
        errs[name] = float(np.abs(whole - ref).max())
        np.testing.assert_allclose(whole, ref, atol=MODEL_ATOL, rtol=MODEL_RTOL)
    del plain
    torch.cuda.empty_cache()
    walls = {"SpatialFuser": [], "fuse_y": []}
    dev_ir, dev_vis = (torch.from_numpy(a).to(device) for a in (ir, vis))
    for _ in range(SPATIAL_ROUNDS):
        for name, fn in (("SpatialFuser", lambda: fuser.fuse(dev_ir, dev_vis)),
                         ("fuse_y", lambda: forward_on_device(one, dev_ir, dev_vis))):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t))
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[spatial] SpatialFuser cuda_pack {SPATIAL_HW[0]}x{SPATIAL_HW[1]} over one rank: every stage banded "
          f"({len(fuser.partitions)} stage pairs), launches {launches}, no other kernel; against "
          + ", ".join(f"{k} max_abs_err {v:.3e}" for k, v in errs.items())
          + f"; {med['SpatialFuser']:.2f} ms a pair against fuse_y's {med['fuse_y']:.2f} ms, {SPATIAL_ROUNDS} "
          f"calls each in turns (" + "; ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in w) for k, w in walls.items())
          + f") | {card}", flush=True)
    busy = {}
    for name, fn in (("SpatialFuser", lambda: fuser.fuse(dev_ir, dev_vis)),
                     ("fuse_y", lambda: forward_on_device(one, dev_ir, dev_vis))):
        kernels = trace(f"[spatial] {name} cuda_pack {SPATIAL_HW[0]}x{SPATIAL_HW[1]} over one rank", name,
                        fn, med[name], card)
        busy[name] = sum(ms for _, ms in kernels.values()) if kernels else None
    if None not in busy.values():
        extra = med["SpatialFuser"] - med["fuse_y"]
        dev = busy["SpatialFuser"] - busy["fuse_y"]
        print(f"[spatial] SpatialFuser's {extra:+.2f} ms over fuse_y: device busy {busy['SpatialFuser']:.2f} "
              f"against {busy['fuse_y']:.2f} ms ({dev:+.2f}), device idle "
              f"{med['SpatialFuser'] - busy['SpatialFuser']:.2f} against {med['fuse_y'] - busy['fuse_y']:.2f} "
              f"ms ({extra - dev:+.2f}) | {card}", flush=True)
    del fuser, one
    torch.cuda.empty_cache()
    return worst, times, launches


def forward_on_device(fuser, ir, vis):
    """``fuse_y``'s forward on device-resident inputs (no transfer)."""
    from swin_unet_image_fusion_tpu_torch.infer import fused_y

    with torch.inference_mode():
        return fused_y(fuser.model, ir, vis)


def tiled_ranks_phase(flat, device, card, group):
    """``[tiled] world 1``: ``TiledFuser`` over the one-rank group at 2048² (tile 512, overlap
    64, chunks of 32) against the fuser without a group, timed in turns."""
    from swin_unet_image_fusion_tpu_torch import ModelConfig
    from swin_unet_image_fusion_tpu_torch.parallel.tiled import TiledFuser

    h, w = TILED_SIZES["2K"]
    fusers = {"group of one": TiledFuser(ModelConfig(), flat, TILE, OVERLAP, TILED_BATCH, device=device, group=group),
              "no group": TiledFuser(ModelConfig(), flat, TILE, OVERLAP, TILED_BATCH, device=device)}
    rng = np.random.default_rng(SEED + 60)
    ir, vis = (torch.from_numpy(rng.random((h, w, 1), dtype=np.float32)).to(device) for _ in range(2))
    outs = {name: f.fuse_on_device(ir, vis) for name, f in fusers.items()}
    err = (outs["group of one"] - outs["no group"]).abs().max().item()
    torch.testing.assert_close(outs["group of one"], outs["no group"], atol=1e-6, rtol=0)
    walls = {name: [] for name in fusers}
    for _ in range(TILED_ROUNDS):
        for name, f in fusers.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            f.fuse_on_device(ir, vis)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t)
    print(f"[tiled] world 1 {h}x{w}: TiledFuser over a one-rank NCCL group against no group max_abs_err "
          f"{err:.3e} (bit-equal {torch.equal(outs['group of one'], outs['no group'])}); "
          + ", ".join(f"{name} {float(np.median(v)):.4f} s" for name, v in walls.items())
          + f" on the device, {TILED_ROUNDS} calls each in turns | {card}", flush=True)
    del fusers, outs
    torch.cuda.empty_cache()


def multi_device_phases(flat, device, card):
    """``[dist] world 1``, ``[dist] world 2``, ``[spatial]`` and ``[tiled] world 1``. Returns
    the band forms' worst errors, times and the main path's launches."""
    import torch.distributed as dist

    phase = Phases()
    group = one_rank_group(device)
    try:
        dist_world1_phase(flat, device, card, group)
        phase("[dist] world 1")
        dist_world2_phase(flat, device, card)
        phase("[dist] world 2")
        result = spatial_phase(flat, device, card, group)
        phase("[spatial]")
        tiled_ranks_phase(flat, device, card, group)
        phase("[tiled] world 1")
    finally:
        dist.destroy_process_group()
    return result


# ---- the relu and gelu MLP forms of K1 and K4 ----------------------------------------------
ACTIVATIONS = ("relu", "gelu")  # the forms beside the default model's ELU
ACT_HW, ACT_BATCH = (224, 224), 2  # the kernel checks' stage shapes: stage 0 (fused) and stage 2 (split)
ACT_FIVE = (28, 28, 128, 8, 16, 512)  # (H, W, C, heads, d, hidden): C = 128 with 8 heads of 16 routes "five"
ACT_ITERS = 10  # timed calls of each form, in turns with the ELU form


def _act_counts():
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    return dict(tfb.ACTIVATION_LAUNCHES), dict(tfb.ACTIVATION_BWD_LAUNCHES)


def _reset_act_counts():
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb

    reset_counts()
    for counts in (tfb.ACTIVATION_LAUNCHES, tfb.ACTIVATION_BWD_LAUNCHES):
        for act in counts:
            counts[act] = 0


def _act_cases(device):
    """(label, case, x, weights) of the activation checks: the encoder block of stages 0 and
    2 of a 224² batch-2 step with shift and cross, and the five route's shape."""
    from swin_unet_image_fusion_tpu_torch import ModelConfig

    for case, x, weights in block_cases(ModelConfig(), device, False, ACT_HW, ACT_BATCH, stages=(0, 2)):
        k, *_, role, _, shift, cross = case
        if role == "enc" and shift and cross:
            yield f"stage {k}", case, x, weights
    h, w, c, heads, d, hidden = ACT_FIVE
    x, *weights = block_inputs(h, w, c, heads, d, hidden, SEED + 70, device, ACT_BATCH)
    yield "five-route shape", (5, h, w, c, heads, d, "enc", hidden, True, True), x, weights


RELU_MARGIN = 1e-5  # |z| below which the kernel's and the plain version's relu' may differ


def relu_cotangent(g, x, weights, kw):
    """``g`` with its windows zeroed wherever a pre-activation of the MLP lies within
    RELU_MARGIN of 0 (by the plain version's z), in both streams. relu' jumps at 0, and the
    kernel's and the plain version's z differ by rounding (~1e-6), so such a unit may take the
    other side; its g_pre then differs by g_h, and the attention's backward spreads that over
    its window (under cross the other stream's too). With no gradient through those windows,
    the kernel and the plain backward compute the same function. Returns (g, the share of
    (image, window) pairs zeroed)."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.ops.window_pack import pack_windows, unpack_windows

    seen = []
    mlp_out = tfb._mlp_out

    def spy(z, *args):
        seen.append(z.abs().amin(dim=(0, 3, 4)))  # (B, nWin) of the block's windows
        return mlp_out(z, *args)

    tfb._mlp_out = spy
    try:
        with torch.no_grad():
            tfb.fused_block_plain(x, *weights, **kw)
    finally:
        tfb._mlp_out = mlp_out
    near = seen[0] < RELU_MARGIN
    image = kw["layout"] == "image"
    gw = pack_windows(g, WINDOW, kw["shift"]) if image else g.clone()
    gw[:, near] = 0
    g = unpack_windows(gw, tuple(g.shape[2:4]), WINDOW, kw["shift"]) if image else gw
    return g.contiguous(), near.float().mean().item()


def check_activation_kernels(device, card):
    """``[act]``: every relu and gelu form of K1 (windows layout) and K4 (image layout) against
    its plain version on the same inputs, each repeated bit for bit: the forward in fp32 and bf16
    at stage 0 (the one-launch route) and stage 2 (the split route), its dropout form (every rate
    0.1), the backward on the fused (stage 0), split (stage 2) and five (C = 128, 8 heads of 16)
    routes and its dropout form at stages 0 and 2; at the five route's shape also the five-launch
    forward it recomputes with. Each form timed in turns with the ELU form at the same shape.
    Returns the worst errors and times by kernel-line key ("K4 gelu", "K1 relu bwd", ...)."""
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    worst, times = {}, {}

    def tally(key, err, ms, elu_ms, plain, bound, bound_by):
        t = times.setdefault(key, dict(ms=0.0, elu_ms=0.0, plain_ms=0.0, bound_ms=0.0, by={}, library_ms=None))
        t["ms"] += ms
        t["elu_ms"] += elu_ms
        t["plain_ms"] += plain
        t["bound_ms"] += bound
        t["by"][bound_by] = t["by"].get(bound_by, 0.0) + bound
        worst[key] = max(worst.get(key, 0.0), err)

    drop = dict(drop_rates=DROP_RATIOS, drop_seed=DROP_SEED)
    for label, case, x, weights in _act_cases(device):
        k, h, w, c, heads, d, role, hidden, shift, cross = case
        five = k == 5
        expected = "five" if five else "fused" if k < 2 else "split"
        for name, layout in (("K1", "windows"), ("K4", "image")):
            xl, kw = fused_args(case, x, layout)
            g0 = torch.randn(xl.shape, generator=torch.Generator().manual_seed(SEED + k)).to(device)
            shape = f"{label} {h}x{w}x{ACT_BATCH} C={c} heads={heads} d={d} hidden={hidden}"
            for act in ACTIVATIONS:
                kwa, elu = dict(kw, activation=act), dict(kw, activation="elu")
                forms = [("bwd", False, torch.float32), ("drop bwd", True, torch.float32)] if not five else [
                    ("bwd", False, torch.float32)]
                fwd = [] if five else [("", False, torch.float32), (" bf16", False, BF16), (" drop", True, torch.float32)]
                for suffix, dropping, dtype in fwd:
                    a = dict(kwa, **drop) if dropping else kwa
                    e = dict(elu, **drop) if dropping else elu
                    xd = xl.to(dtype)
                    out, again = tfb.fused_block(xd, *weights, **a), tfb.fused_block(xd, *weights, **a)
                    torch.cuda.synchronize()
                    what = f"[act] {name} {act}{suffix} {shape}"
                    err, _ = compare_kernel(out, tfb.fused_block_plain(xd, *weights, **a), what)
                    if not torch.equal(out, again):
                        raise AssertionError(f"{what}: a repeat gave other bits")
                    elu_ms, ms = _in_turns(lambda: tfb.fused_block(xd, *weights, **e),
                                           lambda: tfb.fused_block(xd, *weights, **a), ACT_ITERS, 2)
                    plain = time_ms(lambda: tfb.fused_block_plain(xd, *weights, **a), iters=2, warmup=1)
                    ops = tfb.block_fwd_plan(c, heads, d, hidden, WINDOW, cross, tfb.rounds_operands(dtype, layout),
                                             dropping)
                    bound, bound_by = block_bound_ms(h, w, c, heads, d, hidden, ACT_BATCH, dtype=dtype, layout=layout)
                    print(f"[time] {name} {act}{suffix} {shape} ({ops.route}): {ms:.4f} ms, ELU form {elu_ms:.4f} ms "
                          f"in turns, plain {plain:.4f} ms, bound {bound:.4f} ms ({bound_by}) | {card}", flush=True)
                    tally(f"{name} {act}{' bf16' if dtype == BF16 else ''}" if not dropping else f"{name} {act} drop",
                          err, ms, elu_ms, plain, bound, bound_by)
                if five:
                    out = tfb._launch_five(xl, weights, kwa)
                    compare_kernel(out, tfb.fused_block_plain(xl, *weights, **kwa),
                                   f"[act] {name} {act} five launches {shape}")
                for suffix, dropping, dtype in forms:
                    a = dict(kwa, **drop) if dropping else kwa
                    e = dict(elu, **drop) if dropping else elu
                    route = tfb.block_bwd_plan(c, heads, d, hidden, WINDOW, cross, dropping).route
                    what = f"[act] {name} {act} {suffix} {shape} ({route})"
                    if route != expected:
                        raise AssertionError(f"{what}: the plan routes {route!r}, expected {expected!r}")
                    g = g0
                    if act == "relu":
                        g, zeroed = relu_cotangent(g0, xl, weights, a)
                        what += f", g zeroed on {zeroed:.2%} of the windows (relu' at |z| < {RELU_MARGIN})"
                    got, again = tfb._launch_bwd(g, xl, weights, a), tfb._launch_bwd(g, xl, weights, a)
                    torch.cuda.synchronize()
                    if not all(torch.equal(p, q) for p, q in zip(got, again)):
                        raise AssertionError(f"{what}: a repeat gave other bits")
                    del again
                    check = assert_grads_close(got, tfb.fused_block_bwd_plain(g, xl, *weights, **a),
                                               ("x", *tfb.WEIGHT_NAMES), what)
                    del got
                    print(f"{what}: max_abs_err {check.worst:.3e}, {check.worst_own:.3e} of a gradient's own "
                          f"largest; repeated bit for bit", flush=True)
                    elu_ms, ms = _in_turns(lambda: tfb._launch_bwd(g, xl, weights, e),
                                           lambda: tfb._launch_bwd(g, xl, weights, a), ACT_ITERS // 2, 1)
                    plain = time_ms(lambda: tfb.fused_block_bwd_plain(g, xl, *weights, **a), iters=2, warmup=1)
                    bound, bound_by = block_bound_ms(h, w, c, heads, d, hidden, ACT_BATCH, backward=True)
                    print(f"[time] {name} {act} {suffix} {shape} ({route}): {ms:.4f} ms, ELU form {elu_ms:.4f} ms "
                          f"in turns, plain {plain:.4f} ms, bound {bound:.4f} ms ({bound_by}) | {card}", flush=True)
                    tally(f"{name} {act} {suffix}", check.worst, ms, elu_ms, plain, bound, bound_by)
        torch.cuda.empty_cache()
    for key in sorted(times):
        t = times[key]
        t["bound_by"] = max(t.pop("by").items(), key=lambda kv: kv[1])[0]
        print(f"[check] {key}: worst max_abs_err {worst[key]:.3e}; summed over its cases {t['ms']:.4f} ms, the ELU "
              f"form in turns {t['elu_ms']:.4f} ms ({t['ms'] / t['elu_ms'] - 1:+.1%}), plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms | {card}", flush=True)
    return worst, times


# an activation step's gradients against the plain step's: each within STEP_NORM of the reference
# in the L2 norm, and at most STEP_FAR of all elements off by more than 1e-3 of their tensor's largest
STEP_NORM = {"relu": 5e-2, "gelu": 1e-3}
STEP_FAR = {"relu": 1e-2, "gelu": 1e-4}


def step_grads(grads, ref_grads, act, what):
    """An activation train step's gradients against the step on the fused block's plain version,
    by norm and by the share of far elements, not element by element: at the default batch a few
    gradients that cancellation makes tiny (stage 2's bias tables, ~1e-6) miss the elementwise
    tolerance under gelu by up to 2.5x (the erf and exp of the kernels and of torch differ in
    the last place; an NVIDIA H100), and under relu relu' jumps at 0: the kernels recompute z in
    another order than the plain version (~1e-6 apart), so the units within rounding of 0 among a
    step's ~10^9 may take the other side, each moving g of its window's tokens (both streams) and
    so the gradients of every layer below it (5e-4 to 1.4e-3 of a bias table's norm on an NVIDIA
    H100). A wrong derivative on a route (ELU' in place of ReLU', say, which differ on every
    negative z) moves whole tensors by tens of percent. As in ``testing.assert_grads_close``, a
    gradient made by cancellation (stage 4's q/k, 1e-12 to 1e-10 of the step's largest) is held to
    a floor, 1e-6 of the largest norm and 1e-8 of the largest magnitude, and one exactly 0 by
    construction (``testing.exact_zero``) to the largest. Returns what was held, for the parity
    line; raises beyond it."""
    from swin_unet_image_fusion_tpu_torch.testing import exact_zero

    call = max(float(ref.abs().max()) for ref in ref_grads.values())
    largest = max(float(ref.norm()) for ref in ref_grads.values())
    worst, far, total = (0.0, ""), 0, 0
    for name, ref in ref_grads.items():
        got = grads[name]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: the gradient of {name} is not finite")
        zero = exact_zero(name)
        rel = float((got - ref).norm()) / (largest if zero else max(float(ref.norm()), 1e-6 * largest))
        worst = max(worst, (rel, name))
        scale = call if zero else max(float(ref.abs().max()), 1e-8 * call)
        far += int(((got - ref).abs() > 1e-3 * scale).sum())
        total += ref.numel()
    print(f"[act] {what}: the farthest gradient {worst[1]} at {worst[0]:.3e} of its norm; {far} of {total} "
          f"elements off by more than 1e-3 of their tensor's largest", flush=True)
    if worst[0] > STEP_NORM[act]:
        raise AssertionError(f"{what}: the gradient of {worst[1]} is {worst[0]:.3e} of its norm away, more than "
                             f"{STEP_NORM[act]}")
    if far > STEP_FAR[act] * total:
        raise AssertionError(f"{what}: {far} of {total} gradient elements are off by more than 1e-3 of their "
                             f"tensor's largest, more than {STEP_FAR[act]} of them")
    return (f"within {worst[0]:.3e} of their norms (held to {STEP_NORM[act]}), {far} of {total} elements off by "
            f"more than 1e-3 of their tensor's largest (held to {STEP_FAR[act]} of them)")


def activation_models(flat, device, card):
    """The main paths of the relu and gelu forms, each run with the counts set to 0 just
    before it and read just after: the full-width model (``ModelConfig(mlp_activation=...)``)
    served by ``Fuser.fuse_y`` at 512² under ``cuda_pack`` and ``cuda_block`` in fp32 and
    bf16, held against the torch composition on the card (fp32 within MODEL_ATOL/RTOL, bf16 by
    the image criteria against the bf16 and fp32 compositions); then one train step each at
    224² batch 20 under ``cuda_pack`` and ``cuda_block`` with exact forward and backward launch
    counts, its loss terms and every parameter gradient held against the same step with the
    fused block's plain version on the card (its backward follows the TPU kernels': the erf
    form under gelu). Returns the launches by kernel-line key."""
    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
    from swin_unet_image_fusion_tpu_torch.models import layers
    from swin_unet_image_fusion_tpu_torch.ops import fused_block as tfb
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    launches = {}
    rng = np.random.default_rng(SEED + 80)
    ir = rng.random((1, *SERVE_HW, 1), dtype=np.float32)
    vis = rng.random((1, *SERVE_HW, 1), dtype=np.float32)
    for act in ACTIVATIONS:
        def fuser(impl, dtype="float32"):
            return Fuser(Config(model=ModelConfig(attention_impl=impl, compute_dtype=dtype, mlp_activation=act)),
                         flat, device=device)

        plain32, plain16 = fuser("torch"), fuser("torch", "bfloat16")
        ref32 = plain32.fuse_y(ir, vis)
        ref16 = plain16.fuse_y(ir, vis)
        for impl in ("cuda_pack", "cuda_block"):
            name = FUSED_NAME[impl]
            for dtype in ("float32", "bfloat16"):
                served = fuser(impl, dtype)
                torch.cuda.synchronize()
                _reset_act_counts()
                out = served.fuse_y(ir, vis)
                torch.cuda.synchronize()
                got, (fwd, bwd) = read_counts(impl), _act_counts()
                suffix = " bf16" if dtype == "bfloat16" else ""
                expected = {n: 0 for n in got}
                expected.update({f"{n}{suffix}": v for n, v in CONFIGS[impl][SERVE_HW].items()})
                print(f"[act] {act} fuse_y {impl}{suffix} {SERVE_HW}: launches {got}, {act} forms {fwd[act]}",
                      flush=True)
                if got != expected or fwd != {a: expected[f"{name}{suffix}"] if a == act else 0 for a in fwd}:
                    raise AssertionError(f"{act} {impl}{suffix}: launches {got} and {fwd}, expected {expected}")
                check_fused(out, (1, *SERVE_HW, 1))
                if dtype == "float32":
                    err = float(np.abs(out - ref32).max())
                    print(f"[parity] {act} {impl} {SERVE_HW}: kernels vs torch composition on the card, fuse_y "
                          f"max_abs_err {err:.3e}", flush=True)
                    np.testing.assert_allclose(out, ref32, atol=MODEL_ATOL, rtol=MODEL_RTOL)
                else:
                    check_bf16_fidelity(f"{act} {impl}", SERVE_HW, out, ref16, ref32)
                launches[f"{name} {act}{suffix}"] = fwd[act]
                del served
        del plain32, plain16
        torch.cuda.empty_cache()

    # the steps at the default batch, as train_configs' (at batch 2 two elements of a q gradient
    # made by cancellation, 1e-6 of the step's largest, missed the elementwise tolerance)
    trng = np.random.default_rng(SEED + 81)
    tir, tvis = (torch.from_numpy(trng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
                 for _ in range(2))

    def plain_block(x, *weights, **kw):
        return tfb.fused_block_plain(x, *weights, **kw)

    for act in ACTIVATIONS:
        for impl in ("cuda_pack", "cuda_block"):
            name = FUSED_NAME[impl]
            cfg = Config(model=ModelConfig(attention_impl=impl, mlp_activation=act))
            first = {}
            for form in ("kernels", "plain"):
                state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
                step = make_train_step(cfg)
                torch.cuda.synchronize()
                kernel_block = layers.fused_block
                if form == "plain":
                    layers.fused_block = plain_block
                try:
                    _reset_act_counts()
                    terms = step(state, tir, tvis)
                    torch.cuda.synchronize()
                    got, (fwd, bwd) = read_counts(impl), _act_counts()
                finally:
                    layers.fused_block = kernel_block
                grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
                first[form] = ({k: float(v) for k, v in terms.items()}, grads)
                if form == "kernels":
                    expected = {n: 0 for n in got}
                    expected.update(TRAIN_CONFIGS[impl])
                    want = {a: expected[name] if a == act else 0 for a in fwd}
                    want_bwd = {a: expected[f"{name} bwd"] if a == act else 0 for a in bwd}
                    print(f"[act] {act} train step {impl} {TRAIN_HW} bs={TRAIN_BATCH}: launches {got}, {act} "
                          f"forms {fwd[act]} forward and {bwd[act]} backward", flush=True)
                    if got != expected or fwd != want or bwd != want_bwd:
                        raise AssertionError(f"{act} {impl} train step: launches {got}, {fwd}, {bwd}; expected "
                                             f"{expected}, {want}, {want_bwd}")
                    launches[f"{name} {act} bwd"] = bwd[act]
                del state, step
            (terms, grads), (ref_terms, ref_grads) = first["kernels"], first["plain"]
            for k, v in terms.items():
                if abs(v - ref_terms[k]) > 1e-5 * abs(ref_terms[k]):
                    raise AssertionError(f"{act} {impl} step: {k} {v} vs the plain block's {ref_terms[k]}")
            rel = max(abs(terms[k] - ref_terms[k]) / max(abs(ref_terms[k]), 1e-30) for k in terms)
            held = step_grads(grads, ref_grads, act, f"{act} {impl} step")
            print(f"[parity] {act} {impl} train step vs the fused block's plain version on the card: loss terms "
                  f"max relative difference {rel:.3e}, {len(ref_grads)} gradients {held} | {card}", flush=True)
            del first
            torch.cuda.empty_cache()
    return launches


def activation_phase(flat, device, card):
    """``[act]``: :func:`check_activation_kernels` and :func:`activation_models`. Returns the
    worst errors, times and main-path launches of the relu and gelu forms."""
    worst, times = check_activation_kernels(device, card)
    launches = activation_models(flat, device, card)
    return worst, times, launches


# ---- [window]: K3 at windows other than 7x7 (csrc/window_attention_fwd_any.cu, _bwd_any.cu) ----
WINDOWS = ((8, 8), (4, 4), (7, 8))  # windows of the any-window build held against the plain K3
WIN_MODEL = (8, 8)  # the window of the model that the phase serves and steps
WIN_CHECK_BATCH = 2  # images a stream in the kernel checks, at each window's 224² stage maps
WIN_ITERS = 5  # timed calls of each form, in turns with the 7x7 form at the same C
WIN_DROP_RATE = 0.1  # the attention dropout of the 8x8 model's dropout step
# launches of the 8x8 model: every block's K3 at 512² (no stage map within the 49-token gate) and
# at 224² (stage 4's 8x8 map is one window of 64 tokens, above the gate)
WIN_SERVE = {"K3": 40}
WIN_TRAIN = {"K3": 40, "K3 bwd": 40}
WIN_TRAIN_DROP = {"K3 drop": 40, "K3 drop bwd": 40}


def window_key(suffix):
    """The kernels-line key of the 8x8 form whose counter has ``suffix`` (FORM_COUNTERS)."""
    return f"K3 8x8{suffix}"


def window_stages(window, hw, batch, device, seed=SEED + 90):
    """(stage, h, w, c, heads, d, x, weights) of the default model's five stages at ``window`` for
    an ``hw`` input, ``batch`` images a stream."""
    from swin_unet_image_fusion_tpu_torch import ModelConfig

    for k, h, w, c, heads, d in stage_geometries(ModelConfig(window_size=window), hw):
        x, *weights = attention_inputs(h, w, c, heads, d, seed + k, device, batch, window)
        yield k, h, w, c, heads, d, x, weights


def check_window_kernels(device, card):
    """``[window]``: every form of K3's any-window build against its plain version on the same
    inputs, each repeated bit for bit: the forward and the backward in fp32 and bf16 at 8x8, 4x4
    and 7x8 windows at every stage of the default model (C = 24-384, d = C/8; each window's 224²
    stage maps, batch 2), each without shift or cross and with both; at 8x8 also the dropout
    forward and backward at the rates of DROP_CHECK_RATES, fp32 and bf16. Returns the worst
    errors by kernels-line key (and by window)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.testing import assert_grads_close

    names = ("x", "wq", "bq", "wk", "bk", "wv", "bv", "wp", "bp", "bias")
    worst, cases = {}, 0

    def note(key, err):
        worst[key] = max(worst.get(key, 0.0), err)

    for window in WINDOWS:
        for k, h, w, c, heads, d, x32, weights in window_stages(window, TRAIN_HW, WIN_CHECK_BATCH, device):
            g32 = torch.randn(x32.shape, generator=torch.Generator().manual_seed(SEED + 95 + k)).to(device)
            rates = (0.0, *DROP_CHECK_RATES) if window == WIN_MODEL else (0.0,)
            for (shift, cross), dtype, rate in itertools.product(((False, False), (True, True)), (torch.float32, BF16),
                                                                 rates):
                x, g = x32.to(dtype), g32.to(dtype)
                bf16 = dtype == BF16
                kw = dict(window=window, num_heads=heads, dims_per_head=d, shift=shift, cross=cross)
                if rate:
                    kw.update(attn_drop_rate=rate, drop_seed=DROP_SEED + 10 * k + 2 * shift + bf16)
                fwd = twa.fwd_plan(c, heads, d, window, cross, bf16, bool(rate))
                bwd = twa.bwd_plan(c, heads, d, window, cross, bf16, bool(rate))
                what = (f"[window] K3 {window[0]}x{window[1]}{tag(dtype)}{f' drop {rate}' if rate else ''} stage {k} "
                        f"{h}x{w}x{WIN_CHECK_BATCH} C={c} d={d} shift={shift} cross={cross} (forward {fwd.route}, "
                        f"backward {bwd.route})")
                out, again = twa.window_attention(x, *weights, **kw), twa.window_attention(x, *weights, **kw)
                torch.cuda.synchronize()
                err, _ = compare_kernel(out, twa.window_attention_plain(x, *weights, **kw), what)
                if not torch.equal(out, again):
                    raise AssertionError(f"{what}: a repeat gave other bits")
                del out, again
                got, again = twa._launch_bwd(g, x, weights, kw), twa._launch_bwd(g, x, weights, kw)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what} bwd: a repeat gave other bits")
                del again
                ref = twa.window_attention_bwd_plain(g, x, *weights, **kw)
                if bf16:
                    bwd_err = _check_bf16_grads(got, ref, names, what + " bwd")
                else:
                    check = assert_grads_close(got, ref, names, what + " bwd")
                    bwd_err = check.worst
                    print(f"{what} bwd: max_abs_err {bwd_err:.3e}, {check.worst_own:.3e} of a gradient's own "
                          f"largest", flush=True)
                del got, ref
                cases += 1
                drop, b16 = " drop" if rate else "", " bf16" if bf16 else ""
                if window == WIN_MODEL:
                    note(window_key(f"{drop}{b16}"), err)
                    note(window_key(f"{drop} bwd{b16}"), bwd_err)
                note(f"K3 {window[0]}x{window[1]} (every form)", max(err, bwd_err))
            del x32, g32, weights
        torch.cuda.empty_cache()
    for key in sorted(worst):
        print(f"[check] {key}: worst max_abs_err {worst[key]:.3e}; every case repeated bit for bit", flush=True)
    print(f"[check] K3's any-window build: {cases} cases (each a forward and a backward) at windows {WINDOWS} "
          f"against the plain K3 on the card", flush=True)
    return worst


def time_window_kernels(device, card):
    """``[window]``: the 8x8 forms of K3 timed per call in turns with the 7x7 form at the same C
    (8x8, 7x7, 7x7, 8x8), at every stage, shifted and under cross: the forward (fp32, bf16) at the
    stage maps of a 512² request (batch 1), the backward and the dropout forms (rate 0.1) at those
    of a 224² batch-20 step; each beside its bound, its plain version's time, and per token of the
    call (both streams). Returns the times by kernels-line key, summed over a request's or a step's
    40 calls (each stage's 8 calls at this variant's time)."""
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa

    times = {}
    forms = (("", torch.float32, False, False, SERVE_HW, 1), (" bf16", BF16, False, False, SERVE_HW, 1),
             (" bwd", torch.float32, True, False, TRAIN_HW, TRAIN_BATCH),
             (" drop", torch.float32, False, True, TRAIN_HW, TRAIN_BATCH),
             (" drop bwd", torch.float32, True, True, TRAIN_HW, TRAIN_BATCH))
    for suffix, dtype, backward, dropping, hw, batch in forms:
        key = window_key(suffix)
        t = times.setdefault(key, dict(ms=0.0, seven_ms=0.0, plain_ms=0.0, bound_ms=0.0, by={}, library_ms=None))
        pairs = zip(window_stages(WIN_MODEL, hw, batch, device), window_stages(WINDOW, hw, batch, device))
        for (k, h, w, c, heads, d, x, weights), (_, h7, w7, _, _, _, x7, weights7) in pairs:
            x, x7 = x.to(dtype), x7.to(dtype)
            g, g7 = torch.randn_like(x), torch.randn_like(x7)
            extra = dict(attn_drop_rate=WIN_DROP_RATE, drop_seed=DROP_SEED + k) if dropping else {}
            kw = dict(window=WIN_MODEL, num_heads=heads, dims_per_head=d, shift=True, cross=True, **extra)
            kw7 = dict(kw, window=WINDOW)
            if backward:
                calls = (lambda: twa._launch_bwd(g, x, weights, kw), lambda: twa._launch_bwd(g7, x7, weights7, kw7))
                plain = lambda: twa.window_attention_bwd_plain(g, x, *weights, **kw)  # noqa: E731
            else:
                calls = (lambda: twa.window_attention(x, *weights, **kw),
                         lambda: twa.window_attention(x7, *weights7, **kw7))
                plain = lambda: twa.window_attention_plain(x, *weights, **kw)  # noqa: E731
            ms, seven = _in_turns(*calls, WIN_ITERS, 2)
            plain_ms = time_ms(plain, iters=1, warmup=1)
            ops = hash_ops(h, w, c, heads, 0, batch, True, WIN_MODEL) if dropping else 0
            bound, bound_by = attention_bound_ms(h, w, c, heads, d, batch, backward=backward, dtype=dtype,
                                                 int_ops=ops, window=WIN_MODEL)
            tokens, tokens7 = 2 * batch * h * w, 2 * batch * h7 * w7
            print(f"[time] {key} stage {k} {h}x{w}x{batch} C={c} d={d} shifted cross: {ms:.4f} ms "
                  f"({1e6 * ms / tokens:.3f} ns a token), 7x7 form at {h7}x{w7} {seven:.4f} ms "
                  f"({1e6 * seven / tokens7:.3f} ns a token, in turns), plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({bound_by}) | {card}", flush=True)
            for name, v in (("ms", ms), ("seven_ms", seven), ("plain_ms", plain_ms), ("bound_ms", bound)):
                t[name] += 8 * v
            t["by"][bound_by] = t["by"].get(bound_by, 0.0) + 8 * bound
            del x, x7, g, g7, weights, weights7
        torch.cuda.empty_cache()
        t["bound_by"] = max(t.pop("by").items(), key=lambda kv: kv[1])[0]
        per = "512x512 request" if hw == SERVE_HW else f"{hw[0]}x{hw[1]} batch-{batch} step"
        print(f"[time] {key} per {per} (40 calls): {t['ms']:.3f} ms, the 7x7 form {t['seven_ms']:.3f} ms "
              f"({t['ms'] / t['seven_ms'] - 1:+.1%}, in turns), plain {t['plain_ms']:.3f} ms, bound "
              f"{t['bound_ms']:.4f} ms | {card}", flush=True)
    return times


def window_models(device, card):
    """``[window]``: the main paths of a model with 8x8 windows, each run with the counts set to 0
    just before it and read just after. ``Fuser.fuse_y`` of the full-width 33M model
    (``ModelConfig(window_size=(8, 8))``, its own random weights: the relative-position tables
    are 15 x 15) at 512² under ``"auto"`` in fp32, against the torch composition on the card
    (MODEL_ATOL / MODEL_RTOL), and in bf16 by the image criteria; its fp32 request timed in
    turns with the 7x7 model's. Then one fp32 train step at 224² batch TRAIN_BATCH under
    ``"auto"`` against the composition's first step: loss terms to 1e-5 relative, every gradient
    by ``testing.assert_grads_close`` with ``rounding``, each atol at least ROUNDING_NOISE times
    the fp32 composition's own distance from its float64 evaluation (the stage-0
    relative-position table gradient, summed over 3,920 windows with cancellation, moves in fp32
    by more than the 1e-4 of its largest that assert_grads_close allows alone; the line prints
    the largest such distance); and one with attention dropout (rate WIN_DROP_RATE) against the
    same step with K3's plain version on the card. Returns the launches by kernels-line key."""
    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig, SwinFusionUNet, losses
    from swin_unet_image_fusion_tpu_torch.models import layers
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables, variables_from_jax
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    from swin_unet_image_fusion_tpu_torch.testing import ROUNDING_NOISE, assert_grads_close, exact_zero, rounding_of
    from swin_unet_image_fusion_tpu_torch.train import create_train_state, make_train_step

    flat = random_variables(ModelConfig(window_size=WIN_MODEL), seed=SEED)
    launches = {}

    def fuser(impl, dtype="float32", window=WIN_MODEL, weights=flat):
        model = ModelConfig(window_size=window, attention_impl=impl, compute_dtype=dtype)
        return Fuser(Config(model=model), weights, device=device)

    rng = np.random.default_rng(SEED + 91)
    ir, vis = (rng.random((1, *SERVE_HW, 1), dtype=np.float32) for _ in range(2))
    plain32, plain16 = fuser("torch"), fuser("torch", "bfloat16")
    ref32, ref16 = plain32.fuse_y(ir, vis), plain16.fuse_y(ir, vis)
    del plain32, plain16
    for dtype in ("float32", "bfloat16"):
        served = fuser("auto", dtype)
        routes = served.model.stage_impls(*SERVE_HW, device)
        if routes != ("cuda",) * 5:
            raise AssertionError(f"the 8x8 model routes {routes} at {SERVE_HW}")
        suffix = " bf16" if dtype == "bfloat16" else ""
        torch.cuda.synchronize()
        reset_counts()
        out = served.fuse_y(ir, vis)
        torch.cuda.synchronize()
        got = read_counts("cuda")
        expected = {n: 0 for n in got}
        expected.update({f"{n}{suffix}": v for n, v in WIN_SERVE.items()})
        print(f"[window] fuse_y with 8x8 windows{suffix} {SERVE_HW} under auto: launches {got}", flush=True)
        if got != expected:
            raise AssertionError(f"8x8 fuse_y{suffix}: launches {got}, expected {expected}")
        launches[window_key(suffix)] = got[f"K3{suffix}"]
        check_fused(out, (1, *SERVE_HW, 1))
        if suffix:
            check_bf16_fidelity("auto 8x8", SERVE_HW, out, ref16, ref32)
        else:
            print(f"[parity] 8x8 auto {SERVE_HW}: kernels vs torch composition on the card, fuse_y max_abs_err "
                  f"{float(np.abs(out - ref32).max()):.3e}", flush=True)
            np.testing.assert_allclose(out, ref32, atol=MODEL_ATOL, rtol=MODEL_RTOL)
            seven = fuser("auto", window=WINDOW, weights=random_variables(ModelConfig(), seed=SEED))
            walls = {"8x8": [], "7x7": []}
            for _ in range(LATENCY_SAMPLES // 4):
                for name, f in (("8x8", served), ("7x7", seven), ("7x7", seven), ("8x8", served)):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    f.fuse_y(ir, vis)
                    torch.cuda.synchronize()
                    walls[name].append(1e3 * (time.perf_counter() - start))
            print(f"[window] fuse_y {SERVE_HW} bs=1 under auto, {len(walls['8x8'])} requests each in turns: 8x8 "
                  f"windows median {np.median(walls['8x8']):.3f} ms, 7x7 windows {np.median(walls['7x7']):.3f} ms "
                  f"| {card}", flush=True)
            del seven
        del served
    torch.cuda.empty_cache()

    trng = np.random.default_rng(SEED + 92)
    tir, tvis = (torch.from_numpy(trng.random((TRAIN_BATCH, *TRAIN_HW, 1), dtype=np.float32)).to(device)
                 for _ in range(2))

    def first_step(impl, drop=0.0, plain_k3=False):
        cfg = Config(model=ModelConfig(window_size=WIN_MODEL, attention_impl=impl, attention_drop_ratio=drop))
        state = create_train_state(cfg, flat, iters_per_epoch=100, device=device)
        step = make_train_step(cfg)
        kernel_k3 = layers.window_attention
        if plain_k3:
            layers.window_attention = twa.window_attention_plain
        try:
            torch.cuda.synchronize()
            reset_counts()
            terms = step(state, tir, tvis)
            torch.cuda.synchronize()
            got = read_counts("cuda")
        finally:
            layers.window_attention = kernel_k3
        grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
        del state, step
        return {k: float(v) for k, v in terms.items()}, grads, got

    def grads64():  # the step's gradients from the composition in float64
        cfg = Config(model=ModelConfig(window_size=WIN_MODEL, attention_impl="torch"))
        model = SwinFusionUNet(cfg.model)
        model.load_state_dict(variables_from_jax(flat))
        model = model.to(device, torch.float64)
        a, b = tir.double(), tvis.double()
        losses.total_fusion_loss(cfg.loss, model(a, b, train=True).clamp(0.0, 1.0), a, b)[0].backward()
        grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        del model
        return grads

    for drop, counts, what in ((0.0, WIN_TRAIN, "train step"),
                               (WIN_DROP_RATE, WIN_TRAIN_DROP, f"dropout train step (attention {WIN_DROP_RATE})")):
        terms, grads, got = first_step("auto", drop)
        expected = {n: 0 for n in got}
        expected.update(counts)
        print(f"[window] 8x8 {what} {TRAIN_HW} bs={TRAIN_BATCH} under auto: launches {got}", flush=True)
        if got != expected:
            raise AssertionError(f"8x8 {what}: launches {got}, expected {expected}")
        for name in counts:
            if "bwd" in name or "drop" in name:  # the forward's launches are the served request's
                launches[window_key(name[2:])] = got[name]
        ref_terms, ref_grads, _ = first_step("auto", drop, plain_k3=True) if drop else first_step("torch")
        reference = "the same step with K3's plain version" if drop else "the torch composition"
        for key, v in terms.items():
            if abs(v - ref_terms[key]) > 1e-5 * abs(ref_terms[key]):
                raise AssertionError(f"8x8 {what}: {key} {v} vs {reference}'s {ref_terms[key]}")
        # without dropout the reference is the composition, another implementation: each atol at
        # least ROUNDING_NOISE times the composition's own fp32 rounding
        if drop:
            rounding = None
        else:
            fp64 = grads64()
            rounding = rounding_of(list(ref_grads.values()), [fp64[n] for n in ref_grads])
            del fp64
        check = assert_grads_close([grads[n] for n in ref_grads], list(ref_grads.values()), list(ref_grads),
                                   f"8x8 {what}", rounding)
        rel = max(abs(terms[key] - ref_terms[key]) / max(abs(ref_terms[key]), 1e-30) for key in terms)
        held = f"gradients max_abs_err {check.worst:.3e} ({check.worst_own:.3e} of a gradient's own largest)"
        if rounding:
            own = max(r / max(float(g.abs().max()), 1e-30) for r, g, n in zip(rounding, ref_grads.values(), ref_grads)
                      if not exact_zero(n))
            held += (f", atol {ROUNDING_NOISE:g}x the fp32 composition's own distance from its float64 evaluation "
                     f"(at most {own:.3e} of a gradient's own largest) on {len(check.widened)} of them")
        print(f"[parity] 8x8 {what} vs {reference} on the card: loss terms max relative difference {rel:.3e}, "
              f"{held}, {len(ref_grads)} gradients | {card}", flush=True)
        del grads, ref_grads, rounding
        torch.cuda.empty_cache()
    return launches


def window_phase(device, card):
    """``[window]``: :func:`check_window_kernels`, :func:`time_window_kernels` and
    :func:`window_models`. Returns the worst errors, the times and the main-path launches of the
    8x8 forms by kernels-line key."""
    worst = check_window_kernels(device, card)
    times = time_window_kernels(device, card)
    launches = window_models(device, card)
    return worst, times, launches


class Phases:
    """Prints each phase's wall seconds on its own line, and the run's so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, name):
        now = time.perf_counter()
        print(f"[phase] {name}: {now - self.last:.1f} s (run {now - self.start:.1f} s)", flush=True)
        self.last = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from swin_unet_image_fusion_tpu_torch import Config, Fuser, ModelConfig
    from swin_unet_image_fusion_tpu_torch.models.from_jax import random_variables
    from swin_unet_image_fusion_tpu_torch.ops import _build

    # fp32 parity mode: no TF32 in matmuls or convolutions. cuBLAS's reduced-precision
    # reduction of bf16 GEMMs stays at PyTorch's default: the model's forward turns it off
    # while it runs, so what is served here is what a caller gets.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    card = card_line()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{kind} x{count} | allow_bf16_reduced_precision_reduction "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}", flush=True)

    phase = Phases()
    if sys.argv[1:2] == ["--dist-worker"]:
        return dist_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if sys.argv[1:] == ["--multi-device"]:
        # the multi-device phases alone; no kernels line and no last line
        _build.build_all()
        phase("build")
        multi_device_phases(random_variables(ModelConfig(), seed=SEED), device, card)
        phase("[dist], [spatial] and [tiled] world 1")
        return 0
    if sys.argv[1:] == ["--serving-eval"]:
        # the serving and evaluation phases alone, on the two sources they run (K3's fp32
        # forward and backward); no kernels line and no last line
        _build.build_all(("window_attention_fwd", "window_attention_bwd"))
        phase("build of window_attention_fwd.cu and window_attention_bwd.cu")
        serving_eval_phases(random_variables(ModelConfig(), seed=SEED), device, card)
        phase("[colour], [test], [tiled], [canny], [metrics] and [flops]")
        return 0
    if sys.argv[1:] == ["--activation"]:
        # the relu and gelu forms alone; no kernels line and no last line
        _build.build_all()
        phase("build")
        activation_phase(random_variables(ModelConfig(), seed=SEED), device, card)
        phase("[act]")
        return 0
    if sys.argv[1:] == ["--window"]:
        # K3 at windows other than 7x7 alone, on K3's sources; no kernels line and no last line
        _build.build_all(("window_attention_fwd", "window_attention_bwd", "window_attention_fwd_any",
                          "window_attention_bwd_any", "window_attention_bwd_any_drop"))
        phase("build of K3's sources")
        window_phase(device, card)
        phase("[window]")
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; the options are --serving-eval, "
              "--multi-device, --activation and --window", file=sys.stderr)
        return 2
    _build.build_all()
    phase("build")

    cfg = ModelConfig()
    worst = {}
    for dtype in (torch.float32, BF16):
        worst.update({f"K3{tag(dtype)}": check_attention_kernel(cfg, device, dtype),
                      **check_fused_block(cfg, device, dtype),
                      f"K2{tag(dtype)}": check_repartition(cfg, device, dtype)})
    phase("[check] forward kernels, fp32 and bf16")

    flat = random_variables(cfg, seed=SEED)

    def fuser(impl, dtype="float32", on=DEVICE):
        model = ModelConfig(attention_impl=impl, compute_dtype=dtype)
        return Fuser(Config(model=model), flat, device=on)

    fusers = {impl: fuser(impl) for impl in CONFIGS}
    fusers16 = {impl: fuser(impl, "bfloat16") for impl in CONFIGS}
    plain_fuser, plain16 = fuser("torch"), fuser("torch", "bfloat16")
    cpu_fuser = fuser("auto", on="cpu")
    launches = serve_configs(fusers, plain_fuser, cpu_fuser)
    launches.update(serve_configs(fusers16, plain16, None, BF16, plain_fuser))
    phase("[serve] fp32 and bf16")

    times = {**time_kernels(cfg, device, card), **time_kernels(cfg, device, card, BF16),
             **time_repartition(cfg, device, card)}
    from swin_unet_image_fusion_tpu_torch.ops import window_attention as twa
    for dtype in (torch.float32, BF16):
        for launch, label in ((twa._launch_fwd, "redesigned"), (twa._launch_three, "three launches")):
            k3_split(cfg, device, card, launch, f"K3{tag(dtype)} {label}", dtype)
        block_split(cfg, device, card, dtype)
    phase("[time] forward kernels, [split] K3, K1 and K4 by stage and kernel")

    # the configurations take turns, fp32 and bf16 alike
    served = {**fusers, **{f"{impl} bf16": f for impl, f in fusers16.items()},
              "torch composition": plain_fuser, "torch composition bf16": plain16}
    median_ms, ir, vis = latency(served, card)
    for name, f in served.items():
        if not name.startswith("torch"):
            trace_request(name, f, ir, vis, median_ms[name], card)
    throughput({name: f for name, f in served.items() if not name.startswith("torch")}, card)
    del fusers, fusers16, plain_fuser, plain16, cpu_fuser, served
    torch.cuda.empty_cache()
    phase("[latency], [trace] and [throughput] of serving")

    bwd = {**train_block_backward(cfg, device, card), "K3 bwd": train_attention_backward(cfg, device, card),
           "K2 bwd": train_repartition_backward(cfg, device, card)}
    torch.cuda.empty_cache()
    block_bwd_split(cfg, device, card)
    k3_bwd_split(cfg, device, card)
    phase("[check] and [time] of the backward kernels, [split] K1 bwd, K4 bwd and K3 bwd")
    drop_worst, drop_times = check_dropout_kernels(cfg, device, card)
    torch.cuda.empty_cache()
    c384_worst = check_drop_c384(cfg, device, card)
    c384_worst.update(check_k3_drop_forward(cfg, device, card))
    mask_worst, mask_times = check_mask_kernels(cfg, device, card)
    drop_worst.update(mask_worst)
    drop_times.update(mask_times)
    phase("[check] and [time] of the dropout forms and the mask kernels")
    for check in (check_bf16_blocks, check_bf16_attention, check_bf16_repartition, check_bf16_masks):
        bf16_worst, bf16_times = check(cfg, device, card)
        drop_worst.update(bf16_worst)
        drop_times.update(bf16_times)
        torch.cuda.empty_cache()
    for key, err in c384_worst.items():
        if key in bwd:  # K1 and K4 bwd in fp32 at check_stage4_backward's batch 20
            bwd[key]["worst"] = max(bwd[key]["worst"], err)
        else:
            drop_worst[key] = max(drop_worst[key], err)
    phase("[check] and [time] of the bf16 backward and dropout forms and the bf16 mask kernels")
    train_launches, states, steps, inputs, fp32_first, train_ms = train_configs(flat, device, card)
    launches.update(train_launches)
    phase("[train] fp32")
    train_448(flat, device, card)
    phase("[train] 448")
    launches.update(dropout_train(flat, device, card, states, steps, inputs))
    phase("[train] dropout")
    launches.update(bf16_train(flat, device, card, states, steps, inputs, fp32_first))
    del states, steps, inputs, fp32_first
    torch.cuda.empty_cache()
    phase("[train] bf16 and bf16 dropout")
    dropout_parity(flat, card)
    phase("[parity] dropout, card vs CPU")
    trainer_phases(device, card, train_ms["cuda"])
    cli_phase(card)
    phase("[trainer], [resume], [pth], [nonfinite] and [cli]")
    remat_phase(device, card)
    phase("[remat]")
    serving_eval_phases(flat, device, card)
    phase("[colour], [test], [tiled], [canny], [metrics] and [flops]")
    band_worst, band_times, band_launches = multi_device_phases(flat, device, card)
    worst.update(band_worst)
    times.update(band_times)
    launches.update(band_launches)
    phase("[dist], [spatial] and [tiled] world 1")
    act_worst, act_times, act_launches = activation_phase(flat, device, card)
    worst.update(act_worst)
    times.update(act_times)
    launches.update(act_launches)
    phase("[act] relu and gelu forms of K1 and K4")
    win_worst, win_times, win_launches = window_phase(device, card)
    worst.update(win_worst)
    times.update(win_times)
    launches.update(win_launches)
    phase("[window] K3 at 8x8, 4x4 and 7x8 windows")

    csrc = "swin_unet_image_fusion_tpu_torch/csrc"
    described = (
        ("K3", "window_attention_fwd (K3)", f"{csrc}/window_attention_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_attention.py:249"),
        ("K1", "fused_block_fwd, windows layout (K1)", f"{csrc}/fused_block_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:525"),
        ("K2", "repartition_fwd (K2)", f"{csrc}/repartition.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:2210"),
        ("K4", "fused_block_fwd, image layout (K4)", f"{csrc}/fused_block_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_block.py:52"),
        ("K3 bf16", "window_attention_fwd bf16 (K3 bf16)", f"{csrc}/window_attention_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_attention.py:249"),
        ("K1 bf16", "fused_block_fwd bf16, windows layout (K1 bf16)", f"{csrc}/fused_block_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:525"),
        ("K2 bf16", "repartition_fwd bf16 (K2 bf16)", f"{csrc}/repartition.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:2210"),
        ("K4 bf16", "fused_block_fwd bf16, image layout (K4 bf16)", f"{csrc}/fused_block_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_block.py:52"),
        ("K3 bwd", "k3_bwd (K3 bwd; the fused route at stages 0-1, the split route at stages 2-4, at d = 48 "
         "the tiled core)",
         f"{csrc}/window_attention_bwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_attention.py:335"),
        ("K1 bwd", "block_bwd, windows layout (K1 bwd; the fused route at stages 0-1, the split route of "
         "fused_block_bwd_split.cu at stages 2-4)", f"{csrc}/fused_block_bwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:760"),
        ("K2 bwd", "repartition_bwd (K2 bwd, the inverse permutation)", f"{csrc}/repartition.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:2311"),
        ("K4 bwd", "block_bwd, image layout (K4 bwd; the fused route at stages 0-1, the split route of "
         "fused_block_bwd_split.cu at stages 2-4)",
         f"{csrc}/fused_block_bwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_block.py:230"),
        ("K3 drop", "k3_fwd with hash dropout (K3 drop; the dropout form of the one-launch block at stages 0-1 "
         "and of the split route at stages 2-3)", f"{csrc}/window_attention_fwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_attention.py:278"),
        ("K3 drop bwd", "k3_bwd with hash dropout (K3 drop bwd; the dropout form of the fused route at stages "
         "0-1 and of the split route at stages 2-4)",
         f"{csrc}/window_attention_bwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_attention.py:372"),
        ("K1 drop", "fused_block_fwd with hash dropout, windows layout (K1 drop; one launch at stages 0-1, six "
         "at 2-4)", f"{csrc}/fused_block_fwd_drop.cu", "swin_unet_image_fusion_tpu/ops/pallas_pack.py:581"),
        ("K1 drop bwd", "block_bwd with hash dropout, windows layout (K1 drop bwd; the dropout form of the "
         "fused route at stages 0-1 and of the split route of fused_block_bwd_split.cu at stages 2-4)",
         f"{csrc}/fused_block_bwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_pack.py:808"),
        ("K4 drop", "fused_block_fwd with hash dropout, image layout (K4 drop; one launch at stages 0-1, six "
         "at 2-4)", f"{csrc}/fused_block_fwd_drop.cu", "swin_unet_image_fusion_tpu/ops/pallas_block.py:87"),
        ("K4 drop bwd", "block_bwd with hash dropout, image layout (K4 drop bwd; the dropout form of the "
         "fused route at stages 0-1 and of the split route of fused_block_bwd_split.cu at stages 2-4)",
         f"{csrc}/fused_block_bwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_block.py:257"),
        # the composition's masks, where the JAX package applies flax's nn.Dropout outside
        # Pallas; launches forward and on the gradient
        ("mask tokens", "dropout_tokens, the composition's proj/MLP masks (a group of threads a token row, "
         "16-byte vectors)", f"{csrc}/dropout_mask.cu", "swin_unet_image_fusion_tpu/models/layers.py:365"),
        ("mask attention", "dropout_attention, the composition's attention-weight masks",
         f"{csrc}/dropout_mask.cu", "swin_unet_image_fusion_tpu/models/layers.py:248"),
        # bf16 training: the bf16 backward forms (fp32 inside, as the JAX bodies upcast) and
        # the bf16 dropout forms, forward and backward
        ("K3 bwd bf16", "k3_bwd bf16 (K3 bwd bf16)", f"{csrc}/window_attention_bwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_attention.py:335"),
        ("K1 bwd bf16", "block_bwd bf16, windows layout (K1 bwd bf16; the fused route at stages 0-1, "
         "the split route of fused_block_bwd_split.cu at stages 2-4)", f"{csrc}/fused_block_bwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:760"),
        ("K2 bwd bf16", "repartition_bwd bf16 (K2 bwd bf16)", f"{csrc}/repartition.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack.py:2311"),
        ("K4 bwd bf16", "block_bwd bf16, image layout (K4 bwd bf16; the fused route at stages 0-1, "
         "the split route of fused_block_bwd_split.cu at stages 2-4)",
         f"{csrc}/fused_block_bwd.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_block.py:230"),
        ("K3 drop bf16", "k3_fwd bf16 with hash dropout (K3 drop bf16, mma.sync, p masked before its rounding)",
         f"{csrc}/window_attention_fwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_attention.py:278"),
        ("K3 drop bwd bf16", "k3_bwd bf16 with hash dropout (K3 drop bwd bf16, fp32 inside)",
         f"{csrc}/window_attention_bwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_attention.py:372"),
        ("K1 drop bf16", "fused_block_fwd bf16 with hash dropout, windows layout (K1 drop bf16, fp32 inside)",
         f"{csrc}/fused_block_fwd_drop.cu", "swin_unet_image_fusion_tpu/ops/pallas_pack.py:581"),
        ("K1 drop bwd bf16", "block_bwd bf16 with hash dropout, windows layout (K1 drop bwd bf16; the "
         "dropout form of the fused route at stages 0-1 and of the split route at stages 2-4)",
         f"{csrc}/fused_block_bwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_pack.py:808"),
        ("K4 drop bf16", "fused_block_fwd bf16 with hash dropout, image layout (K4 drop bf16, mma.sync)",
         f"{csrc}/fused_block_fwd_drop.cu", "swin_unet_image_fusion_tpu/ops/pallas_block.py:87"),
        ("K4 drop bwd bf16", "block_bwd bf16 with hash dropout, image layout (K4 drop bwd bf16; the "
         "dropout form of the fused route at stages 0-1 and of the split route at stages 2-4)",
         f"{csrc}/fused_block_bwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_block.py:257"),
        ("mask tokens bf16", "dropout_tokens bf16, the composition's proj/MLP masks in a bf16 step",
         f"{csrc}/dropout_mask.cu", "swin_unet_image_fusion_tpu/models/layers.py:365"),
        # the banded forms of SpatialFuser (ops/window_pack_spmd.py): K1 on a band's windows
        # with the row seam off below window row 0, K2 on [halo; band]
        ("K1 band", "fused_block_fwd on a band of window rows (K1 band, shift code 2 below the map's first "
         "window row)", f"{csrc}/fused_block_fwd.cu", "swin_unet_image_fusion_tpu/ops/pallas_pack_spmd.py:183"),
        ("K2 halo", "repartition_halo_fwd on a band with its neighbour's window row (K2 halo: one launch over "
         "the band's rows, the halo row read in place)", f"{csrc}/repartition.cu",
         "swin_unet_image_fusion_tpu/ops/pallas_pack_spmd.py:329"),
        # the relu and gelu MLP forms (the activation a runtime code of every route, activation.cuh;
        # gelu's forward in the tanh form, its backward in the erf form, as the TPU kernels')
        *((f"{name} {act}{form}", f"{what} {act} MLP{kind}, {layout} layout ({name} {act}{form})",
           f"{csrc}/{source}", replaces)
          for act in ACTIVATIONS
          for name, layout, fwd_line, bwd_line in (
              ("K1", "windows", "pallas_pack.py:668", "pallas_pack.py:911"),
              ("K4", "image", "pallas_block.py:174", "pallas_block.py:364"))
          for form, what, kind, source, replaces in (
              ("", "fused_block_fwd", "", "fused_block_fwd.cu", f"swin_unet_image_fusion_tpu/ops/{fwd_line}"),
              (" bf16", "fused_block_fwd bf16", "", "fused_block_fwd.cu",
               f"swin_unet_image_fusion_tpu/ops/{fwd_line}"),
              (" bwd", "block_bwd", " (the fused route at stages 0-1, the split route at 2-3)", "fused_block_bwd.cu",
               f"swin_unet_image_fusion_tpu/ops/{bwd_line}"))),
        # K3 at 8x8 windows: the any-window builds of window_attention_fwd.cu and _bwd.cu (T, wh and
        # ww at run time, 64 rows a block; the backward's dropout form its own library), on the 8x8
        # model's serving and training paths
        *((window_key(suffix), f"{what} at 8x8 windows, T = 64 ({window_key(suffix)})", f"{csrc}/{source}",
           f"swin_unet_image_fusion_tpu/ops/pallas_attention.py:{line}")
          for suffix, what, source, line in (
              ("", "k3_fwd", "window_attention_fwd_any.cu", 756),
              (" bf16", "k3_fwd bf16", "window_attention_fwd_any.cu", 756),
              (" bwd", "k3_bwd", "window_attention_bwd_any.cu", 796),
              (" drop", "k3_fwd with hash dropout", "window_attention_fwd_any.cu", 756),
              (" drop bwd", "k3_bwd with hash dropout", "window_attention_bwd_any_drop.cu", 796))),
    )
    times.update(bwd)
    times.update(drop_times)
    worst.update({key: bwd[key]["worst"] for key in bwd})
    worst.update(drop_worst)
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[key], "max_abs_err": worst[key],
        **{k: times[key][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for key, name, source, replaces in described]
    if any(k["launches"] <= 0 for k in kernels):
        raise AssertionError(f"a kernel never launched on its main path: {launches}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
