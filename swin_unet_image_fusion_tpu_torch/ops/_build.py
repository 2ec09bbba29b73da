"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into its own shared library under ``build/torch_kernels/`` at the repo root,
then loaded with ``ctypes``. The build runs at first use, never at import, and is
cached by the hash of the source and the flags. ``build_all`` starts one ``nvcc`` per
source, all at once, and prints each source's wall seconds and ptxas's register,
shared-memory and spill lines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
KERNEL_SOURCES = ("window_attention", "window_attention_fwd", "window_attention_bwd", "window_attention_fwd_any",
                  "window_attention_bwd_any", "window_attention_bwd_any_drop", "fused_block", "fused_block_fwd",
                  "fused_block_fwd_drop", "fused_block_bwd", "fused_block_bwd_split", "repartition", "dropout_mask")

_INCLUDED_SOURCE = re.compile(rb'^#include "(\w+\.cu)"', re.M)
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def _target(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source)
    for included in _INCLUDED_SOURCE.findall(source):  # an any-window build includes its 7x7 source
        digest.update((CSRC / included.decode()).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # a source may include any of them
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> str:
    keep = ("Compiling entry", "registers", "spill", "smem")
    return "\n".join(line for line in log.splitlines() if any(k in line for k in keep))


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every source that has no library yet, all ``nvcc`` runs at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    pending, done = {}, {}
    start = time.perf_counter()

    def finish(name, proc):  # read the log as it comes, so that no pipe fills
        log, _ = proc.communicate()
        done[name] = (log, time.perf_counter() - start)

    for name, so in targets.items():
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            waiter = threading.Thread(target=finish, args=(name, proc))
            waiter.start()
            pending[name] = (tmp, proc, waiter)
    failures = []
    for name, (tmp, proc, waiter) in pending.items():
        waiter.join()
        log, seconds = done[name]
        if proc.returncode != 0:
            failures.append(f"nvcc failed on csrc/{name}.cu:\n{log}")
            continue
        print(f"[build] csrc/{name}.cu -> {targets[name].name} ({seconds:.1f} s)\n{_ptxas_lines(log)}", flush=True)
        os.replace(tmp, targets[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Every source
    exports ``swin_cuda_error_string``."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_all((name,))[name]))
            lib.swin_cuda_error_string.argtypes = [ctypes.c_int]
            lib.swin_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def launch_on(device: torch.device, launcher, *args) -> int:
    """``launcher(*args, stream)``, a C launcher called with ``device``'s card current and the
    raw handle of its current stream last. The ``torch.cuda.device`` context is entered only
    when another card is current: entering and leaving it, and the ``torch.cuda.Stream``
    object of the stream, cost microseconds on every call."""
    index = device.index
    if index is not None and index == torch.cuda.current_device():
        return launcher(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(device):
        return launcher(*args, torch.cuda.current_stream().cuda_stream)


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (0 = ok)."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({lib.swin_cuda_error_string(rc).decode()})")
