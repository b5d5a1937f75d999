"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each kernel lives in ``kernels/<name>/csrc/<name>.cu`` and exports plain C
functions that launch on the stream they are given and return the
``cudaGetLastError()`` code of the launch.  A library is compiled for
``sm_90a`` at first use into ``build/repro_torch_kernels/`` at the root of
the checkout, named by a digest of its source and flags, so an edited
source never loads a stale library.  Nothing is compiled when a module is
imported: the CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "repro_torch_kernels"
# --split-compile=0: nvcc optimizes a source's kernels in parallel on
# every core (the paged-attention source's 110 instantiations took ~180 s
# in one thread, the five sources ~60 s together with it)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")
KERNELS = ("utopia_rsw", "paged_attention", "flash_attention",
           "rows_gemm", "rms_norm")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# What the kernels' wrappers would have launched on ``meta`` tensors (the
# dry run, ``launch/dryrun.py``): per kernel, calls, operations (the
# formulas behind PERF.md's bounds) and the bytes each call must move.
META_COSTS: Dict[str, collections.Counter] = collections.defaultdict(
    collections.Counter)


def count_meta(name: str, flops: int, nbytes: int) -> None:
    """Record one shape-only call of kernel ``name`` (``META_COSTS``)."""
    c = META_COSTS[name]
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(nbytes)


def source(name: str) -> Path:
    return _KERNELS_DIR / name / "csrc" / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                           f"({home}): the CUDA kernels cannot be built")
    return str(cand)


def library_path(name: str) -> Path:
    h = hashlib.sha256(source(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Tuple[float, str]]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: (seconds,
    compiler log)}`` for the ones compiled; raises with the compiler's
    output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


def stream_handle(t) -> int:
    """The raw ``cudaStream_t`` of torch's current stream on ``t``'s card
    (torch's raw-stream query: the public ``current_stream`` builds a
    Stream object on every call)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
