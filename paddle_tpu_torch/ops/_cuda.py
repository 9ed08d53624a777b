"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source ``paddle_tpu_torch/csrc/<name>.cu`` with a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/paddle_tpu_torch/`` at the root of the
checkout and loaded with ``ctypes``. The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: The byte boundary that the kernels' 16-byte loads and stores (TMA,
#: cp.async, bf16 pair stores) need on an operand's base address.
ALIGN = 16

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def aligned(t) -> bool:
    """Whether tensor ``t``'s base address lies on an :data:`ALIGN`-byte
    boundary."""
    return t.data_ptr() % ALIGN == 0


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at first "
        "use; put the CUDA toolkit's nvcc on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built (content-addressed)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    process each, all started together. Returns the seconds each took (0.0
    for one already built); raises with the compiler's output on a failure.
    The compiler's ``-Xptxas -v`` report is kept beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out, tmp, time.perf_counter())
    for name, (proc, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib
