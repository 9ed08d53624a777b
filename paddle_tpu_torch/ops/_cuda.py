"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source ``paddle_tpu_torch/csrc/<name>.cu`` with a plain C
interface. At first use it is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library under ``build/paddle_tpu_torch/`` at the root of the
checkout and loaded with ``ctypes``. The library's file name carries a hash
of the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Nothing here runs at import time.

The same content-addressed build and load (:func:`content_path`,
:func:`compile_all`, :func:`load_cached`) serve the port's host library,
which ``framework/native.py`` compiles with ``g++``.
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
from typing import Callable, Dict, Iterable, Optional

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


def content_path(stem: str, flags: Iterable[str], sources: Iterable[Path]) -> Path:
    """``build/paddle_tpu_torch/lib<stem>-<hash>.so``, where the hash covers
    ``flags`` and each source's name and bytes."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built (content-addressed)."""
    return content_path(name, NVCC_FLAGS, sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"])


def compile_all(jobs: Dict[str, tuple]) -> Dict[str, float]:
    """Run ``jobs[label] = (cmd, out)`` for every ``out`` not built yet, all
    started together, each linking ``cmd + ["-o", <temporary>]`` to a file of
    its own process that ``os.replace`` then publishes as ``out``. Returns the
    seconds each took (0.0 for one already built); raises with the
    compiler's output on a failure, which is kept beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for label, (cmd, out) in jobs.items():
        if out.exists():
            seconds[label] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        procs[label] = (subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        out, tmp, time.perf_counter())
    for label, (proc, out, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[label] = time.perf_counter() - t0
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(proc.args[0]).name} failed to build {label} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    return seconds


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    process each, all started together (:func:`compile_all`; the compiler's
    ``-Xptxas -v`` report is the ``<library>.log``)."""
    return compile_all({name: ([nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")],
                               library_path(name)) for name in names})


def load_cached(key: str, build_fn: Callable[[], Path],
                bind: Optional[Callable[[ctypes.CDLL], None]] = None) -> ctypes.CDLL:
    """The library cached under ``key``, else the one at the path that
    ``build_fn`` returns, loaded once per process with ``bind`` setting its
    signatures."""
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_fn()))
            if bind is not None:
                bind(lib)
            _LIBS[key] = lib
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    return load_cached(name, lambda: (build([name]), library_path(name))[1])
