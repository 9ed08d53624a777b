"""The port's native host library: the record feed's reader threads
(``paddle_tpu_torch/csrc/host/``: ``data_feed.cc``, ``channel.h``,
``buffer.cc``), copies of the reference's ``csrc/`` sources, bound with
``ctypes`` (``paddle_tpu/framework/native.py`` binds the reference's).

At first use ``g++ -O2 -fPIC -shared -std=c++17 -pthread`` builds them into
``build/paddle_tpu_torch/libpaddle_tpu_torch_host-<hash>.so`` at the root of
the checkout, through the kernels' content-addressed build
(``ops/_cuda.py``): the hash covers the sources and the flags, so an edited
source is rebuilt and a stale library never loaded. There is no Python
fallback: a failed build raises with the compiler's output. Nothing runs at
import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..ops import _cuda

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")
STEM = "paddle_tpu_torch_host"


def library_path() -> Path:
    """Where the host library is built (content-addressed)."""
    return _cuda.content_path(STEM, CXX_FLAGS, sorted(HOST_SRC.glob("*")))


def build() -> Path:
    """Compile the host library unless it is built; returns its path."""
    out = library_path()
    cmd = ["g++", *CXX_FLAGS, *sorted(str(p) for p in HOST_SRC.glob("*.cc"))]
    _cuda.compile_all({"the port's host library": (cmd, out)})
    return out


def _bind(lib):
    c = ctypes
    for name, (res, args) in {
            "pt_buffer_free": (None, [c.c_void_p]),
            "pt_feed_create": (c.c_void_p, [c.c_char_p, c.c_uint64, c.c_uint64, c.c_int,
                                            c.c_uint64, c.c_int, c.c_uint64, c.c_int]),
            "pt_feed_start_epoch": (None, [c.c_void_p]),
            "pt_feed_next": (c.c_uint64, [c.c_void_p, c.POINTER(c.c_void_p)]),
            "pt_feed_destroy": (None, [c.c_void_p])}.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def load() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    return _cuda.load_cached(STEM, build, _bind)
