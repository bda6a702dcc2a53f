"""Native (C++) host kernels, loaded through ctypes.

The reference's compiled components are an external C++ chemistry
solver (pyfastchem) and numba-JITed aggregation kernels
(`/root/reference/frei/interp.py:115-137,163-194`).  frei_tpu's
equivalents: the chemistry solver is pure JAX
(``frei_tpu.chemistry.fastchem``), and the host-side aggregation kernel
is this C++ library — compiled on first use with g++ (no pybind11
dependency; plain ``extern "C"`` + ctypes), threaded over table rows.

The native path matters for the ETL of multi-GB opacity stores on
hosts where the accelerator is busy with the solve: ingest and rebin
stream through CPU threads while the accelerator runs columns.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "grouped_trapezoid_native", "build_native"]

_HERE = Path(__file__).parent
_LIB_PATH = _HERE / "libfrei_native.so"
_lib = None


def build_native(force: bool = False) -> Path:
    """Compile the native library (idempotent)."""
    src = _HERE / "rebin.cc"
    if _LIB_PATH.exists() and not force and \
            _LIB_PATH.stat().st_mtime >= src.stat().st_mtime:
        return _LIB_PATH
    # Compile to a per-process temp name and os.replace into place:
    # concurrent processes (multi-process runs, pytest-xdist) may both
    # build, and a partially-written .so with a fresh mtime would make
    # every later build_native() skip recompiling while CDLL fails —
    # permanently disabling the native engine until manual deletion.
    tmp = _LIB_PATH.with_name(f".{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC",
        "-shared", "-pthread", str(src), "-o", str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if tmp.exists():
            try:
                tmp.unlink()
            except OSError:
                pass
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None:
        build_native()
        _lib = ctypes.CDLL(str(_LIB_PATH))
        _lib.bin_codes.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib.grouped_trapz.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32,
        ]
    return _lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def grouped_trapezoid_native(values, x, edges, n_threads=None):
    """(R, N) float32 samples on grid ``x`` -> (R, B) per-bin trapezoid
    integrals; exact same-bin-pair semantics as
    :func:`frei_tpu.ops.rebin.resort_rebin`."""
    lib = _load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    x = np.ascontiguousarray(x, dtype=np.float64)
    edges = np.ascontiguousarray(edges, dtype=np.float64)
    R, N = values.shape
    B = edges.shape[0] - 1
    codes = np.empty(N, dtype=np.int32)
    lib.bin_codes(_ptr(x, ctypes.c_double), N,
                  _ptr(edges, ctypes.c_double), B + 1,
                  _ptr(codes, ctypes.c_int32))
    out = np.zeros((R, B), dtype=np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.grouped_trapz(_ptr(values, ctypes.c_float),
                      _ptr(x, ctypes.c_double),
                      _ptr(codes, ctypes.c_int32),
                      _ptr(out, ctypes.c_float),
                      R, N, B, int(n_threads))
    return out
