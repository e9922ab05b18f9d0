"""Native (C++) binning kernels, compiled lazily and loaded via ctypes.

The reference has no native code (SURVEY.md §2: all-Python); this
framework's runtime layer uses native kernels for the host-side ingestion
hot path (binning 1e7+ spikes).  Falls back transparently to the vectorized
numpy implementations in :mod:`poor_man_gplvm_tpu.data.binning` when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["available", "bin_sliding_native", "bin_overlapping_native"]

_LIB = None
_TRIED = False


def _cache_dirs():
    """User cache locations (never the installed package directory)."""
    dirs = []
    xdg = os.environ.get("XDG_CACHE_HOME")
    home = os.path.expanduser("~")
    if xdg:
        dirs.append(os.path.join(xdg, "poor_man_gplvm_tpu"))
    elif home and home != "~":
        dirs.append(os.path.join(home, ".cache", "poor_man_gplvm_tpu"))
    dirs.append(os.path.join(tempfile.gettempdir(), "poor_man_gplvm_tpu"))
    return dirs


def _compile_and_load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(os.path.dirname(__file__), "binning.cpp")
    try:
        with open(src, "rb") as f:
            src_bytes = f.read()
    except OSError:
        return None
    # key the cached .so by source content so a changed source never loads
    # a stale binary (checkout mtimes are unreliable); portable codegen
    # only — no -march=native, the cache may be shared across machines
    key = hashlib.sha256(src_bytes).hexdigest()[:16]
    for cache_dir in _cache_dirs():
        so_path = os.path.join(cache_dir, f"binning_{key}.so")
        if not os.path.exists(so_path):
            try:
                os.makedirs(cache_dir, exist_ok=True)
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so_path)
            except (OSError, subprocess.CalledProcessError):
                continue
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            continue
        lib.bin_sliding.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.bin_overlapping.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        _LIB = lib
        break
    return _LIB


def available():
    return _compile_and_load() is not None


def _as_ptrs(spike_times, rows):
    st = np.ascontiguousarray(spike_times, dtype=np.float64)
    rw = np.ascontiguousarray(rows, dtype=np.int64)
    return (
        st, rw,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rw.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )


def bin_sliding_native(spike_times, rows, window, step, n_windows, n_units):
    """Start-aligned sliding-window counts; returns (n_units, n_windows)."""
    lib = _compile_and_load()
    if lib is None:
        raise RuntimeError("native binning unavailable (no compiler)")
    st, rw, st_p, rw_p = _as_ptrs(spike_times, rows)
    out = np.zeros((n_units, n_windows), dtype=np.float64)
    lib.bin_sliding(
        st_p, rw_p, len(st), float(window), float(step), int(n_windows),
        int(n_units), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def bin_overlapping_native(spike_times, rows, t_start, window, step,
                           n_windows, n_units):
    """Overlapping-window counts; returns (n_units, n_windows)."""
    lib = _compile_and_load()
    if lib is None:
        raise RuntimeError("native binning unavailable (no compiler)")
    st, rw, st_p, rw_p = _as_ptrs(spike_times, rows)
    out = np.zeros((n_units, n_windows), dtype=np.float64)
    lib.bin_overlapping(
        st_p, rw_p, len(st), float(t_start), float(window), float(step),
        int(n_windows), int(n_units),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out
