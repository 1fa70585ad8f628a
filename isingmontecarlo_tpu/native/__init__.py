"""Native (C++) host-side components, loaded via ctypes.

The device compute path is JAX/XLA (plus the CUDA kernels of ops/); these
cover host-side hot paths —
today the graph compiler (adjacency construction, greedy vertex coloring,
strong edge coloring), which pure Python does with large constant factors
(minutes for 256^2 lattices).

The shared library is compiled on first use with ``g++ -O2`` and cached next
to the source; every entry point has a pure-Python fallback in
:mod:`isingmontecarlo_tpu.lattice`, so a missing toolchain only costs speed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "graphc.cpp")
_SO = os.path.join(_HERE, "_graphc.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.graphc_degrees.restype = ctypes.c_int32
        lib.graphc_degrees.argtypes = [ctypes.c_int32, ctypes.c_int32, i32p, i32p]
        lib.graphc_adjacency.restype = None
        lib.graphc_adjacency.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, f32p, ctypes.c_int32,
            i32p, f32p, i32p,
        ]
        lib.graphc_vertex_coloring.restype = ctypes.c_int32
        lib.graphc_vertex_coloring.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p,
        ]
        lib.graphc_edge_coloring.restype = ctypes.c_int32
        lib.graphc_edge_coloring.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p,
        ]
        _lib = lib
        return _lib


def adjacency(nvars: int, ev: np.ndarray, ej: np.ndarray):
    """Native padded adjacency; returns (neigh, nj) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ev = np.ascontiguousarray(ev, np.int32)
    ej = np.ascontiguousarray(ej, np.float32)
    ne = ev.shape[0]
    deg_arr = np.zeros(nvars, np.int32)
    deg = max(1, int(lib.graphc_degrees(nvars, ne, ev, deg_arr)))
    neigh = np.empty((nvars, deg), np.int32)
    nj = np.empty((nvars, deg), np.float32)
    nbond = np.empty((nvars, deg), np.int32)
    lib.graphc_adjacency(nvars, ne, ev, ej, deg, neigh, nj, nbond)
    return neigh, nj

def vertex_coloring(nvars: int, ev: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    ev = np.ascontiguousarray(ev, np.int32)
    colors = np.empty(nvars, np.int32)
    lib.graphc_vertex_coloring(nvars, ev.shape[0], ev, colors)
    return colors


def edge_coloring(nvars: int, ev: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    ev = np.ascontiguousarray(ev, np.int32)
    colors = np.empty(ev.shape[0], np.int32)
    lib.graphc_edge_coloring(nvars, ev.shape[0], ev, colors)
    return colors
