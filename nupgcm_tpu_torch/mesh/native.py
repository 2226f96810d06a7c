"""ctypes bindings for the native meshkit library (native/meshkit.cpp).

Fast host-side unique-edge extraction and RCM, with NumPy/SciPy
fallbacks when the shared library is missing.  The library is built on
first use if a compiler is available (`make -C native`).

This loads the same ``native/libmeshkit.so`` as ``nupgcm_tpu`` and
makes the same native-or-SciPy choice: native RCM and SciPy RCM give
different dof orderings, so both packages must take the same branch
for their dof layouts to agree.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(build: bool = True):
    """Load (and if needed build) libmeshkit.so; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(_repo_root(), "native", "libmeshkit.so")
    if not os.path.exists(path) and build:
        try:
            subprocess.run(
                ["make", "-C", os.path.join(_repo_root(), "native")],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.meshkit_unique_edges.restype = ctypes.c_int64
    lib.meshkit_unique_edges.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int, i64p, ctypes.c_int64, i64p,
    ]
    lib.meshkit_rcm.restype = None
    lib.meshkit_rcm.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
    _LIB = lib
    return _LIB


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def unique_edges(cells: np.ndarray):
    """Native unique-edge extraction; falls back to mesh.core."""
    lib = load()
    if lib is None:
        from .core import unique_edges as py_impl

        return py_impl(cells)
    cells = _i64(cells)
    nc, nvert = cells.shape
    nle = 3 if nvert == 3 else 6
    max_edges = nc * nle
    edges = np.empty((max_edges, 2), dtype=np.int64)
    cell_edges = np.empty((nc, nle), dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    ne = lib.meshkit_unique_edges(
        cells.ctypes.data_as(i64p), nc, nvert,
        edges.ctypes.data_as(i64p), max_edges,
        cell_edges.ctypes.data_as(i64p),
    )
    if ne < 0:
        raise RuntimeError("meshkit_unique_edges capacity error")
    return edges[:ne].copy(), cell_edges


def rcm(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Native RCM on a CSR graph; scipy fallback."""
    lib = load()
    n = len(indptr) - 1
    if lib is None:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        g = sp.csr_matrix(
            (np.ones(len(indices), np.int8), _i64(indices), _i64(indptr)),
            shape=(n, n),
        )
        return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True), np.int64)
    indptr = _i64(indptr)
    indices = _i64(indices)
    perm = np.empty(n, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.meshkit_rcm(
        indptr.ctypes.data_as(i64p), indices.ctypes.data_as(i64p), n,
        perm.ctypes.data_as(i64p),
    )
    return perm
