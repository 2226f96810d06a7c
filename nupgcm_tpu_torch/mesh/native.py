"""ctypes bindings for the native meshkit library (native/meshkit.cpp).

Fast host-side mesh preprocessing (unique edges, RCM, partitioning,
.msh parsing) with NumPy/SciPy fallbacks when the shared library is
missing.  The library is built on
first use if a compiler is available (``native/Makefile``).

This loads the same ``native/libmeshkit.so`` as ``nupgcm_tpu`` and
makes the same native-or-SciPy choice: native RCM and SciPy RCM give
different dof orderings, so both packages must take the same branch
for their dof layouts to agree.

Processes that start together (parallel test workers, a batch of
runs) must not build the library over each other: a reader that finds
a half-written ``libmeshkit.so`` fails to load it and falls back to
SciPy for the rest of its life, while its neighbours load the finished
file.  So the build runs under an exclusive lock on ``native/``, into
a temporary directory, and the finished library is moved into place in
one rename; a library that exists but does not load is rebuilt (if
that build fails too, loading it raises instead of falling back).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import warnings

import numpy as np

_LIB = None
_TRIED = False


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _loads(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def _build(native: str, path: str) -> None:
    """Build with native/Makefile's own rule into a temporary directory
    beside it, then move the library into place atomically.  ``-B``:
    make's VPATH search also finds the target, and would otherwise take
    a broken ``native/libmeshkit.so`` newer than its source as built.
    A failed build warns with the compiler's output."""
    tmp = tempfile.mkdtemp(prefix=".build-", dir=native)
    try:
        subprocess.run(
            ["make", "-B", "-C", tmp, "-f", os.path.join(native, "Makefile"),
             f"VPATH={native}", "libmeshkit.so"],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(os.path.join(tmp, "libmeshkit.so"), path)
    except subprocess.CalledProcessError as e:
        warnings.warn(f"building native/libmeshkit.so failed:\n{e.stdout}{e.stderr}")
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"building native/libmeshkit.so failed: {e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(build: bool = True):
    """Load (and if needed build) libmeshkit.so; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    native = os.path.join(_repo_root(), "native")
    path = os.path.join(native, "libmeshkit.so")
    if build and os.access(native, os.W_OK):
        fd = os.open(native, os.O_RDONLY)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            if not (os.path.exists(path) and _loads(path)):
                _build(native, path)
        finally:
            os.close(fd)  # releases the lock
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
    lib.meshkit_partition_cells.restype = None
    lib.meshkit_partition_cells.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.meshkit_parse_msh.restype = ctypes.c_void_p
    lib.meshkit_parse_msh.argtypes = [ctypes.c_char_p]
    for name in ("meshkit_msh_n_nodes", "meshkit_msh_n_blocks", "meshkit_msh_conn_size"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.meshkit_msh_copy.restype = None
    lib.meshkit_msh_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                     i64p, i64p, i64p, i64p]
    lib.meshkit_msh_free.restype = None
    lib.meshkit_msh_free.argtypes = [ctypes.c_void_p]
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


def partition_cells(cell_dofs: np.ndarray, ndof: int, nparts: int) -> np.ndarray:
    """Shard of each cell by the owned range of its lowest dof
    (``ceil(ndof / nparts)`` dofs a shard), int32; native or numpy."""
    lib = load()
    cell_dofs = _i64(cell_dofs)
    nc, nloc = cell_dofs.shape
    if lib is None:
        per = -(-ndof // nparts)
        return np.minimum(cell_dofs.min(axis=1) // per, nparts - 1).astype(np.int32)
    out = np.empty(nc, dtype=np.int32)
    lib.meshkit_partition_cells(
        cell_dofs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nc, nloc, ndof, nparts,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


# gmsh element type -> nodes per element
_NODES_PER_TYPE = {15: 1, 1: 2, 2: 3, 4: 4, 8: 3, 9: 6, 11: 10}


def parse_msh_fast(path: str):
    """Native $Nodes/$Elements parse of a gmsh 4.1 file: (coords (n, 3),
    node_ids (n,), blocks), each block (dim, entity_tag, type,
    conn (n_elements, n_nodes) of node ids); None when the native
    library is unavailable or cannot parse the file."""
    lib = load()
    if lib is None:
        return None
    h = lib.meshkit_parse_msh(path.encode())
    if not h:
        return None
    try:
        nn = lib.meshkit_msh_n_nodes(h)
        nb = lib.meshkit_msh_n_blocks(h)
        coords = np.empty((nn, 3), dtype=np.float64)
        node_ids = np.empty(nn, dtype=np.int64)
        meta = np.empty(nb * 4, dtype=np.int64)
        offs = np.empty(nb, dtype=np.int64)
        conn = np.empty(lib.meshkit_msh_conn_size(h), dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.meshkit_msh_copy(
            h, coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            node_ids.ctypes.data_as(i64p), meta.ctypes.data_as(i64p),
            offs.ctypes.data_as(i64p), conn.ctypes.data_as(i64p),
        )
    finally:
        lib.meshkit_msh_free(h)
    blocks = []
    for b in range(nb):
        dim, tag, typ, n = (int(v) for v in meta[4 * b: 4 * b + 4])
        nv = _NODES_PER_TYPE[typ]
        blocks.append((dim, tag, typ, conn[offs[b]: offs[b] + n * nv].reshape(n, nv)))
    return coords, node_ids, blocks
