"""Build and load the CUDA element-matvec library (nvcc + ctypes).

``load()`` compiles ``csrc/element_matvec.cu`` for sm_90a into
``nupgcm_tpu_torch/_build/`` at first use (the file name carries a hash
of the source, so an edited source is rebuilt) and binds its plain C
interface with ctypes.  A missing ``nvcc`` or a failed compile raises
``RuntimeError`` with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "element_matvec.cu"
BUILD_DIR = _PKG / "_build"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
# what the last compile in this process printed (ptxas register and
# spill report) and how long it took; None when the library was cached
build_log = None
build_seconds = None


def nvcc_path() -> str:
    """The nvcc of $CUDA_HOME, of $PATH, or of /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME")
    for cand in (os.path.join(home, "bin", "nvcc") if home else None,
                 shutil.which("nvcc"), NVCC_DEFAULT):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, $PATH and {NVCC_DEFAULT}): "
        "the CUDA element-matvec kernels are built "
        f"from {SOURCE} and need the CUDA toolkit")


def library_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libelement_matvec_{tag}.so"


def compile_library(path: Path) -> None:
    global build_log, build_seconds
    nvcc = nvcc_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def load():
    """The bound library, compiled first if it is not built yet."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        compile_library(path)
    lib = ctypes.CDLL(str(path))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("nupgcm_saddle_matvec_f32", "nupgcm_saddle_matvec_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 10 + [ll, i, i, i, vp]
        fn.restype = i
    for name in ("nupgcm_scalar_matvec_f32", "nupgcm_scalar_matvec_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 4 + [ll, i, vp]
        fn.restype = i
    lib.nupgcm_error_string.argtypes = [i]
    lib.nupgcm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
