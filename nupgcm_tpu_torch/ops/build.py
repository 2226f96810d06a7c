"""Build and load the CUDA kernel library (nvcc + ctypes).

``load()`` compiles every ``csrc/*.cu`` for sm_90a -- one ``nvcc -c``
per source, all started together, then one link -- into a shared
library in ``nupgcm_tpu_torch/_build/`` at first use (the file name
carries a hash of all the sources, so an edited source is rebuilt) and
binds its plain C interface with ctypes.  A missing ``nvcc`` or a
failed compile raises ``RuntimeError`` with the compiler's output:
there is no fallback.
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
SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
BUILD_DIR = _PKG / "_build"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
        "the CUDA kernels are built from "
        f"{', '.join(s.name for s in SOURCES)} and need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha1()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnupgcm_kernels_{h.hexdigest()[:12]}.so"


def _check_run(cmd, proc, out: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}")


def compile_library(path: Path) -> None:
    global build_log, build_seconds
    nvcc = nvcc_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [path.with_name(f"{tag}.{src.stem}.o") for src in SOURCES]
    tmp = path.with_name(f"{tag}.so.tmp")
    t0 = time.perf_counter()
    jobs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    logs = []
    try:
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            _check_run(cmd, proc, out)
            logs.append(out)
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_run(cmd, proc, proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent build never sees a partial file
    finally:
        for cmd, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


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
    lib.nupgcm_em_prepare.argtypes = [vp]
    lib.nupgcm_em_prepare.restype = i
    lib.nupgcm_em_apply.argtypes = [vp] * 5
    lib.nupgcm_em_apply.restype = i
    for name in ("nupgcm_stream_saddle_f32", "nupgcm_stream_saddle_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [vp] * 6 + [ll, i, i, i, vp]
        fn.restype = i
    lib.nupgcm_stream_probe_f32.argtypes = [vp] * 3 + [i] * 3 + [vp] * 9 + [i, vp, vp, ll, vp]
    lib.nupgcm_stream_probe_f32.restype = i
    lib.nupgcm_error_string.argtypes = [i]
    lib.nupgcm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
