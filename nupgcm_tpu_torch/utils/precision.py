"""Scoped matmul-precision policy.

PyTorch counterpart of ``nupgcm_tpu.utils.precision``.  On an
Ampere-or-later card PyTorch may run float32 matrix products and
convolutions in TF32 (a 10-bit mantissa) whenever the process allows
it: ``torch.set_float32_matmul_precision("high")``, common in user
scripts, turns it on for every float32 ``matmul`` and ``einsum``.  The
FE element contractions and the Krylov basis products need true
float32 accumulation to hold the reference's 1e-3 golden bar
(reference test/bowl_mixing_tests.jl:101-103), as the JAX package
holds them at full float32 on the TPU.

The policy is scoped, never process-global: ``precision_ctx("float32")``
turns TF32 off (``torch.backends.cuda.matmul.allow_tf32``,
``torch.backends.cudnn.allow_tf32``, float32 matmul precision
"highest") for the duration of a block and restores the caller's
settings on exit, also when the block raises.  ``PGModel`` and
``DDModel`` enter it around their build and every entry point.
"""

from __future__ import annotations

import contextlib
import functools

import torch

POLICIES = (None, "float32")


def _read():
    """(cuda matmul allow_tf32, cudnn allow_tf32, float32 matmul
    precision or None where PyTorch cannot name one)."""
    try:
        prec = torch.get_float32_matmul_precision()
    except RuntimeError:  # the legacy and the per-backend APIs were mixed
        prec = None
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec)


def _write(matmul_tf32: bool, cudnn_tf32: bool, prec) -> None:
    # the precision first: it also sets the matmul flag, which is then
    # written only where it differs (writing it resets the precision)
    if prec is not None:
        torch.set_float32_matmul_precision(prec)
    if torch.backends.cuda.matmul.allow_tf32 != matmul_tf32:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    if torch.backends.cudnn.allow_tf32 != cudnn_tf32:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


@contextlib.contextmanager
def _full_float32():
    saved = _read()
    _write(False, False, "highest")
    try:
        yield
    finally:
        _write(*saved)


def precision_ctx(precision):
    """Context manager holding float32 products at full precision when
    ``precision`` is "float32"; a no-op for ``None``."""
    if precision is None:
        return contextlib.nullcontext()
    if precision not in POLICIES:
        raise ValueError(f"matmul precision must be one of {POLICIES}, got {precision!r}")
    return _full_float32()


def scoped_precision(fn, precision):
    """Wrap ``fn`` so its body runs under the given matmul precision.
    Identity for ``precision=None``."""
    if precision is None:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precision_ctx(precision):
            return fn(*args, **kwargs)

    return wrapped


def scoped_method(fn):
    """Method decorator: run ``fn`` under ``self.matmul_precision``."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        with precision_ctx(self.matmul_precision):
            return fn(self, *args, **kwargs)

    return wrapped
