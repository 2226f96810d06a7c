"""Eigenmode analysis of the PG operators.

Capability parity with the reference's KrylovKit-based eigenanalysis
(reference scratch/eigen.jl) and ``nupgcm_tpu.tools.eigen``: the
model's operators are wrapped as SciPy ``LinearOperator``s and the
leading/trailing eigenpairs computed on the host by ARPACK.  Each
matvec moves the host vector to the model's device and dtype, applies
the port's own ``MaskedOperator``s (on a CUDA device: the element-matvec
kernels) and returns float64 NumPy.  ``matvec_count`` counts the
applications since it was last reset.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla
import torch

from ..ops.sparse import MaskedOperator
from ..utils.misc import to_numpy

matvec_count = 0


def _as_linop(model, matvec, n, dtype=np.float64):
    def mv(v):
        global matvec_count
        matvec_count += 1
        x = torch.as_tensor(np.ascontiguousarray(v.reshape(-1)), dtype=model.dtype,
                            device=model.device)
        return to_numpy(matvec(x)).astype(dtype)

    return spla.LinearOperator((n, n), matvec=mv, dtype=dtype)


def evolution_spectrum(model, k: int = 6, which: str = "LM"):
    """Leading eigenvalues of the Dirichlet-pinned evolution operator
    A = M + theta (Kh + Kv)."""
    theta = float(model.ts.dt) * model.params.a2e2 / model.params.mu_rho
    A = MaskedOperator(model._evo_matrix(model.ops, theta), model.const["free_b"])
    n = model.fe.spaces.n_b
    vals = spla.eigsh(_as_linop(model, A, n), k=k, which=which, tol=1e-8,
                      return_eigenvectors=False)
    return np.sort(vals)


def inversion_spectrum(model, k: int = 6, which: str = "LM", sigma=None):
    """Eigenvalues of the Dirichlet-pinned saddle inversion operator
    (nonsymmetric; use which='SM'/sigma for the small end)."""
    A = MaskedOperator(model._inv_matrix(model.ops), model.const["free_inv"])
    n = model.fe.n_inv
    vals = spla.eigs(_as_linop(model, A, n), k=k, which=which, sigma=sigma,
                     tol=1e-6, return_eigenvectors=False)
    return vals[np.argsort(np.abs(vals))]


def preconditioned_inversion_spectrum(model, k: int = 6):
    """Eigenvalues of M^-1 A (block-Stokes preconditioned saddle
    operator) -- the quantity that controls GMRES convergence."""
    # what the solves apply, built when ``model.ops`` was set; a captured
    # preconditioner's own, applied whole (a capture here would leave
    # the caller's matmul precision in the graph the steps replay)
    A, M, _ = model._inv
    M = getattr(M, "pc", M)
    n = model.fe.n_inv
    vals = spla.eigs(_as_linop(model, lambda v: M(A(v)), n), k=k, which="LM", tol=1e-6,
                     return_eigenvectors=False)
    return vals[np.argsort(np.abs(vals))]
