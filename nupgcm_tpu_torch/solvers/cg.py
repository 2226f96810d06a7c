"""Preconditioned conjugate gradient.

Semantics follow Krylov.jl's ``cg`` as used by the reference evolution
solve (reference src/evolution.jl:114-126, src/iterative_solvers.jl:58)
and ``nupgcm_tpu.solvers.cg``: stop when ||r||_2 <= atol + rtol *
||r0||_2, cap at itmax iterations (itmax = 0 means 2N).  The loop runs
on the host; the stopping test reads one scalar from the device per
iteration.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SolveStats:
    iterations: int
    residual: float
    converged: bool


def _safe(v: torch.Tensor) -> torch.Tensor:
    """v, with exact zeros replaced by 1 (guarded divisions)."""
    return torch.where(v == 0, torch.ones_like(v), v)


def cg(op, b, x0, *, M_diag_inv=None, M=None, atol=1e-6, rtol=1e-6, itmax=0):
    """Solve op(x) = b with preconditioned CG.

    op: callable x -> A x (SPD on the relevant subspace)
    M_diag_inv: diagonal preconditioner entries (1/diag), or
    M: callable r -> M^{-1} r (overrides M_diag_inv)
    Returns (x, SolveStats).
    """
    if itmax == 0:
        itmax = 2 * b.shape[0]
    if M is None and M_diag_inv is not None:
        M = lambda r: M_diag_inv * r
    if M is None:
        M = lambda r: r

    x = x0
    r = b - op(x0)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    rnorm = float(torch.sqrt(torch.dot(r, r)))
    tol = atol + rtol * rnorm
    k = 0
    while rnorm > tol and k < itmax:
        Ap = op(p)
        alpha = rz / _safe(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / _safe(rz)) * p
        rz = rz_new
        k += 1
        rnorm = float(torch.sqrt(torch.dot(r, r)))
    return x, SolveStats(iterations=k, residual=rnorm, converged=rnorm <= tol)
