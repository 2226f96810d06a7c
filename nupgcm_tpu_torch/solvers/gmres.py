"""Restarted GMRES(m) and flexible FGMRES(m).

The reference's inversion solve is Krylov.jl GMRES with restart memory
20 and a left preconditioner (reference src/inversion.jl:74-93,
src/iterative_solvers.jl:58).  Same algorithm as
``nupgcm_tpu.solvers.gmres``:

  * classical Gram-Schmidt with one re-orthogonalization pass (CGS2):
    two matrix-vector products against the Krylov basis per iteration;
  * Givens rotations tracked incrementally for the residual norm;
  * ``flexible=True`` stores the preconditioned directions (FGMRES,
    right preconditioning) so inner-iterative preconditioners (the
    block Stokes preconditioner) are supported.

The basis lives on the device; the small Hessenberg/Givens recurrence
runs on the host in the working precision, fed by one device read per
iteration (which the stopping test needs anyway).

Stopping: ||r_pre|| <= atol + rtol * ||r0_pre|| in the preconditioned
residual norm for left preconditioning (Krylov.jl semantics), true
residual norm for FGMRES.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from .cg import SolveStats, _safe


def _givens(a, b):
    r = np.hypot(a, b)
    if r == 0:
        return a.dtype.type(1.0), a.dtype.type(0.0), r
    return a / r, b / r, r


def gmres(op, b, x0, *, M=None, m=20, atol=1e-6, rtol=1e-6, itmax=0,
          flexible=False):
    """Solve op(x) = b with restarted (F)GMRES(m).

    op: callable x -> A x.
    M: preconditioner callable r -> M^{-1} r (left unless flexible).
    Returns (x, SolveStats).
    """
    n = b.shape[0]
    sdt = np.float32 if b.dtype == torch.float32 else np.float64
    if itmax == 0:
        itmax = 2 * n
    if M is None:
        M = lambda r: r

    def pre_resid(x):
        r = b - op(x)
        return r if flexible else M(r)

    def norm(v):
        return torch.sqrt(torch.dot(v, v))

    def cycle(x, r):
        """One restart cycle from residual r; returns (x_new, resid, inner_iters)."""
        beta_t = norm(r)
        V = b.new_zeros((m + 1, n))
        V[0] = r / _safe(beta_t)
        Z = b.new_zeros((m, n)) if flexible else None
        R = np.zeros((m, m), sdt)  # upper-triangular factor, columns
        g = np.zeros(m + 1, sdt)
        g[0] = beta_t.item()
        cs = np.zeros(m, sdt)
        sn = np.zeros(m, sdt)
        j, res = 0, g[0]
        while j < m and res > tol:
            if flexible:
                Z[j] = M(V[j])
                w = op(Z[j])
            else:
                w = M(op(V[j]))
            Vj = V[: j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            hnorm = norm(w)
            V[j + 1] = w / _safe(hnorm)
            h = torch.cat([h1 + h2, hnorm[None]]).cpu().numpy()  # (j + 2,)
            # apply existing rotations to the new column
            for i in range(j):
                hi, hi1 = h[i], h[i + 1]
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            c, s, rr = _givens(h[j], h[j + 1])
            cs[j], sn[j] = c, s
            R[:j, j] = h[:j]
            R[j, j] = rr
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            res = abs(g[j + 1])
            j += 1
        if j == 0:
            return x, res, 0
        y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
        basis = Z[:j] if flexible else V[:j]
        return x + basis.T @ torch.as_tensor(y, dtype=b.dtype, device=b.device), res, j

    r = pre_resid(x0)
    beta0 = float(norm(r))
    tol = atol + rtol * beta0
    x, res, total = x0, beta0, 0
    while res > tol and total < itmax:
        x, res, j = cycle(x, pre_resid(x) if r is None else r)
        r = None
        total += j
    return x, SolveStats(iterations=total, residual=float(res), converged=bool(res <= tol))
