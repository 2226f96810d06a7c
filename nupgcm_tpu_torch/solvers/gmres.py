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
iteration (which the stopping test needs anyway).  The reads go through
``utils/timing.read`` (sites ``gmres.beta0``, ``gmres.beta`` a restart
cycle, ``gmres.h`` an iteration); each iteration is the span
``<name>.iter``, within it ``<name>.precond``, ``<name>.op`` and
``<name>.gs`` (the CGS2 products and the norm).

Stopping: ||r_pre|| <= atol + rtol * ||r0_pre|| in the preconditioned
residual norm for left preconditioning (Krylov.jl semantics), true
residual norm for FGMRES.

``reduce`` is the counterpart of the JAX solver's ``psum_axis``: the
vectors are one rank's part of a distributed vector, the Gram-Schmidt
products and norms are this rank's partials, and ``reduce`` sums them
over the ranks.  The Hessenberg recurrence and every stopping test then
read reduced values, identical on every rank.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from ..utils.timing import read, span
from .cg import SolveStats, _safe


def _givens(a, b):
    r = np.hypot(a, b)
    if r == 0:
        return a.dtype.type(1.0), a.dtype.type(0.0), r
    return a / r, b / r, r


def _rotate(h, j, R, g, cs, sn):
    """Column ``j`` of the Hessenberg matrix (``h``, its j + 2 entries)
    into the triangular factor: the earlier rotations, then its own;
    returns the residual norm after it."""
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
    return abs(g[j + 1])


def gmres(op, b, x0, *, M=None, m=20, atol=1e-6, rtol=1e-6, itmax=0,
          flexible=False, reduce=None, name="gmres"):
    """Solve op(x) = b with restarted (F)GMRES(m).

    op: callable x -> A x.
    M: preconditioner callable r -> M^{-1} r (left unless flexible).
    reduce: None, or a callable that sums local inner products (a
    scalar or a vector of them) over the ranks.
    name: the label of the solve's spans.
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

    red = (lambda v: v) if reduce is None else reduce
    it_name, pre_name, op_name, gs_name = (name + k for k in (".iter", ".precond", ".op", ".gs"))

    def norm(v):
        return torch.sqrt(red(torch.dot(v, v)))

    def cycle(x, r):
        """One restart cycle from residual r; returns (x_new, resid, inner_iters)."""
        beta_t = norm(r)
        V = b.new_zeros((m + 1, n))
        V[0] = r / _safe(beta_t)
        Z = b.new_zeros((m, n)) if flexible else None
        R = np.zeros((m, m), sdt)  # upper-triangular factor, columns
        g = np.zeros(m + 1, sdt)
        g[0] = read(beta_t, "gmres.beta")
        cs = np.zeros(m, sdt)
        sn = np.zeros(m, sdt)
        j, res = 0, g[0]
        while j < m and res > tol:
            with span(it_name):
                if flexible:
                    with span(pre_name):
                        Z[j] = M(V[j])
                    with span(op_name):
                        w = op(Z[j])
                else:
                    with span(op_name):
                        w = op(V[j])
                    with span(pre_name):
                        w = M(w)
                with span(gs_name):
                    Vj = V[: j + 1]
                    h1 = red(Vj @ w)
                    w = w - Vj.T @ h1
                    h2 = red(Vj @ w)
                    w = w - Vj.T @ h2
                    hnorm = norm(w)
                    V[j + 1] = w / _safe(hnorm)
                h = read(torch.cat([h1 + h2, hnorm[None]]), "gmres.h", "numpy")  # (j + 2,)
                res = _rotate(h, j, R, g, cs, sn)
                j += 1
        if j == 0:
            return x, res, 0
        y = scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False)
        basis = Z[:j] if flexible else V[:j]
        return x + basis.T @ torch.as_tensor(y, dtype=b.dtype, device=b.device), res, j

    r = pre_resid(x0)
    beta0 = read(norm(r), "gmres.beta0", "float")
    tol = atol + rtol * beta0
    x, res, total = x0, beta0, 0
    while res > tol and total < itmax:
        x, res, j = cycle(x, pre_resid(x) if r is None else r)
        r = None
        total += j
    return x, SolveStats(iterations=total, residual=float(res), converged=bool(res <= tol))


# -- one GMRES(m) cycle from zero, its device and host halves apart ------
def arnoldi(op, b, M, m, name="gmres"):
    """The device half of ``gmres(op, b, 0, M=M, m=m, itmax=m)`` (left
    preconditioning): all ``m`` Arnoldi steps, with no read.  Returns
    (V (m + 1, n), hb): ``hb`` is [beta, H] flat, H (m, m + 1) holding in
    row j the j + 2 entries that step j reads.  ``lsq`` finishes the
    solve on the host from ``hb``; the steps past its stop are not used.
    The same operations as ``gmres``'s, so the same numbers (``op(0)``,
    exactly zero, is not applied)."""
    n = b.shape[0]
    r = M(b)
    it_name, pre_name, op_name, gs_name = (name + k for k in (".iter", ".precond", ".op", ".gs"))
    beta = torch.sqrt(torch.dot(r, r))
    V = b.new_zeros((m + 1, n))
    V[0] = r / _safe(beta)
    H = b.new_zeros((m, m + 1))
    for j in range(m):
        with span(it_name):
            with span(op_name):
                w = op(V[j])
            with span(pre_name):
                w = M(w)
            with span(gs_name):
                Vj = V[: j + 1]
                h1 = Vj @ w
                w = w - Vj.T @ h1
                h2 = Vj @ w
                w = w - Vj.T @ h2
                hnorm = torch.sqrt(torch.dot(w, w))
                V[j + 1] = w / _safe(hnorm)
            H[j, : j + 2] = torch.cat([h1 + h2, hnorm[None]])
    return V, torch.cat([beta[None], H.reshape(-1)])


def lsq(hb, m, atol, rtol):
    """The host half of that cycle from ``arnoldi``'s ``hb`` (a host
    array in the working precision): (y, j), the combination of the
    first j basis vectors that ``gmres`` adds to x0, with j = 0 (and y
    None) where it would return x0."""
    sdt = hb.dtype.type
    beta0 = float(hb[0])
    if not beta0 > atol + rtol * beta0:
        return None, 0
    tol = atol + rtol * beta0
    H = hb[1:].reshape(m, m + 1)
    R = np.zeros((m, m), sdt)
    g = np.zeros(m + 1, sdt)
    g[0] = hb[0]
    cs = np.zeros(m, sdt)
    sn = np.zeros(m, sdt)
    j, res = 0, g[0]
    while j < m and res > tol:
        res = _rotate(H[j, : j + 2].copy(), j, R, g, cs, sn)
        j += 1
    return scipy.linalg.solve_triangular(R[:j, :j], g[:j], lower=False), j
