"""Preconditioners for the PG inversion solve.

Counterpart of ``nupgcm_tpu.solvers.preconditioners``: the block Stokes
preconditioner with fixed-iteration Chebyshev smoothing of the velocity
block and the pressure mass matrix, the P1-vertex two-grid correction of
the velocity block, the P1-P1 saddle-coarse correction and its second
(aggregate) level, all wrapped in FGMRES by the model.
The reference's own strategy (src/inversion.jl:42-59,
src/preconditioners.jl) needs tens of thousands of
1/h^dim-preconditioned iterations (BASELINE.md); this needs O(10).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import kernels
from ..ops.sparse import MaskedOperator
from ..utils.timing import span
from .cg import cg
from .gmres import arnoldi, gmres

INNER_RTOL = 1e-8  # the inner solves' relative tolerance (no absolute one)


def chebyshev(op, dinv: torch.Tensor, r: torch.Tensor, k: int,
              lmin, lmax) -> torch.Tensor:
    """k-step Chebyshev approximation of (D^-1 A)^-1 D^-1 r.

    The textbook SPD Chebyshev smoother (Saad, Iterative Methods,
    Alg. 12.1) on the Jacobi-scaled operator with eigenvalue bounds
    [lmin, lmax].  No dot products: every iteration is one matvec and
    two vector updates, with no device read.  The updates of each step
    are one launch (``kernels.ChebStep``); a ``MaskedOperator``'s mask
    is folded into them, so a step applies its matrix alone.  r is
    never written.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    free = op.free if isinstance(op, MaskedOperator) else None
    apply = op if free is None else op.mat.matvec
    c = kernels.ChebStep(r, dinv, free, 1.0 / theta)
    for _ in range(k - 1):
        rho1 = 1.0 / (2.0 * sigma1 - rho)
        c.step(apply(c.dm), rho1 * rho, 2.0 * rho1 / delta)
        rho = rho1
    return c.z


def power_lmax(op, dinv: torch.Tensor, n: int, iters: int = 30) -> torch.Tensor:
    """Largest eigenvalue estimate of D^-1 A via power iteration
    (deterministic start), with a 10% safety margin."""
    v = torch.cos(torch.arange(n, dtype=dinv.dtype, device=dinv.device))
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = dinv * op(v)
        v = w / torch.linalg.vector_norm(w)
    w = dinv * op(v)
    return 1.1 * torch.dot(v, w) / torch.dot(v, v)


def jacobi(diag: torch.Tensor):
    """Pointwise inverse-diagonal preconditioner."""
    inv = 1.0 / diag
    return lambda r: inv * r


def const_diag(scale: float):
    """Constant diagonal scaling (reference 1/h^dim preconditioner)."""
    return lambda r: r / scale


@dataclass
class CoarseCorrection:
    """P1-vertex two-grid correction for the velocity block.

    Given a smoothed iterate z for A z = r, restricts the residual to
    the vertex coarse space (the transpose of the exact P1 c P2
    inclusion, a scatter-add), solves it with ``solve`` -- a dense
    coarse inverse (small meshes) or inner CG on the element-local P1
    operator -- and prolongs the correction back.  Flattens the
    h-dependence of the outer iteration count that pure Chebyshev
    smoothing suffers.
    """

    solve: callable  # rc (3nv,) -> zc (3nv,)
    parents: torch.Tensor  # (n_nodes, 2) int64 coarse vertex dofs
    weights: torch.Tensor  # (n_nodes, 2) inclusion weights (1,0)/(.5,.5)
    coarse_free: torch.Tensor  # (3nv,) mask
    free_u: torch.Tensor  # (3*n_nodes,) fine mask
    n_vert: int

    def __call__(self, A, r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        with span("precond.twogrid"):
            rf = (r - A(z)).reshape(-1, 3)  # node-major (node, comp)
            contrib = self.weights[:, :, None] * rf[:, None, :]  # (n, 2, 3)
            rcoarse = r.new_zeros((self.n_vert, 3)).index_add_(
                0, self.parents.reshape(-1), contrib.reshape(-1, 3)).reshape(-1)
            zc = self.solve(rcoarse * self.coarse_free) * self.coarse_free
            corr = (self.weights[:, :, None] * zc.reshape(-1, 3)[self.parents]).sum(dim=1)
            return z + corr.reshape(-1) * self.free_u


@dataclass
class SaddleCoarseCorrection:
    """P1-P1 coarse correction over the FULL (u, p) saddle residual.

    Captures the global geostrophic/baroclinic coupling that the block
    preconditioner's Mp/a2e2 Schur surrogate misses in the
    rotation-dominated (small-Ekman) regime: the coarse problem is the
    same rotating saddle system on the vertex space (BP-stabilized),
    solved by ``solve`` -- a dense precomputed inverse (small meshes)
    or the aggregate-level cycle / inner FGMRES on the element-local
    coarse operator (large meshes).  Velocity restriction/prolongation
    is the exact P1 c P2 inclusion; pressure (already P1) passes
    through unchanged.
    """

    solve: callable  # rc (4nv,) -> zc (4nv,)
    parents: torch.Tensor  # (n_nodes, 2) int64
    weights: torch.Tensor  # (n_nodes, 2)
    coarse_free_u: torch.Tensor  # (3nv,)
    free_fine: torch.Tensor  # (N,) full fine free mask
    n_vert: int
    nu_dofs: int  # fine velocity dof count

    def _restrict(self, r: torch.Tensor) -> torch.Tensor:
        ru = r[: self.nu_dofs].reshape(-1, 3)
        contrib = self.weights[:, :, None] * ru[:, None, :]
        rcu = r.new_zeros((self.n_vert, 3)).index_add_(
            0, self.parents.reshape(-1), contrib.reshape(-1, 3))
        return torch.cat([rcu.reshape(-1) * self.coarse_free_u, r[self.nu_dofs:]])

    def _prolong(self, zc: torch.Tensor) -> torch.Tensor:
        zcu = (zc[: 3 * self.n_vert] * self.coarse_free_u).reshape(-1, 3)
        zu = (self.weights[:, :, None] * zcu[self.parents]).sum(dim=1).reshape(-1)
        return torch.cat([zu, zc[3 * self.n_vert:]])

    def __call__(self, A, r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        with span("precond.saddle_coarse"):
            rc = r - A(z)
            zc = self.solve(self._restrict(rc))
            return z + self._prolong(zc) * self.free_fine


@dataclass
class AggregateCoarseCorrection:
    """Second-level (aggregate) correction for the P1-P1 coarse saddle
    system.

    At production scale the vertex coarse system is itself large and
    must be solved iteratively, and the accuracy of that solve drives
    the outer FGMRES count.  Vertices are clustered into contiguous
    aggregates (host BFS at setup), the coarse saddle matrix is
    Galerkin-projected onto piecewise-constant aggregate basis
    functions, and the resulting small system is inverted dense once --
    applied here as one dense matvec between restrict (scatter-add) and
    prolong (gather).  Used multiplicatively after the coarse-level
    block smoother, like the fine-level ``SaddleCoarseCorrection``.
    """

    inv: torch.Tensor      # (4*n_agg, 4*n_agg) dense inverse
    agg: torch.Tensor      # (n_vert,) int64 vertex -> aggregate
    n_agg: int
    free_c: torch.Tensor   # (4*n_vert,) coarse-level free mask

    def __call__(self, A, r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        na = self.n_agg
        nv = self.agg.shape[0]
        with span("precond.aggregate"):
            rc = r - A(z)
            # (na, 3).reshape(-1) lays dofs out as 3*aggregate + component,
            # matching the Galerkin matrix built in
            # models/model.py::_aggregate_matrix
            r2u = rc.new_zeros((na, 3)).index_add_(0, self.agg, rc[: 3 * nv].reshape(nv, 3))
            r2p = rc.new_zeros(na).index_add_(0, self.agg, rc[3 * nv:])
            z2 = self.inv @ torch.cat([r2u.reshape(-1), r2p])
            zu = z2[: 3 * na].reshape(na, 3)[self.agg]
            zp = z2[3 * na:][self.agg]
            return z + torch.cat([zu.reshape(-1), zp]) * self.free_c


@dataclass
class BlockStokesPrecond:
    """Block preconditioner for the (u, p) saddle system.

    M^{-1} = [[A_hat, up], [0, S_hat]]^{-1} (block upper-triangular
    when ``up_coupling`` is given, block-diagonal otherwise), where
    A_hat approximates the Dirichlet-pinned symmetric viscous + |f|-mass
    velocity block and S_hat = M_p / a2e2 the pressure Schur complement.
    Blocks are inverted approximately by fixed-iteration Chebyshev
    smoothing (``method='cg'``: Jacobi-CG; ``'inner_gmres'``: GMRES on
    the full nonsymmetric velocity block), optionally with a two-grid
    V-cycle on the velocity block (``coarse``) or followed by the
    multiplicative saddle-coarse correction.
    """

    visc_op: callable  # SPD u-block smoothing operator (masked)
    visc_diag_inv: torch.Tensor
    mp_op: callable  # pressure mass operator scaled by 1/a2e2
    mp_diag_inv: torch.Tensor
    nu_dofs: int  # velocity dof count
    inner_iters_u: int = 20
    inner_iters_p: int = 5
    method: str = "chebyshev"
    lmax_u: torch.Tensor = None  # spectral bound of D^-1 A_visc
    lmax_p: torch.Tensor = None
    cond_ratio: float = 30.0  # lmin = lmax / cond_ratio
    ublock_op: callable = None  # FULL u-block (viscous + Coriolis)
    up_coupling: callable = None  # p -> u pressure-gradient block (-B^T)
    coarse: object = None  # optional CoarseCorrection (velocity two-grid)
    saddle_coarse: object = None  # optional SaddleCoarseCorrection
    outer_op: callable = None  # full masked saddle operator (for
    #                            residuals of the saddle coarse step)
    reduce: callable = None  # the inner Krylov solves' reduction hook
    #                          (distributed vectors; solvers/gmres.py)
    name: str = None  # a span around each application (the coarse level's)

    def _solve_p(self, rp: torch.Tensor) -> torch.Tensor:
        if self.method == "cg":
            zp, _ = cg(self.mp_op, rp, torch.zeros_like(rp),
                       M_diag_inv=self.mp_diag_inv,
                       atol=0.0, rtol=INNER_RTOL, itmax=self.inner_iters_p, reduce=self.reduce,
                       name="precond.cg")
            return zp
        # pressure mass is well conditioned under Jacobi: tight ratio
        return chebyshev(self.mp_op, self.mp_diag_inv, rp,
                         self.inner_iters_p, self.lmax_p / 4.0, self.lmax_p)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if self.name is None:
            return self._apply(r)
        with span(self.name):
            return self._apply(r)

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        z = self._block(r)
        if self.saddle_coarse is not None:
            # multiplicative two-level step: block pre-smooth, then the
            # geostrophic coarse correction, and NO post-smooth (the
            # Chebyshev u-block amplifies modes below its lmin bound;
            # after the coarse step that stalls the outer FGMRES)
            z = self.saddle_coarse(self.outer_op, r, z)
        return z

    def _block(self, r: torch.Tensor) -> torch.Tensor:
        ru, rp = r[: self.nu_dofs], r[self.nu_dofs:]
        if self.up_coupling is not None:
            # block upper-triangular: with exact blocks the
            # preconditioned spectrum is {1}
            zp = self._smooth_p(rp)
            with span("precond.up"):
                ru = ru - self.up_coupling(zp)
            return torch.cat([self._smooth_u(ru), zp])
        return torch.cat([self._smooth_u(ru), self._smooth_p(rp)])

    def _smooth_p(self, rp: torch.Tensor) -> torch.Tensor:
        with span("precond.smooth_p"):
            return self._solve_p(rp)

    def _smooth_u(self, ru: torch.Tensor) -> torch.Tensor:
        with span("precond.smooth_u"):
            return self._solve_u(ru)

    def _chebyshev_u(self, ru: torch.Tensor) -> torch.Tensor:
        return chebyshev(self.visc_op, self.visc_diag_inv, ru, self.inner_iters_u,
                         self.lmax_u / self.cond_ratio, self.lmax_u)

    def _solve_u(self, ru: torch.Tensor) -> torch.Tensor:
        if self.method == "inner_gmres":
            # rotation-dominated regime: the skew Coriolis term dominates
            # the velocity block, so smooth the FULL (nonsymmetric) block
            zu, _ = gmres(self.ublock_op, ru, torch.zeros_like(ru),
                          M=self._jacobi_u,
                          m=self.inner_iters_u, atol=0.0, rtol=INNER_RTOL,
                          itmax=self.inner_iters_u, reduce=self.reduce, name="precond.gmres")
        elif self.method == "chebyshev":
            zu = self._chebyshev_u(ru)
        else:
            zu, _ = cg(self.visc_op, ru, torch.zeros_like(ru),
                       M_diag_inv=self.visc_diag_inv,
                       atol=0.0, rtol=INNER_RTOL, itmax=self.inner_iters_u, reduce=self.reduce,
                       name="precond.cg")
        return self._post_u(ru, zu)

    def _jacobi_u(self, v: torch.Tensor) -> torch.Tensor:
        return self.visc_diag_inv * v

    def _post_u(self, ru: torch.Tensor, zu: torch.Tensor) -> torch.Tensor:
        if self.coarse is not None:
            # V-cycle: pre-smooth (above), coarse solve, post-smooth
            zu = self.coarse(self.visc_op, ru, zu)
            zu = zu + self._chebyshev_u(ru - self.visc_op(zu))
        return zu

    # -- the inner_gmres application in two device halves (graphed.py) --
    def split_head(self, r: torch.Tensor):
        """The application up to the inner GMRES's host half, with no
        read: (ru, zp, V, hb) for ``split_tail`` and ``gmres.lsq``."""
        ru, rp = r[: self.nu_dofs], r[self.nu_dofs:]
        zp = self._smooth_p(rp)
        if self.up_coupling is not None:
            with span("precond.up"):
                ru = ru - self.up_coupling(zp)
        with span("precond.smooth_u"):
            V, hb = arnoldi(self.ublock_op, ru, self._jacobi_u, self.inner_iters_u,
                            name="precond.gmres")
        return ru, zp, V, hb

    def split_tail(self, r, ru, zp, V, y, j: int) -> torch.Tensor:
        """The rest of the application from the inner solve's first j
        basis vectors and their weights ``y`` (a device vector)."""
        zu = torch.zeros_like(ru)
        if j:
            zu = zu + V[:j].T @ y[:j]
        z = torch.cat([self._post_u(ru, zu), zp])
        if self.saddle_coarse is not None:
            z = self.saddle_coarse(self.outer_op, r, z)
        return z
