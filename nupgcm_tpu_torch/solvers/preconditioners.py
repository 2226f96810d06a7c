"""Preconditioners for the PG inversion solve.

Counterpart of ``nupgcm_tpu.solvers.preconditioners``: the block Stokes
preconditioner with fixed-iteration Chebyshev smoothing of the velocity
block and the pressure mass matrix, the P1-P1 saddle-coarse correction
and its second (aggregate) level, all wrapped in FGMRES by the model.
The reference's own strategy (src/inversion.jl:42-59,
src/preconditioners.jl) needs tens of thousands of
1/h^dim-preconditioned iterations (BASELINE.md); this needs O(10).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .cg import cg
from .gmres import gmres


def chebyshev(op, dinv: torch.Tensor, r: torch.Tensor, k: int,
              lmin, lmax) -> torch.Tensor:
    """k-step Chebyshev approximation of (D^-1 A)^-1 D^-1 r.

    The textbook SPD Chebyshev smoother (Saad, Iterative Methods,
    Alg. 12.1) on the Jacobi-scaled operator with eigenvalue bounds
    [lmin, lmax].  No dot products: every iteration is one matvec and
    two vector updates, with no device read.
    """
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    d = (1.0 / theta) * (dinv * r)
    z = d
    for _ in range(k - 1):
        r = r - op(d)
        rho1 = 1.0 / (2.0 * sigma1 - rho)
        d = rho1 * rho * d + (2.0 * rho1 / delta) * (dinv * r)
        z = z + d
        rho = rho1
    return z


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
        rc = r - A(z)
        # (na, 3).reshape(-1) lays dofs out as 3*aggregate + component,
        # matching the Galerkin matrix built in
        # models/model.py::_assemble_saddle_coarse_l2
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
    the full nonsymmetric velocity block), optionally followed by the
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
    saddle_coarse: object = None  # optional SaddleCoarseCorrection
    outer_op: callable = None  # full masked saddle operator (for
    #                            residuals of the saddle coarse step)

    def _solve_p(self, rp: torch.Tensor) -> torch.Tensor:
        if self.method == "cg":
            zp, _ = cg(self.mp_op, rp, torch.zeros_like(rp),
                       M_diag_inv=self.mp_diag_inv,
                       atol=0.0, rtol=1e-8, itmax=self.inner_iters_p)
            return zp
        # pressure mass is well conditioned under Jacobi: tight ratio
        return chebyshev(self.mp_op, self.mp_diag_inv, rp,
                         self.inner_iters_p, self.lmax_p / 4.0, self.lmax_p)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
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
            zp = self._solve_p(rp)
            return torch.cat([self._solve_u(ru - self.up_coupling(zp)), zp])
        return torch.cat([self._solve_u(ru), self._solve_p(rp)])

    def _solve_u(self, ru: torch.Tensor) -> torch.Tensor:
        if self.method == "inner_gmres":
            # rotation-dominated regime: the skew Coriolis term dominates
            # the velocity block, so smooth the FULL (nonsymmetric) block
            zu, _ = gmres(self.ublock_op, ru, torch.zeros_like(ru),
                          M=lambda v: self.visc_diag_inv * v,
                          m=self.inner_iters_u, atol=0.0, rtol=1e-8,
                          itmax=self.inner_iters_u)
            return zu
        if self.method == "chebyshev":
            return chebyshev(self.visc_op, self.visc_diag_inv, ru,
                             self.inner_iters_u, self.lmax_u / self.cond_ratio,
                             self.lmax_u)
        zu, _ = cg(self.visc_op, ru, torch.zeros_like(ru),
                   M_diag_inv=self.visc_diag_inv,
                   atol=0.0, rtol=1e-8, itmax=self.inner_iters_u)
        return zu
