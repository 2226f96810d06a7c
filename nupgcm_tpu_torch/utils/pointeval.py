"""FE field evaluation at arbitrary physical points (host-side).

Parity with the reference's ``nan_eval`` (reference
src/plotting.jl:9-31): evaluate an FE function at scattered points,
returning NaN outside the domain.  Used by plotting and the
postprocessing diagnostics (slices, streamfunctions) without any
pyvista dependency.

Cell location: candidate cells from a centroid KD-tree, then exact
barycentric containment test on the affine simplex.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from ..fem.reference import tabulate
from .misc import to_numpy


class FieldEvaluator:
    def __init__(self, mesh):
        self.mesh = mesh
        X = mesh.cell_coords()  # (nc, nvert, tdim) plane coords
        self.X0 = X[:, 0, :]
        J = np.transpose(X[:, 1:, :] - X[:, :1, :], (0, 2, 1))
        self.invJ = np.linalg.inv(J)
        cent = X.mean(axis=1)
        self.tree = cKDTree(cent)
        self.h = mesh.h_cells()
        self.k = min(32, mesh.n_cells)

    def locate(self, pts_plane: np.ndarray, tol: float = 1e-10):
        """Find containing cell + reference coords for (n, tdim) points.

        Returns (cell_ids (n,), ref_coords (n, tdim)); cell_id = -1
        where the point is outside the domain.
        """
        n = len(pts_plane)
        _, cand = self.tree.query(pts_plane, k=self.k)
        cand = np.atleast_2d(cand)
        cells = np.full(n, -1, dtype=np.int64)
        refs = np.zeros((n, self.mesh.tdim))
        for j in range(cand.shape[1]):
            todo = cells == -1
            if not todo.any():
                break
            c = cand[todo, j]
            xi = np.einsum(
                "nij,nj->ni", self.invJ[c], pts_plane[todo] - self.X0[c]
            )
            lam0 = 1.0 - xi.sum(axis=1)
            inside = (xi.min(axis=1) >= -tol) & (lam0 >= -tol)
            idx = np.where(todo)[0][inside]
            cells[idx] = c[inside]
            refs[idx] = xi[inside]
        return cells, refs

    def eval(self, space, dof_vals: np.ndarray, pts3: np.ndarray):
        """Evaluate a field (dof vector on ``space``) at (n, 3) physical
        points; NaN outside.  2D meshes use the (x, z) columns."""
        pts3 = np.atleast_2d(np.asarray(pts3, dtype=np.float64))
        pts_plane = pts3[:, self.mesh.plane_axes]
        cells, refs = self.locate(pts_plane)
        vals = np.asarray(to_numpy(dof_vals), dtype=np.float64)
        out_shape = (len(pts3),) + vals.shape[1:]
        out = np.full(out_shape, np.nan)
        ok = cells >= 0
        if not ok.any():
            return out
        cd = self.mesh.cells if space.order == 1 else None
        if space.order == 1:
            cell_dofs = space.cell_dofs[cells[ok]]
        else:
            cell_dofs = space.cell_dofs[cells[ok]]
        phi, _ = tabulate(self.mesh.tdim, space.order, refs[ok])
        # phi rows correspond 1:1 to the ok points
        gathered = vals[cell_dofs]  # (m, nloc, ...)
        out[ok] = np.einsum("mi,mi...->m...", phi, gathered)
        return out


    def prepare(self, space, pts3: np.ndarray) -> "PointEval":
        """Precompute the point-location + basis tabulation for a fixed
        point set: repeated evaluations (per-save plot bundles) become
        a single gather + einsum (reference plot_slice's evaluate
        cache, src/plotting.jl:84-92)."""
        pts3 = np.atleast_2d(np.asarray(pts3, dtype=np.float64))
        cells, refs = self.locate(pts3[:, self.mesh.plane_axes])
        ok = cells >= 0
        phi, _ = tabulate(self.mesh.tdim, space.order, refs[ok])
        return PointEval(space=space, n_pts=len(pts3), ok=ok,
                         cell_dofs=space.cell_dofs[cells[ok]], phi=phi)


class PointEval:
    """Cached evaluation plan for one (space, point-set) pair."""

    def __init__(self, space, n_pts, ok, cell_dofs, phi):
        self.space = space
        self.n_pts = n_pts
        self.ok = ok
        self.cell_dofs = cell_dofs
        self.phi = phi

    def __call__(self, dof_vals: np.ndarray) -> np.ndarray:
        vals = np.asarray(to_numpy(dof_vals), dtype=np.float64)
        out = np.full((self.n_pts,) + vals.shape[1:], np.nan)
        if self.ok.any():
            out[self.ok] = np.einsum("mi,mi...->m...", self.phi,
                                     vals[self.cell_dofs])
        return out


def nan_eval(evaluator: FieldEvaluator, space, dof_vals, pts3):
    """Reference-parity convenience wrapper."""
    return evaluator.eval(space, dof_vals, pts3)


def find_H(evaluator: FieldEvaluator, x: float, y: float = 0.0,
           tol: float = 1e-8, z_top: float = 0.0, z_bot: float = -1.0):
    """Water-column depth at (x, y) by bisection on domain membership
    (reference find_H, src/plotting.jl:38-52): returns H such that
    (x, y, -H) is the deepest in-domain point; NaN if even the surface
    point is outside."""
    axes = evaluator.mesh.plane_axes

    def inside(z):
        p = np.array([[x, y, z]])[:, axes]
        return evaluator.locate(p)[0][0] >= 0

    if not inside(z_top):
        return np.nan
    z_in, z_out = z_top, z_bot
    if inside(z_bot):
        return -z_bot
    while abs(z_in - z_out) > tol:
        z = 0.5 * (z_in + z_out)
        if inside(z):
            z_in = z
        else:
            z_out = z
    return -z_in
