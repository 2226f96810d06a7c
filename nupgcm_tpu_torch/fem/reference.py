"""Lagrange reference elements on simplices (host-side tabulation).

P1 and P2 H1-conforming simplex elements, mirroring the spaces used by
the reference model (reference src/spaces.jl:37-39: P2 vector velocity,
P1 zero-mean pressure, P2 buoyancy).  Tabulation returns plain NumPy
arrays of basis values and reference-coordinate gradients at arbitrary
points; everything downstream (geometry mapping, assembly) consumes
these tables as constants.

Local node ordering convention (used consistently by mesh + spaces):
  * vertices 0..tdim in cell order,
  * then one node per local edge, edges enumerated in lexicographic
    vertex-pair order:
      tdim=2: (0,1), (0,2), (1,2)
      tdim=3: (0,1), (0,2), (0,3), (1,2), (1,3), (2,3)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LOCAL_EDGES = {
    1: [(0, 1)],
    2: [(0, 1), (0, 2), (1, 2)],
    3: [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)],
}


def n_local_dofs(tdim: int, order: int) -> int:
    nvert = tdim + 1
    if order == 1:
        return nvert
    if order == 2:
        return nvert + len(LOCAL_EDGES[tdim])
    raise ValueError(f"unsupported order {order}")


def local_node_coords(tdim: int, order: int) -> np.ndarray:
    """Reference coordinates of the local nodes, shape (nloc, tdim)."""
    verts = np.vstack([np.zeros(tdim), np.eye(tdim)])  # (tdim+1, tdim)
    if order == 1:
        return verts
    mids = np.array([(verts[i] + verts[j]) / 2.0 for i, j in LOCAL_EDGES[tdim]])
    return np.vstack([verts, mids])


def _barycentric(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Barycentric coords and their (constant) gradients.

    Returns lam (npts, tdim+1) and dlam (tdim+1, tdim).
    """
    pts = np.asarray(points, dtype=np.float64)
    npts, tdim = pts.shape
    lam = np.empty((npts, tdim + 1))
    lam[:, 0] = 1.0 - pts.sum(axis=1)
    lam[:, 1:] = pts
    dlam = np.empty((tdim + 1, tdim))
    dlam[0] = -1.0
    dlam[1:] = np.eye(tdim)
    return lam, dlam


def tabulate(tdim: int, order: int, points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Basis values and reference gradients at given points.

    Returns (phi, dphi) with shapes (npts, nloc) and (npts, nloc, tdim).
    """
    lam, dlam = _barycentric(points)
    npts = lam.shape[0]
    nvert = tdim + 1
    if order == 1:
        phi = lam.copy()
        dphi = np.broadcast_to(dlam[None, :, :], (npts, nvert, tdim)).copy()
        return phi, dphi
    if order != 2:
        raise ValueError(f"unsupported order {order}")
    edges = LOCAL_EDGES[tdim]
    nloc = nvert + len(edges)
    phi = np.empty((npts, nloc))
    dphi = np.empty((npts, nloc, tdim))
    # vertex functions: lam_i (2 lam_i - 1)
    for i in range(nvert):
        phi[:, i] = lam[:, i] * (2.0 * lam[:, i] - 1.0)
        dphi[:, i, :] = (4.0 * lam[:, i] - 1.0)[:, None] * dlam[i][None, :]
    # edge functions: 4 lam_i lam_j
    for k, (i, j) in enumerate(edges):
        phi[:, nvert + k] = 4.0 * lam[:, i] * lam[:, j]
        dphi[:, nvert + k, :] = 4.0 * (
            lam[:, i][:, None] * dlam[j][None, :] + lam[:, j][:, None] * dlam[i][None, :]
        )
    return phi, dphi


@dataclass(frozen=True)
class ElementTables:
    """Tabulated reference element data at a quadrature rule.

    Attributes:
      tdim: topological dimension of the simplex
      order: polynomial order (1 or 2)
      qpoints: (nq, tdim) quadrature points on the reference simplex
      qweights: (nq,) quadrature weights
      phi: (nq, nloc) basis values
      dphi: (nq, nloc, tdim) basis gradients in reference coordinates
    """

    tdim: int
    order: int
    qpoints: np.ndarray
    qweights: np.ndarray
    phi: np.ndarray
    dphi: np.ndarray


def element_tables(tdim: int, order: int, degree: int) -> ElementTables:
    from .quadrature import simplex_rule

    qp, qw = simplex_rule(tdim, degree)
    phi, dphi = tabulate(tdim, order, qp)
    return ElementTables(tdim=tdim, order=order, qpoints=qp, qweights=qw, phi=phi, dphi=dphi)
