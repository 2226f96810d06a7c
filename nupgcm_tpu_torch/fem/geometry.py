"""Affine cell/facet geometry tables (host precompute).

For straight simplices the map reference->physical is affine, so the
Jacobian, its inverse-transpose, and quadrature weights are per-cell
constants.  These tables are computed once in NumPy and copied to the
model's device as tensors; nothing here runs per step.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.core import Mesh
from .reference import tabulate


@dataclass
class CellGeometry:
    """Volume-integration geometry.

    invJT: (nc, tdim, tdim)  -- (dJ/dx)^{-T} in the mesh plane axes
    wq:    (nc, nq)          -- physical quadrature weights w_q |detJ|
    xq:    (nc, nq, 3)       -- physical quadrature points (3D coords)
    """

    tdim: int
    invJT: np.ndarray
    wq: np.ndarray
    xq: np.ndarray


def cell_geometry(mesh: Mesh, degree: int) -> CellGeometry:
    from .quadrature import simplex_rule

    qp, qw = simplex_rule(mesh.tdim, degree)
    J, detJ = mesh.cell_jacobians()
    invJ = np.linalg.inv(J)
    invJT = np.transpose(invJ, (0, 2, 1))
    wq = qw[None, :] * detJ[:, None]
    # physical points via P1 embedding of the full 3D coordinates
    phi1, _ = tabulate(mesh.tdim, 1, qp)  # (nq, tdim+1)
    X3 = mesh.coords[mesh.cells]  # (nc, tdim+1, 3)
    xq = np.einsum("qi,cid->cqd", phi1, X3)
    return CellGeometry(tdim=mesh.tdim, invJT=invJT, wq=wq, xq=xq)


@dataclass
class FacetGeometry:
    """Surface-integration geometry over one facet group.

    facet_dofs entries are built by the caller per space; here we store
    only measure-weighted quadrature weights and physical points.

    wq: (nf, nqf)  -- physical facet quadrature weights
    xq: (nf, nqf, 3)
    """

    fdim: int
    wq: np.ndarray
    xq: np.ndarray


def facet_geometry(mesh: Mesh, facets: np.ndarray, degree: int) -> FacetGeometry:
    from .quadrature import simplex_rule

    fdim = mesh.tdim - 1
    qp, qw = simplex_rule(fdim, degree)
    meas = mesh.facet_measures(facets)  # |J_f| per facet
    wq = qw[None, :] * meas[:, None]
    phi1, _ = tabulate(fdim, 1, qp)
    X3 = mesh.coords[facets]
    xq = np.einsum("qi,cid->cqd", phi1, X3)
    return FacetGeometry(fdim=fdim, wq=wq, xq=xq)


def grad_embedding(mesh_or_tdim) -> np.ndarray:
    """(tdim, 3) matrix E mapping plane gradient components to global
    3D axes; derived from the mesh's plane axes (x-z slices by
    default, y-z for meridional channel sections), identity in 3D."""
    if hasattr(mesh_or_tdim, "plane_axes"):
        axes = mesh_or_tdim.plane_axes
    else:
        axes = [0, 2] if mesh_or_tdim == 2 else [0, 1, 2]
    E = np.zeros((len(axes), 3))
    for i, a in enumerate(axes):
        E[i, a] = 1.0
    return E
