"""VTU writer with quadratic (P2) cells, parity with the reference's
``save_vtk`` (reference src/IO.jl:25-59, ``writevtk(..., order=2)``)
so the pyvista-based postprocessing workflow keeps working.

Self-contained XML UnstructuredGrid writer (no external VTK dep):
points are the P2 nodes (vertices + edge midpoints), cells are
VTK_QUADRATIC_TRIANGLE (22) / VTK_QUADRATIC_TETRA (24).
"""

from __future__ import annotations

import base64
import struct

import numpy as np
import torch

from ..utils.misc import to_numpy

# map VTK quadratic-cell edge order to our lexicographic local edges
# (nupgcm_tpu_torch.fem.reference.LOCAL_EDGES)
_VTK_EDGE_ORDER = {
    2: [0, 2, 1],            # tri: VTK edges (0,1),(1,2),(2,0)
    3: [0, 3, 1, 2, 4, 5],   # tet: VTK edges (0,1),(1,2),(2,0),(0,3),(1,3),(2,3)
}
_VTK_CELL_TYPE = {2: 22, 3: 24}


def _p2_points_and_cells(mesh):
    """P2 point array (vertex+edge-midpoint coords, *original* node
    numbering) and quadratic-cell connectivity into it."""
    mids = 0.5 * (mesh.coords[mesh.edges[:, 0]] + mesh.coords[mesh.edges[:, 1]])
    points = np.vstack([mesh.coords, mids])
    edge_cols = mesh.cell_edges[:, _VTK_EDGE_ORDER[mesh.tdim]]
    cells = np.hstack([mesh.cells, mesh.n_vertices + edge_cols])
    return points, cells


def _space_to_p2(space, vals):
    """Map a field on a ScalarSpace to the mesh-ordered P2 point set.

    P2 spaces: undo the RCM renumbering.  P1 spaces: vertex values +
    edge-midpoint averages (exact for P1).
    """
    mesh = space.mesh
    vals = space.resolve_periodic(np.asarray(vals))
    n_pts = mesh.n_vertices + mesh.n_edges
    if space.order == 2:
        if hasattr(space, "_perm"):
            # space dof k corresponds to original id space._perm[k]
            out = np.empty_like(vals)
            out[space._perm] = vals
            return out
        return vals
    # P1: vertex dofs (maybe renumbered) then edge averages
    if hasattr(space, "_perm"):
        vert = np.empty(mesh.n_vertices, dtype=vals.dtype)
        vert[space._perm] = vals
    else:
        vert = vals
    mids = 0.5 * (vert[mesh.edges[:, 0]] + vert[mesh.edges[:, 1]])
    return np.concatenate([vert, mids])


def _da(name, data, ncomp=1):
    flat = np.asarray(data, dtype=np.float64).reshape(-1)
    txt = " ".join(f"{v:.10g}" for v in flat)
    return (
        f'<DataArray type="Float64" Name="{name}" '
        f'NumberOfComponents="{ncomp}" format="ascii">{txt}</DataArray>'
    )


def write_vtu(path: str, mesh, point_data: dict):
    """Write a quadratic-cell VTU. ``point_data``: name -> array over
    the P2 point set (n_pts,) or (n_pts, 3)."""
    points, cells = _p2_points_and_cells(mesh)
    n_pts, n_cells = len(points), len(cells)
    nloc = cells.shape[1]
    conn = " ".join(map(str, cells.reshape(-1)))
    offs = " ".join(map(str, (np.arange(1, n_cells + 1) * nloc)))
    types = " ".join([str(_VTK_CELL_TYPE[mesh.tdim])] * n_cells)

    pd = []
    for name, arr in point_data.items():
        arr = np.asarray(arr)
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        pd.append(_da(name, arr, ncomp))

    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">
  <UnstructuredGrid>
    <Piece NumberOfPoints="{n_pts}" NumberOfCells="{n_cells}">
      <Points>
        {_da("Points", points, 3)}
      </Points>
      <Cells>
        <DataArray type="Int64" Name="connectivity" format="ascii">{conn}</DataArray>
        <DataArray type="Int64" Name="offsets" format="ascii">{offs}</DataArray>
        <DataArray type="UInt8" Name="types" format="ascii">{types}</DataArray>
      </Cells>
      <PointData>
        {chr(10).join(pd)}
      </PointData>
    </Piece>
  </UnstructuredGrid>
</VTKFile>
"""
    with open(path, "w") as f:
        f.write(xml)


def save_vtk(model, state, path: str):
    """Reference-parity VTU dump: u, p, full b = N^2 z + b', alpha*b_z,
    effective nu and kappa_v, t (reference src/IO.jl:25-59)."""
    fe = model.fe
    mesh = fe.mesh
    sp = fe.spaces
    pr, fr = model.params, model.forcings

    u = to_numpy(state.u)  # (ndof_u, 3) in u-space numbering
    u_p2 = np.stack([_space_to_p2(sp.u_space, u[:, c]) for c in range(3)], axis=1)
    p_p2 = _space_to_p2(sp.p_space, to_numpy(state.p))
    b_p2 = _space_to_p2(sp.b_space, to_numpy(state.b))

    points, _ = _p2_points_and_cells(mesh)
    z = points[:, 2]
    b_full = pr.N2 * z + b_p2

    # nodal alpha*b_z via lumped-mass L2 projection of the FE gradient
    abz = pr.alpha * pr.N2 + pr.alpha * _project_dz(model, state)
    abz_p2 = _space_to_p2(sp.b_space, abz)

    # the closures' formulas take tensors (models/config.py)
    abz_t = torch.as_tensor(abz_p2)
    if fr.eddy_param.is_on:
        nu_eff = to_numpy(fr.eddy_param.nu(
            torch.as_tensor(_coef(fr.eddy_param.f, points)), abz_t))
    else:
        nu_eff = _coef(fr.nu, points)
    kv = _coef(fr.kappa_v, points)
    if fr.conv_param.is_on:
        kv = to_numpy(fr.conv_param.kappa_v(torch.as_tensor(kv), abz_t))

    write_vtu(path, mesh, {
        "u": u_p2,
        "p": p_p2,
        "b": b_full,
        "alpha*b_z": abz_p2,
        "nu": nu_eff,
        "kappa_v": kv,
        "t": np.full(len(points), float(state.t)),
    })


def _coef(f, points):
    from ..fem.spaces import _eval_coeff

    if callable(f):
        return np.broadcast_to(
            np.asarray(_eval_coeff(f, points), dtype=np.float64), (len(points),)
        ).copy()
    return np.full(len(points), float(f))


def _project_dz(model, state):
    """Lumped-mass projection of db/dz onto the buoyancy space (on the
    model's device)."""
    c = model.const
    plan = model.fe.vec_plan_b
    be = state.b[c["cd_b"]]
    dz_q = torch.einsum("cqi,ci->cq", c["Gb3"][..., 2], be)
    num = plan.assemble(torch.einsum("cq,qi,cq->ci", c["wq"], c["phi_b"], dz_q))
    den = plan.assemble(torch.einsum("cq,qi->ci", c["wq"], c["phi_b"]))
    return to_numpy(num / den)
