"""Gridap dof-numbering reconstruction: reference-checkpoint interop.

PyTorch counterpart of ``nupgcm_tpu.io.gridap``.  The reference's
golden states store free-dof vectors in Gridap's global dof numbering
(reference src/IO.jl:1-10 saves the ``u/p/b`` free values of the
Gridap FE spaces).  To validate against them this module rebuilds that
numbering from the same ``.msh`` file and maps it onto this package's
canonical (mesh-order) dof numbering.

Gridap's conforming-Lagrangian numbering (Gridap
FESpaces/ConformingFESpaces.jl), as the JAX package reconstructs it:

  * model faces are ordered by dimension: vertices (gmsh node-tag
    order), then edges;
  * edges are numbered first-touch over (cell, local edge) with the
    polytope local edge order TRI [[0,1],[0,2],[1,2]] / TET
    [[0,1],[0,2],[1,2],[0,3],[1,3],[2,3]].  The reference's 2D golden
    files use the RAW file connectivity, its 3D ones each cell's vertex
    list SORTED ascending (``sort_cells``; the default follows the
    dimension);
  * each face owns its interior Lagrange dofs (P2: one per vertex and
    one per edge); vector spaces own ``ncomp`` dofs a node,
    component-consecutive;
  * free dofs are numbered in face order, skipping Dirichlet (node,
    component) pairs;
  * the ``:zeromean`` pressure space fixes the LAST free dof of the
    unconstrained space (Gridap ZeroMeanFESpace), so its free dofs are
    vertices 0..nv-2.

The multifield inversion vector is [u free; p free] (reference
src/dofs.jl:54-60).  h5py (for the JLD2 files) is imported where a
file is read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Gridap polytope local edges, 0-based (Gridap get_faces(TRI/TET, 1, 0))
GRIDAP_LOCAL_EDGES = {
    2: ((0, 1), (0, 2), (1, 2)),
    3: ((0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)),
}


def first_touch_edges(cells: np.ndarray, local_edges, sort_cells: bool = False) -> np.ndarray:
    """Edge list (vmin, vmax) in Gridap's first-touch global order:
    cells in file order, local edges in polytope order, each unseen
    vertex pair numbered when first met.  ``sort_cells`` sorts each
    cell's vertex list first."""
    led = np.asarray(local_edges)
    if sort_cells:
        cells = np.sort(cells, axis=1)
    pairs = np.sort(cells[:, led].reshape(-1, 2), axis=1)
    nv = int(cells.max()) + 1
    keys = pairs[:, 0] * np.int64(nv) + pairs[:, 1]
    _, first_idx = np.unique(keys, return_index=True)
    return pairs[np.sort(first_idx)]


@dataclass
class GridapMaps:
    """Gridap free-dof index -> this package's canonical dof.

    ``u_free``: canonical flat velocity dof (3*node + comp);
    ``p_free``: canonical vertex id; ``b_free``: canonical P2 node id;
    ``node_order``: Gridap P2 node k -> canonical node.  Canonical =
    mesh order (vertices, then sorted-unique edges), i.e. pre-RCM."""

    u_free: np.ndarray
    p_free: np.ndarray
    b_free: np.ndarray
    node_order: np.ndarray


def gridap_maps(msh_path: str, spaces, sort_cells=None) -> GridapMaps:
    """Gridap's free-dof numbering of the Taylor-Hood + P2-buoyancy
    spaces on ``msh_path``, in this package's canonical dof ids.
    ``spaces`` must be built on the Mesh read from the same file; its
    Dirichlet masks say which (node, comp) are constrained."""
    from ..mesh.core import find_edges
    from ..mesh.gmsh_reader import read_msh_arrays

    _, raw_cells, _, tdim = read_msh_arrays(msh_path)
    mesh = spaces.mesh
    nv = mesh.n_vertices
    if sort_cells is None:
        sort_cells = tdim == 3
    g_edges = first_touch_edges(raw_cells, GRIDAP_LOCAL_EDGES[tdim], sort_cells=sort_cells)
    my_edge = find_edges(mesh._edge_keys, mesh._edge_order, g_edges, nv)
    node_order = np.concatenate([np.arange(nv, dtype=np.int64), nv + my_edge])

    # canonical-order Dirichlet masks
    u_mask = spaces.u_space.to_original_order(spaces.u_bc.mask)  # (ndof, 3)
    b_mask = spaces.b_space.to_original_order(spaces.b_bc.mask)  # (ndof,)
    flat = 3 * node_order[:, None] + np.arange(3, dtype=np.int64)[None, :]
    u_free = flat[~u_mask[node_order]]  # node-major, component-consecutive
    b_free = node_order[~b_mask[node_order]]
    p_free = np.arange(nv - 1, dtype=np.int64)  # zeromean fixes the last dof
    return GridapMaps(u_free=u_free, p_free=p_free, b_free=b_free, node_order=node_order)


def state_from_reference(model, path: str, maps: GridapMaps):
    """A ``State`` on the model's device from a reference-written JLD2
    checkpoint (Gridap free-dof order).  Dirichlet dofs take the
    model's boundary values (``const["xdiri_inv"]``'s velocity part and
    ``const["bdiri"]``); the zero-mean pressure is read with its fixed
    dof at 0, then volume-mean projected with ``ops["p_volw"]``, as
    the step projects it."""
    from ..models.model import State
    from .jld2 import _state, read_jld2

    d = read_jld2(path)
    sp = model.fe.spaces
    host = lambda t: t.detach().double().cpu().numpy()

    udiri = host(model.const["xdiri_inv"][:sp.n_u]).reshape(-1, 3)
    u_can = sp.u_space.to_original_order(udiri).reshape(-1)
    u_can[maps.u_free] = np.asarray(d["u"], np.float64)
    b_can = sp.b_space.to_original_order(host(model.const["bdiri"]))
    b_can[maps.b_free] = np.asarray(d["b"], np.float64)
    p_can = np.zeros(sp.n_p)
    p_can[maps.p_free] = np.asarray(d["p"], np.float64)

    u = sp.u_space.from_original_order(u_can.reshape(-1, 3))
    b = sp.b_space.from_original_order(b_can)
    p = sp.p_space.from_original_order(p_can)
    pw = host(model.ops["p_volw"])
    p = p - (pw @ p) / pw.sum()
    return _state(model, State, u, p, b, float(np.asarray(d.get("t", 0.0))))


def read_jld2_csc(path: str, name: str):
    """Read a Julia SparseMatrixCSC stored by JLD2 (a compound dataset
    with object references for colptr/rowval/nzval) as scipy CSC."""
    import h5py
    import scipy.sparse as sps

    with h5py.File(path, "r") as f:
        rec = f[name][()]
        m, n = int(rec["m"]), int(rec["n"])
        colptr = np.asarray(f[rec["colptr"]][()], np.int64) - 1
        rowval = np.asarray(f[rec["rowval"]][()], np.int64) - 1
        nzval = np.asarray(f[rec["nzval"]][()], np.float64)
    return sps.csc_matrix((nzval, rowval, colptr), shape=(m, n))


def assemble_inversion_csr(model):
    """The full (unconstrained) inversion operator as scipy CSR over
    the canonical combined dof vector [3*node+comp; 3*ndof_u + vertex],
    for golden-matrix regression against the reference's
    ``A_inversion`` (reference test/bowl_mixing_tests.jl:51-64).
    Element matrices in float64 on the model's device, assembled there
    with ``FEData.plan_inv``."""
    import scipy.sparse as sps

    from ..fem import assembly as asm

    fe, c = model.fe, model.const
    f64 = lambda k: c[k].double()
    elem = asm.elem_inversion(
        f64("wq"), f64("nu_q"), f64("f_q"), f64("phi_u"),
        asm.physical_grads(f64("invJT"), f64("dphi_u"), f64("embed")),
        f64("phi_p"), float(model.params.a2e2), model.variable_nu)
    plan = fe.plan_inv
    vals = plan.assemble(elem).cpu().numpy()
    A_cur = sps.csr_matrix((vals, (plan.rows, plan.cols)), shape=(fe.n_inv, fe.n_inv))
    # current (RCM) -> canonical permutation of the combined vector
    us, ps = fe.spaces.u_space, fe.spaces.p_space
    pu = us._perm if hasattr(us, "_perm") else np.arange(us.ndof)
    pp = ps._perm if hasattr(ps, "_perm") else np.arange(ps.ndof)
    inv_u = np.empty(us.ndof, np.int64)
    inv_u[pu] = np.arange(us.ndof)
    inv_p = np.empty(ps.ndof, np.int64)
    inv_p[pp] = np.arange(ps.ndof)
    cur_of_canon = np.empty(fe.n_inv, np.int64)
    cur_of_canon[:3 * us.ndof] = (3 * inv_u[:, None] + np.arange(3)).reshape(-1)
    cur_of_canon[3 * us.ndof:] = 3 * us.ndof + inv_p
    return A_cur[cur_of_canon][:, cur_of_canon].tocsr()
