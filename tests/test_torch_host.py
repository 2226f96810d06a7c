"""Host setup of the PyTorch port (mesh generators, spaces, FEData)
against the JAX package's, element for element.

Both packages load the same native/libmeshkit.so (or both fall back to
SciPy's RCM); a split there would renumber every dof, and these tables
would differ.  Everything here is host NumPy, so the comparison is
exact.
"""

import numpy as np
import pytest

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.mesh import native as native_jax
from nupgcm_tpu_torch.mesh import native as native_port

MESHES = {
    "bowl2D(0.2)": lambda g: g.bowl2D(0.2, 0.5),
    "bowl3D(0.35, nz=3)": lambda g: g.bowl3D(0.35, 0.5, nz=3),
    "rect_mesh(6, 6)": lambda g: g.rect_mesh(6, 6, x0=-1, x1=1, z0=-1, z1=0),
}


def _fedata(npg, mesh):
    if mesh.tdim == 2 and "coastline" not in mesh.tagged:
        spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                            u_diri_masks=[(True, True, True)],
                            b_diri_tags=["top"], b_diri_vals=[0.0])
    else:
        spaces = npg.Spaces(
            mesh, u_diri_tags=["bottom", "coastline", "surface"],
            u_diri_vals=[(0, 0, 0)] * 3,
            u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
            b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    return npg.FEData(mesh, spaces)


def test_same_native_library_choice():
    assert (native_jax.load() is None) == (native_port.load() is None)


@pytest.mark.parametrize("name", list(MESHES))
def test_generators_match(name):
    mj, mt = MESHES[name](npj.generators), MESHES[name](npt.generators)
    assert np.array_equal(mj.coords, mt.coords)
    assert np.array_equal(mj.cells, mt.cells)
    assert np.array_equal(mj.edges, mt.edges)
    assert np.array_equal(mj.cell_edges, mt.cell_edges)
    assert sorted(mj.tagged) == sorted(mt.tagged)
    for tag, ents in mj.tagged.items():
        for d, simp in ents.items():
            assert np.array_equal(np.asarray(simp), np.asarray(mt.tagged[tag][d]))


@pytest.mark.parametrize("name", list(MESHES))
def test_fedata_tables_match(name):
    fj = _fedata(npj, MESHES[name](npj.generators))
    ft = _fedata(npt, MESHES[name](npt.generators))
    for k in ("cell_order", "cd_u", "cd_p", "cd_b", "cd_u3", "cell_dofs_inv",
              "h_cells", "embed"):
        assert np.array_equal(getattr(fj, k), getattr(ft, k)), k
    assert (fj.n_inv, fj.n_cells_padded, fj.h_median) == (ft.n_inv, ft.n_cells_padded,
                                                          ft.h_median)
    for k in ("invJT", "wq", "xq"):
        assert np.array_equal(getattr(fj.geom, k), getattr(ft.geom, k)), k
    for k in ("phi", "dphi"):
        for tab in ("tab_u", "tab_p", "tab_b"):
            assert np.array_equal(getattr(getattr(fj, tab), k),
                                  getattr(getattr(ft, tab), k)), (tab, k)
    sj, st = fj.spaces, ft.spaces
    for bc in ("u_bc", "b_bc"):
        assert np.array_equal(getattr(sj, bc).mask, getattr(st, bc).mask), bc
        assert np.array_equal(getattr(sj, bc).values, getattr(st, bc).values), bc
    for sp in ("u_space", "p_space", "b_space"):
        a, b = getattr(sj, sp), getattr(st, sp)
        assert np.array_equal(a.dof_coords, b.dof_coords), sp
        assert np.array_equal(a._perm, b._perm), sp
    for k in ("facets", "u_facet_dofs", "b_facet_dofs", "phi_u", "phi_b"):
        assert np.array_equal(getattr(fj.surface, k), getattr(ft.surface, k)), k
    assert np.array_equal(fj.surface.geom.wq, ft.surface.geom.wq)
    for plan in ("vec_plan_b", "vec_plan_p", "vec_plan_u_nodes", "vec_plan_b_surf",
                 "vec_plan_u_surf"):
        pj, pt = getattr(fj, plan), getattr(ft, plan)
        assert pj.ndof == pt.ndof
        # the JAX plan stores the entries sorted by dof; the port keeps
        # them in element order
        assert np.array_equal(pt.dofs[pj.gather_perm], pj.dof_sorted), plan
