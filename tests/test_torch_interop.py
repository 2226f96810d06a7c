"""Reference interop and assembled operators of the PyTorch port against
the JAX package: ``fem.assembly.MatrixPlan`` and ``FEData``'s plans,
``ops.sparse`` (COO and ELL), ``io.jld2`` and ``io.gridap``, and the
north-star tool's golden prefix check.

The same meshes, coefficient fields (numpy.random.default_rng) and
states go through both packages.  Bars: plans and Gridap maps equal
exactly; assembled operators and SpMV 1e-12 of the largest entry in
f64; JLD2 files round-trip bitwise in both directions (h5py).  The
port's counterparts of tests/test_assembly.py's integral identities
run on the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.fem import assembly as aj
from nupgcm_tpu.ops import sparse as sj
from nupgcm_tpu_torch.fem import assembly as at
from nupgcm_tpu_torch.ops import sparse as st
from torch_parity import assert_same_rcm_branch

PLANS = ("plan_inv", "plan_B", "plan_b", "plan_visc", "plan_Mp")
REL = 1e-12


def _spaces(pkg, mesh, b_surface=0.0):
    """The reference suites' Dirichlet set-up (surface b = ``b_surface``)."""
    return pkg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[b_surface, b_surface])


def _mesh(pkg, dim):
    return (pkg.generators.bowl2D(0.3, 0.5) if dim == 2
            else pkg.generators.bowl3D(0.35, 0.5, nz=3))


@pytest.fixture(scope="module", params=[2, 3])
def fe_pair(request):
    assert_same_rcm_branch()
    dim = request.param
    fj = npj.FEData(_mesh(npj, dim), _spaces(npj, _mesh(npj, dim)))
    mt = _mesh(npt, dim)
    ft = npt.FEData(mt, _spaces(npt, mt))
    return dim, fj, ft


@pytest.mark.parametrize("plan", PLANS)
def test_matrix_plans_match_jax(fe_pair, plan):
    _, fj, ft = fe_pair
    pj, pt = getattr(fj, plan), getattr(ft, plan)
    assert (pt.n_rows, pt.n_cols, pt.nnz) == (pj.n_rows, pj.n_cols, pj.nnz)
    for k in ("rows", "cols", "gather_perm", "slot_sorted"):
        a, b = getattr(pj, k), getattr(pt, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert getattr(ft, plan) is pt  # built once
    # the element-order slots are the sorted ones put back in order
    assert np.array_equal(pt.slot[pt.gather_perm], pt.slot_sorted)


def _inversion_elems(fj, rng):
    nc, nq = fj.geom.wq.shape
    gu = np.asarray(aj.physical_grads(fj.geom.invJT, fj.tab_u.dphi, fj.embed))
    return (fj.geom.wq, rng.uniform(0.5, 2.0, (nc, nq)), rng.uniform(-1.0, 1.5, (nc, nq)),
            fj.tab_u.phi, gu, fj.tab_p.phi)


def _both(fn_j, fn_t, args, *rest):
    yj = fn_j(*[jnp.asarray(a) for a in args], *rest)
    yt = fn_t(*[torch.from_numpy(np.array(a)) for a in args], *rest)
    return np.asarray(yj), yt


def _assembled(fe_pair, which):
    """(JAX COOMatrix, port COOMatrix) of the inversion operator (with
    the symmetric-gradient term) or the P2 buoyancy mass matrix."""
    _, fj, ft = fe_pair
    rng = np.random.default_rng(0)
    if which == "inv":
        ej, et = _both(aj.elem_inversion, at.elem_inversion, _inversion_elems(fj, rng),
                       0.25, True)
        plan_j, plan_t = fj.plan_inv, ft.plan_inv
    else:
        ej, et = _both(aj.elem_mass, at.elem_mass, (fj.geom.wq, fj.tab_b.phi, fj.tab_b.phi))
        plan_j, plan_t = fj.plan_b, ft.plan_b
    assert np.abs(et.numpy() - ej).max() <= REL * np.abs(ej).max()
    Aj = sj.coo_from_plan(plan_j, plan_j.assemble(jnp.asarray(ej)))
    At = st.coo_from_plan(plan_t, plan_t.assemble(et))
    return Aj, At, plan_j, plan_t


@pytest.mark.parametrize("which", ["inv", "b"])
def test_coo_and_ell_match_jax(fe_pair, which):
    Aj, At, plan_j, plan_t = _assembled(fe_pair, which)
    vals_j = np.asarray(Aj.vals)
    scale = np.abs(vals_j).max()
    assert np.abs(At.vals.numpy() - vals_j).max() <= REL * scale
    x = np.random.default_rng(1).standard_normal(At.shape[1])
    yj = np.asarray(Aj.matvec(jnp.asarray(x)))
    y = At.matvec(torch.from_numpy(x)).numpy()
    assert np.abs(y - yj).max() <= REL * np.abs(yj).max()
    dj = np.asarray(Aj.diagonal())
    assert np.abs(At.diagonal().numpy() - dj).max() <= REL * np.abs(dj).max()
    Sj, S = Aj.to_scipy(), At.to_scipy()
    assert S.shape == Sj.shape and abs(S - Sj).max() <= REL * scale
    assert np.allclose(S @ x, y, rtol=0, atol=REL * np.abs(yj).max())
    assert At.with_vals(2 * At.vals).vals.data_ptr() != At.vals.data_ptr()
    # ELL: the JAX layout filled with the JAX values, the port's from its plan
    ell_cols, slot_map, w = sj.ell_from_coo(plan_j.rows, plan_j.cols, n_rows=plan_j.n_rows)
    ev = np.zeros(plan_j.n_rows * w)
    ev[slot_map] = vals_j
    Ej = sj.ELLMatrix(cols=jnp.asarray(ell_cols), vals=jnp.asarray(ev.reshape(-1, w)),
                      shape=Aj.shape)
    cols_t, slot_t, w_t = st.ell_from_coo(plan_t.rows, plan_t.cols, plan_t.n_rows)
    assert w_t == w and np.array_equal(cols_t, ell_cols) and np.array_equal(slot_t, slot_map)
    ev_t = At.vals.new_zeros(plan_t.n_rows * w_t)
    ev_t[torch.from_numpy(slot_t).long()] = At.vals
    Et = st.ELLMatrix(cols=torch.from_numpy(cols_t).long(), vals=ev_t.reshape(-1, w_t),
                      shape=At.shape)
    ye = np.asarray(Ej.matvec(jnp.asarray(x)))
    assert np.abs(ye - yj).max() <= REL * np.abs(yj).max()
    assert np.abs(Et.matvec(torch.from_numpy(x)).numpy() - ye).max() <= REL * np.abs(ye).max()
    assert np.abs(Et.diagonal().numpy() - dj).max() <= REL * np.abs(dj).max()


# ----------------------------------------------------------------------
# the port's counterparts of tests/test_assembly.py:35, :115, :149
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[2, 3])
def fe_port(request):
    g = npt.generators
    mesh = (g.rect_mesh(4, 3, x0=0, x1=2, z0=-1, z1=0) if request.param == 2
            else g.box_mesh(3, 2, 2, lo=(0, 0, -1), hi=(2, 1, 0)))
    return npt.FEData(mesh, npt.Spaces(mesh, b_diri_tags=[], b_diri_vals=[]))


def _T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_mass_matrix_integrals(fe_port):
    fe = fe_port
    phi = _T(fe.tab_b.phi)
    M = st.coo_from_plan(fe.plan_b, fe.plan_b.assemble(at.elem_mass(_T(fe.geom.wq), phi, phi)))
    ones = torch.ones(fe.spaces.n_b, dtype=torch.float64)
    assert abs(float(ones @ M.matvec(ones)) - 2.0) < 1e-12  # |Omega| = 2
    f = _T(fe.spaces.b_space.dof_coords[:, 0] ** 2)  # integral of x^2 over [0, 2]
    assert abs(float(ones @ M.matvec(f)) - 8.0 / 3.0) < 1e-12
    S = M.to_scipy()
    assert abs(S - S.T).max() < 1e-13


def test_inversion_block_structure(fe_port):
    """Continuity block = -transpose of the pressure gradient, zero pp
    block, a Coriolis (antisymmetric) part, rigid motions in the
    viscous null space."""
    fe = fe_port
    wq = _T(fe.geom.wq)
    Gu3 = at.physical_grads(_T(fe.geom.invJT), _T(fe.tab_u.dphi), _T(fe.embed))
    elem = at.elem_inversion(wq, torch.ones_like(wq), 0.7 * torch.ones_like(wq),
                             _T(fe.tab_u.phi), Gu3, _T(fe.tab_p.phi), 0.25, False)
    A = st.coo_from_plan(fe.plan_inv, fe.plan_inv.assemble(elem)).to_scipy().toarray()
    n_u = fe.spaces.n_u
    Auu, Aup, Apu, App = A[:n_u, :n_u], A[:n_u, n_u:], A[n_u:, :n_u], A[n_u:, n_u:]
    assert np.abs(Apu + Aup.T).max() < 1e-12
    assert np.abs(App).max() == 0.0
    assert np.abs(0.5 * (Auu - Auu.T)).max() > 0
    assert np.abs(0.5 * (Auu + Auu.T) @ np.ones(n_u)).max() < 1e-11


def test_b_matrix(fe_port):
    """B maps b to vertical momentum: (1/alpha) b zhat.v."""
    fe = fe_port
    elem = at.elem_buoyancy_to_velocity(_T(fe.geom.wq), _T(fe.tab_u.phi), _T(fe.tab_b.phi), 2.0)
    B = st.coo_from_plan(fe.plan_B, fe.plan_B.assemble(elem))
    y = B.matvec(torch.ones(fe.spaces.n_b, dtype=torch.float64)).numpy()
    n_u = fe.spaces.n_u
    assert np.abs(y[n_u:]).max() == 0.0
    yw = y[:n_u].reshape(-1, 3)
    assert np.abs(yw[:, :2]).max() < 1e-14
    assert abs(yw[:, 2].sum() - 2.0 * 2.0) < 1e-12


# ----------------------------------------------------------------------
# JLD2 and the Gridap dof maps
# ----------------------------------------------------------------------

def _model_kw(pkg, mesh, b_surface):
    alpha = 0.5
    params = pkg.Parameters(eps=2e-1, alpha=alpha, mu_rho=1e1, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = pkg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=pkg.SurfaceDirichletBC(b_surface))
    fe = pkg.FEData(mesh, _spaces(pkg, mesh, b_surface))
    return fe, params, forc, pkg.BDF2(t_start=0, t_stop=1.0, dt=0.01)


@pytest.fixture(scope="module")
def msh_models(tmp_path_factory):
    """The 3D bowl written with write_msh and read back by both
    packages, and each package's model on it (f64, surface b = 0.1)."""
    assert_same_rcm_branch()
    path = str(tmp_path_factory.mktemp("msh") / "bowl3d.msh")
    npt.write_msh(npt.generators.bowl3D(0.35, 0.5, nz=3), path)
    mj = npj.PGModel(*_model_kw(npj, npj.read_msh(path), 0.1))
    mt = npt.PGModel(*_model_kw(npt, npt.read_msh(path), 0.1), dtype=torch.float64,
                     device="cpu")
    return path, mj, mt


def _random_state(model, rng, pkg):
    sp = model.fe.spaces
    u = rng.standard_normal((sp.u_space.ndof, 3))
    p, b = rng.standard_normal(sp.n_p), rng.standard_normal(sp.n_b)
    if pkg is npj:
        from nupgcm_tpu.models.model import State

        return State(u=jnp.asarray(u), p=jnp.asarray(p), b=jnp.asarray(b), u_prev=jnp.asarray(u),
                     b_prev=jnp.asarray(b), t=jnp.asarray(0.37), dt=jnp.asarray(0.01),
                     step=jnp.asarray(0, jnp.int32))
    T = torch.from_numpy
    return npt.State(u=T(u), p=T(p), b=T(b), u_prev=T(u), b_prev=T(b),
                     t=torch.tensor(0.37, dtype=torch.float64),
                     dt=torch.tensor(0.01, dtype=torch.float64), step=0)


@pytest.fixture
def h5py():
    """The JLD2 tests need h5py (io/jld2 and io/gridap import it inside
    their functions); the plan and operator tests above do not."""
    return pytest.importorskip("h5py")


def _same_bits(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


def test_jld2_from_jax_to_port(msh_models, tmp_path, h5py):
    from nupgcm_tpu.io import jld2 as jj
    from nupgcm_tpu_torch.io import jld2 as jt

    _, mj, mt = msh_models
    s = _random_state(mj, np.random.default_rng(2), npj)
    path = str(tmp_path / "jax.jld2")
    jj.export_state(mj, s, path)
    got = jt.import_state(mt, path)
    for f in ("u", "p", "b", "u_prev", "b_prev"):
        assert _same_bits(getattr(got, f).numpy(), getattr(s, f)), f
    assert float(got.t) == 0.37 and got.step == 0 and got.u.dtype == torch.float64
    assert sorted(jt.read_jld2(path)) == ["b", "p", "t", "u"]


def test_jld2_from_port_to_jax(msh_models, tmp_path, h5py):
    from nupgcm_tpu.io import jld2 as jj
    from nupgcm_tpu_torch.io import jld2 as jt

    _, mj, mt = msh_models
    s = _random_state(mt, np.random.default_rng(3), npt)
    path = str(tmp_path / "port.jld2")
    jt.export_state(mt, s, path)
    got = jj.import_state(mj, path)
    for f in ("u", "p", "b", "u_prev", "b_prev"):
        assert _same_bits(getattr(got, f), getattr(s, f).numpy()), f
    # and back: the port reads its own file bitwise, and a file of the
    # reference's zero-mean pressure (one dof fewer) gets a zero pad
    back = jt.import_state(mt, path)
    assert all(_same_bits(getattr(back, f).numpy(), getattr(s, f).numpy()) for f in "upb")
    with h5py.File(path, "r+") as f:
        p = f["p"][()]
        del f["p"]
        f.create_dataset("p", data=p[:-1])
    padded = jt.import_state(mt, path).p.numpy()
    assert _same_bits(padded, jj.import_state(mj, path).p)


@pytest.fixture(scope="module", params=[2, 3])
def msh_spaces(request, tmp_path_factory):
    assert_same_rcm_branch()
    dim = request.param
    path = str(tmp_path_factory.mktemp("msh") / f"bowl{dim}d.msh")
    npt.write_msh(_mesh(npt, dim), path)
    return path, _spaces(npj, npj.read_msh(path)), _spaces(npt, npt.read_msh(path))


@pytest.mark.parametrize("sort_cells", [None, False, True])
def test_gridap_maps_match_jax(msh_spaces, sort_cells):
    from nupgcm_tpu.io import gridap as gj
    from nupgcm_tpu_torch.io import gridap as gt

    path, spj, spt = msh_spaces
    a = gj.gridap_maps(path, spj, sort_cells=sort_cells)
    b = gt.gridap_maps(path, spt, sort_cells=sort_cells)
    for k in ("u_free", "p_free", "b_free", "node_order"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    assert gt.GRIDAP_LOCAL_EDGES == gj.GRIDAP_LOCAL_EDGES
    from nupgcm_tpu_torch.mesh.gmsh_reader import read_msh_arrays

    cells = read_msh_arrays(path)[1]
    for srt in (False, True):
        led = gt.GRIDAP_LOCAL_EDGES[cells.shape[1] - 1]
        assert np.array_equal(gt.first_touch_edges(cells, led, srt),
                              gj.first_touch_edges(cells, led, srt))


def _write_reference_file(path, model, state, maps, t=0.25):
    """A reference-style JLD2 file: u, p, b free values in Gridap order."""
    import h5py

    sp = model.fe.spaces
    u = sp.u_space.to_original_order(state.u.numpy()).reshape(-1)
    b = sp.b_space.to_original_order(state.b.numpy())
    p = sp.p_space.to_original_order(state.p.numpy())
    with h5py.File(path, "w") as f:
        f.create_dataset("u", data=u[maps.u_free])
        f.create_dataset("p", data=p[maps.p_free])
        f.create_dataset("b", data=b[maps.b_free])
        f.create_dataset("t", data=np.float64(t))


def test_state_from_reference_matches_jax(msh_models, tmp_path, h5py):
    from nupgcm_tpu.io import gridap as gj
    from nupgcm_tpu_torch.io import gridap as gt

    path, mj, mt = msh_models
    maps = gt.gridap_maps(path, mt.fe.spaces)
    ref = mt.set_b(mt.rest_state(), lambda x: 0.1 + 0.05 * x[2])
    rng = np.random.default_rng(4)
    ref.u = torch.from_numpy(rng.standard_normal(tuple(ref.u.shape))) * mt.const["free_u"].reshape(-1, 3)
    ref.p = torch.from_numpy(rng.standard_normal(ref.p.shape[0]))
    f = str(tmp_path / "ref.jld2")
    _write_reference_file(f, mt, ref, maps)
    a = gj.state_from_reference(mj, f, gj.gridap_maps(path, mj.fe.spaces))
    b = gt.state_from_reference(mt, f, maps)
    for k in ("u", "p", "b", "u_prev", "b_prev"):
        x, y = np.asarray(getattr(a, k)), getattr(b, k).numpy()
        assert np.abs(x - y).max() <= REL * np.abs(x).max(), k
    assert float(b.t) == float(a.t) == 0.25
    # free values land where they came from; Dirichlet dofs keep the
    # model's values (surface b = 0.1)
    assert np.array_equal(b.u.numpy(), ref.u.numpy())
    assert np.abs(b.b.numpy() - ref.b.numpy()).max() == 0.0
    assert float(b.b[~mt.const["free_b"].bool()].min()) == pytest.approx(0.1)


def test_assemble_inversion_csr_matches_jax(msh_models):
    from nupgcm_tpu.io import gridap as gj
    from nupgcm_tpu_torch.io import gridap as gt

    _, mj, mt = msh_models
    A, B = gj.assemble_inversion_csr(mj), gt.assemble_inversion_csr(mt)
    assert A.shape == B.shape == (mt.fe.n_inv,) * 2
    assert abs(A - B).max() <= REL * abs(A).max()
    # the canonical-order matrix is the model's operator, permuted
    sp = mt.fe.spaces
    x = np.random.default_rng(5).standard_normal(mt.fe.n_inv)
    n3 = sp.n_u
    xu = sp.u_space.from_original_order(x[:n3].reshape(-1, 3)).reshape(-1)
    xp = sp.p_space.from_original_order(x[n3:])
    y = mt._inv_matrix(mt.ops).matvec(torch.from_numpy(np.concatenate([xu, xp]))).numpy()
    y_can = np.concatenate([sp.u_space.to_original_order(y[:n3].reshape(-1, 3)).reshape(-1),
                            sp.p_space.to_original_order(y[n3:])])
    assert np.abs(B @ x - y_can).max() <= 1e-10 * np.abs(y_can).max()


def test_read_jld2_csc_matches_jax(tmp_path, h5py):
    """A Julia SparseMatrixCSC as JLD2 stores it: a compound of m, n
    and object references to 1-based colptr, rowval, nzval."""
    import scipy.sparse as sps

    from nupgcm_tpu.io import gridap as gj
    from nupgcm_tpu_torch.io import gridap as gt

    M = sps.random(7, 5, density=0.4, random_state=6, format="csc")
    path = str(tmp_path / "A.jld2")
    with h5py.File(path, "w") as f:
        refs = [f.create_dataset(k, data=v).ref for k, v in
                (("colptr", M.indptr + 1), ("rowval", M.indices + 1), ("nzval", M.data))]
        dt = np.dtype([("m", np.int64), ("n", np.int64), ("colptr", h5py.ref_dtype),
                       ("rowval", h5py.ref_dtype), ("nzval", h5py.ref_dtype)])
        f.create_dataset("A_inversion", data=np.array([(7, 5, *refs)], dtype=dt)[0])
    a, b = gj.read_jld2_csc(path, "A_inversion"), gt.read_jld2_csc(path, "A_inversion")
    assert (b != a).nnz == 0 and (b != M).nnz == 0 and b.shape == (7, 5)


def test_northstar_prefix_check_reads_a_golden(msh_models, tmp_path, h5py):
    """The north-star tool's golden branch on a synthetic golden written
    in Gridap order: the state it came from reads 0, another state not."""
    from nupgcm_tpu_torch.io import gridap as gt
    from nupgcm_tpu_torch.tools import northstar

    path, _, mt = msh_models
    state = mt.set_b(mt.rest_state(), lambda x: 0.1 + 0.05 * np.exp(x[2]))
    state = dataclasses.replace(state, u=torch.from_numpy(
        np.random.default_rng(7).standard_normal(tuple(state.u.shape))) * mt.const["free_u"].reshape(-1, 3))
    golden = str(tmp_path / "golden.jld2")
    _write_reference_file(golden, mt, state, gt.gridap_maps(path, mt.fe.spaces))
    got = northstar.prefix_check(mt, state, path, golden)
    assert sorted(got) == ["prefix50_pass_1e3", "prefix50_rel_l2_b", "prefix50_rel_l2_u"]
    assert got["prefix50_rel_l2_u"] < 1e-28 and got["prefix50_rel_l2_b"] < 1e-28
    assert got["prefix50_pass_1e3"] is True
    off = dataclasses.replace(state, b=state.b * 1.1)
    bad = northstar.prefix_check(mt, off, path, golden)
    assert bad["prefix50_rel_l2_b"] > 1e-3 and bad["prefix50_pass_1e3"] is False
    assert "NUPGCM_REF_GOLDEN" in northstar.__doc__
