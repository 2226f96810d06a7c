"""The port's analysis path against nupgcm_tpu, in f64 on the CPU, on
tests/test_io_postprocess.py's small bowl (the JAX model runs 3 steps,
the port takes its state through ``state_from_numpy``):

  * point evaluation (P2 exactness, NaN outside) and ``find_H``;
  * ``save_vtk``: the VTU file byte-identical to the JAX package's;
  * ``sample_state``, the barotropic and overturning streamfunctions,
    ``zonal_mean``, ``stratification`` and ``cfl_map``: every array
    within 1e-12 (relative to its max), NaN where JAX has NaN;
  * the plot products (under ``pytest.importorskip("matplotlib")``):
    ports of the plotting parts of tests/test_io_postprocess.py and
    tests/test_tools.py;
  * ``tools.column`` (NumPy): tests/test_tools.py's column tests, and
    the same columns as ``nupgcm_tpu.tools.column``.
"""

import os

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch import postprocess as P
from nupgcm_tpu_torch.io.vtk import save_vtk
from nupgcm_tpu_torch.models.model import state_from_numpy
from nupgcm_tpu_torch.utils.pointeval import FieldEvaluator, find_H
from torch_parity import assert_same_rcm_branch

FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


def _small(npg, **kw):
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl3D(0.35, alpha, nz=2)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0])
    fe = npg.FEData(mesh, spaces)
    return npg.PGModel(fe, params, forc, npg.BDF2(t_start=0, t_stop=0.5, dt=0.1),
                       inv_itmax=200, **kw)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX state, port model, the same state in the port)."""
    assert_same_rcm_branch()
    mj = _small(npj)
    sj = mj.run(mj.set_b(mj.rest_state(), lambda x: 0.05 * np.exp(2 * x[2])),
                n_info=0, max_steps=3)
    mt = _small(npt, dtype=torch.float64, device="cpu")
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    return mj, sj, mt, st


def _same(a, b, what, rel=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    ok = ~np.isnan(a)
    scale = max(np.abs(a[ok]).max(), 1e-300) if ok.any() else 1.0
    assert np.abs(a[ok] - b[ok]).max(initial=0.0) <= rel * scale, what


def test_point_eval_exactness_and_parity(pair):
    mj, sj, mt, st = pair
    bs = mt.fe.spaces.b_space
    x = bs.dof_coords
    f = 1.0 + x[:, 0] + 2 * x[:, 2] + x[:, 0] * x[:, 2]
    ev = FieldEvaluator(mt.fe.mesh)
    pts = np.array([[0.0, 0.0, -0.2], [0.5, 0.1, -0.1], [2.0, 0.0, 0.0]])
    vals = ev.eval(bs, f, pts)
    exact = 1.0 + pts[:, 0] + 2 * pts[:, 2] + pts[:, 0] * pts[:, 2]
    assert np.allclose(vals[:2], exact[:2], atol=1e-10)
    assert np.isnan(vals[2])
    # the state's fields at scattered points, tensors straight in
    from nupgcm_tpu.utils.pointeval import FieldEvaluator as FieldEvaluatorJ

    evj = FieldEvaluatorJ(mj.fe.mesh)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-1, -1, -0.5], [1, 1, 0], (200, 3))
    _same(evj.eval(mj.fe.spaces.u_space, np.asarray(sj.u), pts),
          ev.eval(mt.fe.spaces.u_space, st.u, pts), "u")
    _same(evj.eval(mj.fe.spaces.b_space, np.asarray(sj.b), pts),
          ev.eval(bs, st.b, pts), "b")


def test_find_H_matches(pair):
    from nupgcm_tpu.utils.pointeval import FieldEvaluator as FieldEvaluatorJ
    from nupgcm_tpu.utils.pointeval import find_H as find_H_j

    mj, _, mt, _ = pair
    ev, evj = FieldEvaluator(mt.fe.mesh), FieldEvaluatorJ(mj.fe.mesh)
    alpha = mt.params.alpha
    H = find_H(ev, 0.0, 0.0, tol=1e-10)
    assert abs(H - alpha) < 0.15
    assert abs(find_H(ev, 0.7, 0.0, tol=1e-10) - alpha * (1 - 0.49)) < 0.15
    assert np.isnan(find_H(ev, 2.0, 0.0))
    for x, y in ((0.0, 0.0), (0.7, 0.0), (0.3, -0.4)):
        assert find_H(ev, x, y, tol=1e-10) == find_H_j(evj, x, y, tol=1e-10)


def test_vtu_byte_identical(pair, tmp_path):
    from nupgcm_tpu.io.vtk import save_vtk as save_vtk_j

    mj, sj, mt, st = pair
    pj, pt = tmp_path / "j.vtu", tmp_path / "t.vtu"
    save_vtk_j(mj, sj, str(pj))
    save_vtk(mt, st, str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    txt = pt.read_text()
    assert 'Name="u"' in txt and 'Name="alpha*b_z"' in txt and 'Name="kappa_v"' in txt


def test_sample_state_and_streamfunctions_match(pair):
    from nupgcm_tpu import postprocess as PJ

    mj, sj, mt, st = pair
    grid = P.Grid3.from_mesh(mt.fe.mesh, nx=24, ny=24, nz=12)
    gj = PJ.Grid3.from_mesh(mj.fe.mesh, nx=24, ny=24, nz=12)
    for k in ("x", "y", "z"):
        assert np.array_equal(getattr(grid, k), getattr(gj, k))
    s, sjs = P.sample_state(mt, st, grid), PJ.sample_state(mj, sj, gj)
    assert sorted(s) == sorted(sjs)
    for k in s:
        _same(sjs[k], s[k], k)
    inside = s["mask"] > 0
    assert (s["b"][inside] != s["b_pert"][inside]).any()  # N^2 z background
    Psi, U, _ = P.barotropic_streamfunction(mt, st, grid)
    Psi_j, U_j, _ = PJ.barotropic_streamfunction(mj, sj, gj)
    _same(Psi_j, Psi, "Psi")
    _same(U_j, U, "U")
    assert np.isnan(Psi[0, 0]) and np.isfinite(Psi[12, 12])
    out, out_j = (P.overturning_streamfunction(mt, st, grid),
                  PJ.overturning_streamfunction(mj, sj, gj))
    for name, a, b in zip(("psi", "v_int", "b_bar"), out_j[:3], out[:3]):
        _same(a, b, name)
    assert np.isfinite(out[0]).any()
    _same(PJ.zonal_mean(sjs["v"], sjs, gj), P.zonal_mean(s["v"], s, grid), "zonal_mean")
    prof, z = P.stratification(mt, st, grid)
    prof_j, _ = PJ.stratification(mj, sj, gj)
    _same(prof_j, prof, "stratification")
    assert np.isfinite(prof[2:-2]).all()


def test_cfl_map_matches(pair):
    from nupgcm_tpu import postprocess as PJ

    mj, sj, mt, st = pair
    cfl = P.cfl_map(mt, st)
    assert cfl.shape == (mt.fe.mesh.n_cells,) and np.isfinite(cfl).all()
    _same(PJ.cfl_map(mj, sj), cfl, "cfl")


# ----------------------------------------------------------------------
# plot products (matplotlib, imported when a plot is drawn)
# ----------------------------------------------------------------------

def test_find_H_and_cached_slice_plots(pair, tmp_path):
    pytest.importorskip("matplotlib")
    from nupgcm_tpu_torch.plotting import SliceCache, plot_slice, sim_plots

    _, _, mt, st = pair
    c1 = plot_slice(mt, st, "b", ofile=str(tmp_path / "b1.png"), n=32)
    c2 = plot_slice(mt, st, "w", ofile=str(tmp_path / "w1.png"), cache=c1, quiver=True)
    assert c2 is c1
    cz = plot_slice(mt, st, "u", z=-0.1, ofile=str(tmp_path / "uz.png"), n=24)
    assert cz.labels == ("x", "y")
    files = sim_plots(mt, st, out_dir=str(tmp_path), index=3)
    assert all(os.path.exists(f) for f in files)
    assert isinstance(getattr(mt, "_slice_cache", None), SliceCache)


def test_publication_plots_3d(pair, tmp_path):
    pytest.importorskip("matplotlib")
    from nupgcm_tpu_torch import plotting as PL

    _, _, mt, st = pair
    g = P.Grid3.from_mesh(mt.fe.mesh, nx=24, ny=24, nz=12)
    PL.plot_psi2d(mt, st, n=32, ofile=str(tmp_path / "psi2d.png"))
    PL.plot_barotropic_streamfunction(mt, st, grid=g, ofile=str(tmp_path / "baro.png"))
    PL.plot_overturning_streamfunction(mt, st, grid=g, ofile=str(tmp_path / "ovt.png"))
    PL.plot_zonal_mean(mt, st, "v", grid=g, ofile=str(tmp_path / "zm.png"))
    PL.circulation_plot(mt, st, "z", -0.1, n=32, ofile=str(tmp_path / "circ.png"))
    PL.plot_stratification(mt, st, grid=g, ofile=str(tmp_path / "strat.png"))
    PL.plot_profiles(mt, st, ofile=str(tmp_path / "prof.png"), n=32)
    for f in ("psi2d", "baro", "ovt", "zm", "circ", "strat", "prof"):
        assert (tmp_path / f"{f}.png").stat().st_size > 0


@pytest.fixture(scope="module")
def channel2d():
    """tests/test_io_postprocess.py's channel2D model, 2 steps."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npt.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha, f=1.0, H=alpha)
    forc = npt.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npt.SurfaceDirichletBC(0.0))
    mesh = npt.generators.channel2D(0.1, alpha)
    spaces = npt.Spaces(mesh, u_diri_tags=["bottom", "basin", "coastline"],
                        u_diri_vals=[(0, 0, 0)] * 3,
                        u_diri_masks=[(True, True, True)] * 3,
                        b_diri_tags=["surface"], b_diri_vals=[0.0])
    fe = npt.FEData(mesh, spaces)
    model = npt.PGModel(fe, params, forc, npt.BDF2(t_start=0, t_stop=0.5, dt=0.1),
                        inv_itmax=200, dtype=torch.float64, device="cpu")
    st = model.set_b(model.rest_state(), lambda x: 0.05 * np.exp(2 * x[2]))
    return model, model.run(st, n_info=0, max_steps=2)


def test_publication_plots_channel(channel2d, tmp_path):
    pytest.importorskip("matplotlib")
    from nupgcm_tpu_torch import plotting as PL

    model, st = channel2d
    assert np.isfinite(st.u.numpy()).all()
    PL.plot_channel_psib(model, st, n=32, rescale_z=True, ofile=str(tmp_path / "cpsi.png"))
    PL.plot_channel_uvwb(model, st, rescale_z=True, ofile=str(tmp_path / "cuvwb.png"))
    PL.plot_channel_field(model, st, "v", rescale_z=True, ofile=str(tmp_path / "cv.png"))
    PL.plot_psi_profile(model, st, -0.75, n=48, ofile=str(tmp_path / "cprof.png"))
    PL.plot_surface_b_flux(model, st, n=48, ofile=str(tmp_path / "cflux.png"))
    for f in ("cpsi", "cuvwb", "cv", "cprof", "cflux"):
        assert (tmp_path / f"{f}.png").stat().st_size > 0


def test_plot_tri_mesh_and_wave(tmp_path):
    pytest.importorskip("matplotlib")
    from nupgcm_tpu_torch.plotting import plot_slice_wave, plot_tri_mesh

    alpha = 0.5
    params = npt.Parameters(eps=2e-1, alpha=alpha, mu_rho=1e1, N2=1 / alpha, f=1.0,
                            H=lambda x: alpha * (1 - x[0] ** 2))
    forc = npt.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npt.SurfaceDirichletBC(0.0))
    mesh = npt.generators.bowl2D(0.2, alpha)
    spaces = npt.Spaces(mesh, u_diri_tags=["bottom", "coastline", "surface"],
                        u_diri_vals=[(0, 0, 0)] * 3,
                        u_diri_masks=[(True, True, True), (True, True, True),
                                      (False, False, True)],
                        b_diri_tags=["surface"], b_diri_vals=[0.0])
    model = npt.PGModel(npt.FEData(mesh, spaces), params, forc,
                        npt.BDF2(t_start=0, t_stop=0.3, dt=0.1), dtype=torch.float64,
                        device="cpu")
    st = model.run(model.set_b(model.rest_state(), lambda x: 0.05 * np.exp(2 * x[2])),
                   n_info=0, max_steps=2)
    f1 = plot_tri_mesh(model, st.b, ofile=str(tmp_path / "tri.png"))
    uc = st.u.numpy() * (1.0 + 0.5j)
    bc = st.b.numpy() * (1.0 + 0.5j)
    f2 = plot_slice_wave(model, uc, bc, N2=model.params.N2, k=2.0, omega=0.1 + 0.05j,
                         ofile=str(tmp_path / "wave.png"))
    assert os.path.getsize(f1) > 0 and os.path.getsize(f2) > 0


# ----------------------------------------------------------------------
# tools.column (NumPy)
# ----------------------------------------------------------------------

def test_fd_stencil_exactness():
    from nupgcm_tpu_torch.tools.column import fd_stencil

    x = np.array([0.0, 0.3, 1.0])
    f = 2 + 3 * x + 4 * x ** 2
    assert abs(fd_stencil(x, 0.3, 1) @ f - (3 + 8 * 0.3)) < 1e-12
    assert abs(fd_stencil(x, 0.3, 2) @ f - 8.0) < 1e-12


def test_column_flat_bottom_steady_state():
    from nupgcm_tpu_torch.tools.column import ColumnModel

    m = ColumnModel(nz=64, eps=0.3, theta=0.0, dt=0.5, kappa=1.0, nu=1.0)
    b = np.zeros(m.nz)
    for _ in range(2000):
        b = m.step_b(b)
    assert np.allclose(b, -m.z, atol=1e-6)
    u, v, w, Px = m.invert(b)
    assert np.max(np.abs(u)) < 1e-12 and np.max(np.abs(w)) < 1e-12


@pytest.mark.parametrize("no_Px", [False, True])
def test_column_slope_matches_jax_package(no_Px):
    """The sloped column (transport constraint, bottom flux) and its
    no-Px variant, and the same numbers as nupgcm_tpu.tools.column."""
    from nupgcm_tpu.tools.column import ColumnModel as ColumnJ

    from nupgcm_tpu_torch.tools.column import ColumnModel

    kw = dict(nz=96, eps=0.2, theta=0.1, phi=0.0, dt=0.1,
              kappa=lambda z: 1e-1 + np.exp(-(z + 1) / 0.2))
    if no_Px:
        kw = dict(nz=48, eps=0.2, theta=0.05, no_Px=True, dt=0.1)
    t_stop = 2.0 if no_Px else 20.0
    m = ColumnModel(**kw)
    out = m.run(t_stop=t_stop)
    for a, b in zip(ColumnJ(**kw).run(t_stop=t_stop), out):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    b, u, v, w, Px = out
    if no_Px:
        assert Px == pytest.approx(0.0, abs=1e-14)
        return
    assert np.max(np.abs(u)) > 1e-8
    dz = np.diff(m.z)
    trans = np.sum((u[:-1] + u[1:]) / 2 * dz)
    assert abs(trans) < 1e-10 * max(np.max(np.abs(u)), 1.0)
    assert abs(u[0]) < 1e-12 and abs(v[0]) < 1e-12
    assert abs(1.0 + m.Gamma * m.bz(b)[0]) < 1e-8
