"""The port's convection and eddy closures and ``run``'s refresh
cadence against nupgcm_tpu, in f64 on the CPU.

  * convection (tests/test_model.py::test_convection_parameterization's
    configuration): states within 1e-10 relative with equal per-step
    iteration counts, and the JAX test's own property;
  * eddy rebuild (test_eddy_parameterization_rebuild's configuration):
    A_uu_e after the step-10 rebuild within 1e-12 and states within
    1e-10 through step 10, equal iterations on all 12 steps;
  * kappa_v and nu on seeded stratifications up to |abz| = 1e3;
  * run's n_precond_refresh cadence with steps_per_block 1 and 3.

refresh_precond is tested in test_torch_refresh.py.
"""

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import state_from_numpy

FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_port(sj):
    return state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")


def _assert_close(a, b, rel, what):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-300), what


def _assert_states_close(sj, st, rel=1e-10):
    for f in ("u", "p", "b"):
        _assert_close(getattr(sj, f), getattr(st, f), rel, f)
    assert st.step == int(sj.step)
    assert float(st.t) == pytest.approx(float(sj.t), rel=1e-14)


def _lockstep(mj, mt, sj, st, n):
    """n steps of both packages: equal iteration counts every step;
    returns (JAX state, port state)."""
    for _ in range(n):
        mj.ops, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"])
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0
    return sj, st


# ----------------------------------------------------------------------
# the closure functions
# ----------------------------------------------------------------------

def test_closure_functions_match():
    rng = np.random.default_rng(0)
    abz = np.concatenate([rng.uniform(-1e3, 1e3, 500), rng.uniform(-1, 1, 500),
                          [0.0, 1e3, -1e3]])
    f_q = rng.uniform(-2, 2, abz.shape)
    kv = rng.uniform(0, 1, abz.shape)
    conv = dict(kappa_c=10.0, N2_min=1e-3)
    eddy = dict(f=1.0, N2_min=float(np.sqrt(1e-3)))
    cj, ct = npj.ConvectionParameterization(**conv), npt.ConvectionParameterization(**conv)
    ej, et = npj.EddyParameterization(**eddy), npt.EddyParameterization(**eddy)
    T = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt)
    _assert_close(cj.kappa_v(kv, abz), ct.kappa_v(T(kv), T(abz)), 1e-14, "kappa_v")
    _assert_close(ej.nu(f_q, abz), et.nu(T(f_q), T(abz)), 1e-14, "nu")
    # f32: the stable LogSumExp keeps nu finite where the naive form
    # overflows (s * nu_eddy > 88)
    nu32 = et.nu(T(f_q, torch.float32), T(abz, torch.float32))
    kv32 = ct.kappa_v(T(kv, torch.float32), T(abz, torch.float32))
    assert nu32.dtype == kv32.dtype == torch.float32
    assert torch.isfinite(nu32).all() and torch.isfinite(kv32).all()
    assert float(nu32.max()) > 8.8  # past the naive form's overflow
    _assert_close(ej.nu(f_q, abz), nu32.double(), 1e-6, "nu f32")


# ----------------------------------------------------------------------
# convection
# ----------------------------------------------------------------------

def _convection(npg, conv_on, **kw):
    mesh = npg.generators.rect_mesh(4, 8)
    params = npg.Parameters(eps=0.5, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    base = dict(nu=1.0, kappa_h=0.0, kappa_v=1e-3, tau_x=0.0, tau_y=0.0,
                b_surface_bc=npg.SurfaceDirichletBC(0.0))
    if conv_on:
        base["conv_param"] = npg.ConvectionParameterization(kappa_c=10.0, N2_min=1e-3)
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF1(t_start=0, t_stop=0.05, dt=0.01)
    return npg.PGModel(fe, params, npg.Forcings(**base), ts, **kw)


def test_convection_matches_and_mixes():
    unstable = lambda x: -0.5 * x[2]  # db/dz < 0
    mj = _convection(npj, True)
    mt = _convection(npt, True, dtype=torch.float64, device="cpu")
    sj = mj.set_b(mj.rest_state(), unstable)
    sj, st = _lockstep(mj, mt, sj, _to_port(sj), 5)
    _assert_states_close(sj, st)
    # the JAX test's property: convection flattens the unstable profile
    off = _convection(npt, False, dtype=torch.float64, device="cpu")
    s_off = off.run(off.set_b(off.rest_state(), unstable), n_info=0)
    s_on = mt.run(mt.set_b(mt.rest_state(), unstable), n_info=0)
    assert s_on.step == s_off.step == 5
    assert np.var(s_on.b.numpy()) < 0.5 * np.var(s_off.b.numpy())


# ----------------------------------------------------------------------
# eddy rebuild
# ----------------------------------------------------------------------

def _eddy2d(npg, **kw):
    mesh = npg.generators.bowl2D(0.2, 0.5)
    eddy = npg.EddyParameterization(f=lambda x: 1.0 + 0 * x[1], N2_min=1e-2)
    params = npg.Parameters(eps=2e-1, alpha=0.5, mu_rho=1e1, N2=2.0,
                            f=lambda x: 1.0 + 0 * x[1],
                            H=lambda x: 0.5 * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0), eddy_param=eddy)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=12 * 0.05, dt=0.05)
    return npg.PGModel(fe, params, forc, ts, **kw)


@pytest.fixture(scope="module")
def eddy_pair():
    """The JAX model and the port on the reference's frozen
    preconditioner (the port's ``refresh_on_rebuild=False``): the JAX
    step keeps it across the eddy rebuild."""
    return _eddy2d(npj), _eddy2d(npt, dtype=torch.float64, device="cpu",
                                 refresh_on_rebuild=False)


def test_eddy_rebuild_matches(eddy_pair):
    """The step-10 rebuild replaces the inversion blocks of ``ops`` and
    keeps the preconditioner.  The first solve after it takes 35 FGMRES
    iterations on the stale preconditioner at rtol 1e-6, which amplifies
    the packages' last-bit differences: steps 11-12 agree to 5e-11 ..
    4e-10 relative in u depending on the CPU thread count, so they are
    held to 1e-8 (and to equal iteration counts); the states through the
    rebuild step are held to 1e-10."""
    mj, mt = eddy_pair
    assert mt.variable_nu and mj.variable_nu
    _assert_close(mj.const["f_eddy_q"], mt.const["f_eddy_q"], 1e-15, "f_eddy_q")
    A0 = mt.ops["A_uu_e"].clone()
    visc0 = mt.ops["visc_e"].clone()
    ic = lambda x: 0.1 * np.exp(2 * x[2])
    sj = mj.set_b(mj.rest_state(), ic)
    sj, st = _lockstep(mj, mt, sj, _to_port(sj), 9)
    assert torch.equal(mt.ops["A_uu_e"], A0)  # no rebuild before step 10
    sj, st = _lockstep(mj, mt, sj, st, 1)
    _assert_states_close(sj, st)
    assert float((mt.ops["A_uu_e"] - A0).abs().max()) > 1e-10  # rebuilt
    assert torch.equal(mt.ops["visc_e"], visc0)  # preconditioner kept
    for k in ("A_uu_e", "A_up_e", "A_pu_e"):
        _assert_close(mj.ops[k], mt.ops[k], 1e-12, k)
    sj, st = _lockstep(mj, mt, sj, st, 2)
    _assert_states_close(sj, st, rel=1e-8)
    assert np.isfinite(st.u.numpy()).all()


def test_run_refresh_cadence(eddy_pair, monkeypatch):
    """n_precond_refresh counts steps since the last refresh: with
    blocks of 3 and a cadence of 5 it fires at steps 6 and 12, as JAX's
    run does."""
    mj, mt = eddy_pair
    ic = lambda x: 0.1 * np.exp(2 * x[2])
    for spb, expect in ((1, [5, 10]), (3, [6, 12])):
        fired = {}
        for name, m in (("jax", mj), ("port", mt)):
            calls = fired.setdefault(name, [])
            monkeypatch.setattr(m, "refresh_precond",
                                lambda ops, st, calls=calls: calls.append(int(st.step)) or ops)
            st = m.run(m.set_b(m.rest_state(), ic), n_info=0, max_steps=12,
                       steps_per_block=spb, n_precond_refresh=5)
            assert int(st.step) == 12
        assert fired["port"] == fired["jax"] == expect, (spb, fired)
