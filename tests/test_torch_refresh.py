"""``refresh_precond`` of the port against nupgcm_tpu, in f64 on the
CPU, in tests/test_model.py::test_precond_refresh_tracks_eddy_nu's
configuration (bowl3D(0.35, nz=3), eddy closure, BDF2) on the dense and
the iterative + aggregate coarse branches: 30 steps through
``multi_step`` (three eddy rebuilds) with equal iteration counts and
states within 1e-10; then every ops key keeps its shape, the rebuilt
operators agree within 1e-10, and the step after the refresh takes
JAX's iteration count.  Without an eddy closure the refresh returns the
same dict.
"""

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _assert_close(a, b, rel, what):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rel * max(np.abs(a).max(), 1e-300), what


def _assert_states_close(sj, st, rel=1e-10):
    for f in ("u", "p", "b"):
        _assert_close(getattr(sj, f), getattr(st, f), rel, f)
    assert st.step == int(sj.step)
    assert float(st.t) == pytest.approx(float(sj.t), rel=1e-14)


def _eddy3d(npg, eddy=True, **kw):
    eps, alpha, mu = 2e-1, 0.5, 1e1
    mesh = npg.generators.bowl3D(0.35, alpha, nz=3)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    extra = {}
    if eddy:
        extra["eddy_param"] = npg.EddyParameterization(
            f=lambda x: 1.0 + 0.5 * x[1], N2_min=float(np.sqrt(1e-3)))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0), **extra)
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=1e-2)
    return npg.PGModel(fe, params, forc, ts, inv_atol=1e-7, inv_rtol=1e-7, **kw)


REFRESH_BRANCHES = {"dense": {}, "iterative_l2": dict(coarse_dense_max=256)}


@pytest.mark.parametrize("branch", list(REFRESH_BRANCHES))
def test_refresh_precond_matches(branch):
    kw = REFRESH_BRANCHES[branch]
    mj = _eddy3d(npj, **kw)
    # the JAX multi_step keeps the preconditioner across its eddy
    # rebuilds: the port's refresh_on_rebuild=False
    mt = _eddy3d(npt, dtype=torch.float64, device="cpu", refresh_on_rebuild=False, **kw)
    assert (mt.saddle_coarse_dense, mt.saddle_coarse_l2) == (
        (True, False) if branch == "dense" else (False, True))
    # 30 steps (three eddy rebuilds) through multi_step in both packages
    ops, sj, auxj = mj.multi_step_jit(mj.ops, mj.rest_state(), 30)
    mj.ops = ops
    st, aux = mt.multi_step(mt.rest_state(), 30)
    for k in ("evo_iters", "inv_iters"):
        assert np.array_equal(aux[k], np.asarray(auxj[k])), k
    _assert_states_close(sj, st)
    old = {k: v.clone() for k, v in mt.ops.items()}
    new_j = mj.refresh_precond(mj.ops, sj)
    new_t = mt.refresh_precond(mt.ops, st)
    assert new_t is not mt.ops and sorted(new_t) == sorted(old)
    for k, v in old.items():
        assert new_t[k].shape == v.shape and new_t[k].dtype == v.dtype, k
    assert float((new_t["visc_e"] - old["visc_e"]).abs().max()) > 0  # really updated
    keys = ["A_uu_e", "A_up_e", "A_pu_e", "visc_e", "visc_dinv", "lmax_u"]
    keys += sorted(k for k in new_t if k.startswith("sc") or k == "saddle_coarse_inv")
    assert ("saddle_coarse_inv" in keys) == (branch == "dense")
    for k in keys:
        if k != "sc2_agg":
            _assert_close(new_j[k], new_t[k], 1e-10, k)
    if "sc2_agg" in old:  # the aggregation depends on the mesh alone
        assert torch.equal(new_t["sc2_agg"], old["sc2_agg"])
    # the step after the refresh takes JAX's iteration count
    mj.ops, mt.ops = new_j, new_t
    _, sj2, auxj2 = mj.step_jit(mj.ops, sj)
    st2, aux2 = mt.step(st)
    assert aux2["inv_iters"] == int(auxj2["inv_iters"])
    assert aux2["evo_iters"] == int(auxj2["evo_iters"])
    assert aux2["inv_res"] < 1e-6
    _assert_states_close(sj2, st2)


def test_refresh_without_eddy_is_noop():
    m = _eddy3d(npt, eddy=False, dtype=torch.float64, device="cpu")
    assert not m.variable_nu and "f_eddy_q" not in m.const
    assert m.refresh_precond(m.ops, m.rest_state()) is m.ops
