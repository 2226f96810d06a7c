"""The preconditioner follows each eddy rebuild (``PGModel(...,
refresh_on_rebuild=True)``, the default), on the CPU.

  * the stall and its repair on the full-physics bowl (convection, eddy
    closure, wind, adaptive BDF1, the inner GMRES smoother, tolerances
    1e-7/1e-8, the dense saddle coarse level) at h = 0.25, in f64: on the
    preconditioner built for the old viscosity FGMRES goes from 10 to
    77, 51, 50, ... after the step-10 rebuild; rebuilt with it, to 32,
    20, 20, ... (the new viscosity's own count: a model whose
    preconditioner and blocks hold the eddy viscosity from the start
    takes 15 a step, and 31, 21, 21 after the same rebuild);
  * a default step equals a step with the option off followed by
    ``refresh_precond`` from the same state, bit for bit, with the
    element tensors kept in place;
  * the default ``run`` equals the JAX package's ``run(...,
    n_precond_refresh=10)``, whose refresh after step 10 rebuilds the
    same viscosity;
  * the aux's rebuild keys and the registry's counters.
"""

import re

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import AUX_KEYS, REBUILD_KEYS, State
from nupgcm_tpu_torch.utils import timing

ALPHA = 0.5


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _depth(x):
    return ALPHA * (1 - x[0] ** 2 - x[1] ** 2)


def _b0(x):
    """A bottom-intensified anomaly plus a plane wave (the benchmark's
    closures traffic, one draw of its direction and phase)."""
    d = x[2] + _depth(x)
    return 0.1 * np.exp(-d / 0.05) + 0.01 * np.exp(-d / 0.1) * np.sin(
        2 * np.pi * (np.cos(1.0) * x[0] + np.sin(1.0) * x[1]) + 0.5)


def _full(refresh_on_rebuild=True, h=0.25, **kw):
    """The full-physics bowl (pgbench/configs/bowl_full_54k.json's physics
    and solver) on bowl3D(h, 0.5, nz=3), f64 on the CPU."""
    npg = npt
    f = lambda x: 1.0 + 0.5 * x[1]
    kap = lambda x: 1e-2 + np.exp(-(x[2] + _depth(x)) / (0.1 * ALPHA))
    mesh = npg.generators.bowl3D(h, ALPHA, nz=3)
    params = npg.Parameters(eps=0.2, alpha=ALPHA, mu_rho=10.0, N2=2.0, f=f, H=_depth)
    forc = npg.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=lambda x: -0.1 * np.cos(np.pi / 2 * x[1]),
        tau_y=0.0, b_surface_bc=npg.SurfaceDirichletBC(0.0),
        conv_param=npg.ConvectionParameterization(kappa_c=10.0, N2_min=1e-3),
        eddy_param=npg.EddyParameterization(f=f, N2_min=float(np.sqrt(1e-3)), smoothing=10.0,
                                            nu_min=1.0))
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF1(t_start=0, t_stop=1e9, dt=0.1, adaptive=True, CFL_factor=0.5)
    return npg.PGModel(fe, params, forc, ts, dtype=torch.float64, device="cpu",
                       inv_atol=1e-7, inv_rtol=1e-7, evo_atol=1e-8, evo_rtol=1e-8,
                       inner_method="inner_gmres", refresh_on_rebuild=refresh_on_rebuild, **kw)


def _at_step(m, k):
    """The start state, numbered as step ``k``: the next step that ends on
    a multiple of 10 rebuilds."""
    s = m.set_b(m.rest_state(), _b0)
    return State(u=s.u, p=s.p, b=s.b, u_prev=s.u_prev, b_prev=s.b_prev, t=s.t, dt=s.dt, step=k)


def _iters(m, st, n):
    its = []
    for _ in range(n):
        st, aux = m.step(st)
        its.append(aux["inv_iters"])
    return st, its


# ----------------------------------------------------------------------
# (a) the stall, and the preconditioner that follows the viscosity
# ----------------------------------------------------------------------

def test_frozen_preconditioner_stalls_and_the_rebuilt_one_does_not():
    frozen, rebuilt = _full(False), _full(True)
    assert frozen.preconditioner_branch == "dense saddle coarse"
    assert frozen.inner_method == "inner_gmres"
    st0 = frozen.set_b(frozen.rest_state(), _b0)
    # steps 1-13: the same 10 steps on either model, then the rebuild
    _, its_f = _iters(frozen, st0, 13)
    _, its_r = _iters(rebuilt, st0, 23)
    assert its_f[:10] == its_r[:10]
    before = its_f[9]
    # the reference's frozen preconditioner: four times the iterations
    # and more on every step after the rebuild (10 -> 77, 51, 50)
    assert min(its_f[10:13]) >= 4 * before, its_f
    # rebuilt with the viscosity: half the frozen count or less after the
    # rebuild, then level at the new viscosity's own count
    assert all(2 * r <= f for r, f in zip(its_r[10:13], its_f[10:13])), (its_r, its_f)
    level = its_r[19]                        # before the step-20 rebuild
    assert max(abs(i - level) for i in its_r[11:19]) <= 3, its_r
    # after the step-20 rebuild, from a preconditioner that fitted its
    # viscosity: within 3 of the count before it, past the first step
    assert max(abs(i - level) for i in its_r[21:23]) <= 3, its_r
    assert its_r[20] < 2 * level, its_r


# ----------------------------------------------------------------------
# (b) the in-step rebuild is refresh_precond, in place
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(coarse_dense_max=256)], ids=["dense", "iterative_l2"])
def test_step_rebuild_equals_refresh_precond(kw):
    on, off = _full(True, **kw), _full(False, **kw)
    st = _at_step(on, 9)
    ptrs = {k: v.data_ptr() for k, v in on.ops.items()
            if torch.is_tensor(v) and v.dim() == 3}          # the element tensors
    assert {"A_uu_e", "visc_e"} <= set(ptrs)
    if kw:
        assert {"sc_uu", "sc_visc_e"} <= set(ptrs)
    s_on, aux_on = on.step(st)
    s_off, aux_off = off.step(st)
    assert aux_on["rebuilt"] == aux_off["rebuilt"] == 1.0
    off.ops = off.refresh_precond(off.ops, s_off)
    for k in ("u", "p", "b"):
        assert torch.equal(getattr(s_on, k), getattr(s_off, k)), k
    assert sorted(on.ops) == sorted(off.ops)
    for k, v in on.ops.items():
        assert (torch.equal(v, off.ops[k]) if torch.is_tensor(v) else v == off.ops[k]), k
    for k, op in on._held.items():
        assert torch.equal(op.vals, off._held[k].vals), k
    for k, p in ptrs.items():                                # one copy in memory
        assert on.ops[k].data_ptr() == p, k
    # and the next step takes the same iterations to the same state
    s2_on, a2_on = on.step(s_on)
    s2_off, a2_off = off.step(s_off)
    assert a2_on["inv_iters"] == a2_off["inv_iters"]
    assert torch.equal(s2_on.u, s2_off.u)


# ----------------------------------------------------------------------
# (c) against the JAX package's refresh after the rebuild
# ----------------------------------------------------------------------

def _eddy3d(npg, **kw):
    """tests/test_torch_refresh.py's bowl (bowl3D(0.35, nz=3), eddy
    closure, BDF2), on the dense saddle coarse level."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    mesh = npg.generators.bowl3D(0.35, alpha, nz=3)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0),
                        eddy_param=npg.EddyParameterization(f=lambda x: 1.0 + 0.5 * x[1],
                                                            N2_min=float(np.sqrt(1e-3))))
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=1e-2)
    return npg.PGModel(fe, params, forc, ts, inv_atol=1e-7, inv_rtol=1e-7, **kw)


def _counts(log):
    return [tuple(map(int, re.search(r"evo_it = (\d+), inv_it = (\d+)", m).groups()))
            for m in log]


def test_default_run_matches_jax_refresh_after_the_rebuild():
    mj = _eddy3d(npj)
    mt = _eddy3d(npt, dtype=torch.float64, device="cpu")
    assert mt.refresh_on_rebuild and mt.preconditioner_branch == "dense saddle coarse"
    ic = lambda x: 0.1 * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)
    log_j, log_t = [], []
    sj = mj.run(mj.set_b(mj.rest_state(), ic), n_info=1, max_steps=12, n_precond_refresh=10,
                log=log_j.append)
    st = mt.run(mt.set_b(mt.rest_state(), ic), n_info=1, max_steps=12, log=log_t.append)
    assert len(log_t) == 12 and _counts(log_t) == _counts(log_j)
    # the rebuilt preconditioner is what brings the count down: the
    # frozen one takes more after the rebuild
    frozen = _eddy3d(npt, dtype=torch.float64, device="cpu", refresh_on_rebuild=False)
    log_f = []
    frozen.run(frozen.set_b(frozen.rest_state(), ic), n_info=1, max_steps=12, log=log_f.append)
    assert sum(i for _, i in _counts(log_f)[10:]) > sum(i for _, i in _counts(log_t)[10:])
    for f in ("u", "p", "b"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max(), f
    assert st.step == int(sj.step) == 12
    for k in ("visc_e", "visc_dinv", "lmax_u", "saddle_coarse_inv"):
        a, b = np.asarray(mj.ops[k]), mt.ops[k].numpy()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max(), k


# ----------------------------------------------------------------------
# (d) what the step reports
# ----------------------------------------------------------------------

def test_aux_rebuild_keys_and_counters():
    m = _full(True, h=0.35)
    st = _at_step(m, 8)
    timing.reset()
    timing.set_timing(True)
    try:
        auxs = []
        for _ in range(3):                   # steps 9, 10 (a rebuild), 11
            st, aux = m.step(st)
            auxs.append(aux)
        counts = timing.snapshot()["counts"]
        spans = timing.snapshot()["spans"]
    finally:
        timing.set_timing(False)
        timing.reset()
    assert [a["rebuilt"] for a in auxs] == [0.0, 1.0, 0.0]
    assert auxs[0]["rebuild_s"] == auxs[2]["rebuild_s"] == 0.0 < auxs[1]["rebuild_s"]
    assert set(REBUILD_KEYS) <= set(auxs[0]) and not set(REBUILD_KEYS) & set(AUX_KEYS)
    assert counts["closures.rebuild"] == counts["precond.refresh"] == 1
    assert spans["refresh"]["n"] == 1
    # refresh_precond counts both as well
    timing.set_timing(True)
    try:
        m.ops = m.refresh_precond(m.ops, st)
        counts = timing.snapshot()["counts"]
    finally:
        timing.set_timing(False)
        timing.reset()
    assert counts["closures.rebuild"] == counts["precond.refresh"] == 1
    # multi_step stacks the JAX step's keys alone
    _, stacked = m.multi_step(st, 2)
    assert set(stacked) == set(AUX_KEYS)
    # the option off: the rebuild is reported, and no preconditioner rebuilt
    off = _full(False, h=0.35)
    visc = off.ops["visc_e"].clone()
    _, aux = off.step(_at_step(off, 9))
    assert aux["rebuilt"] == 1.0 and aux["rebuild_s"] > 0.0
    assert torch.equal(off.ops["visc_e"], visc)
