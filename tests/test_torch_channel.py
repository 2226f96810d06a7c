"""The x-periodic re-entrant channel in the port against nupgcm_tpu,
in f64 on the CPU: tests/test_channel.py::test_channel_wind_driven_jet
(channel3D(0.1), uniform zonal wind, 5 BDF1 steps from rest) as a
parity test -- the same per-step iteration counts and u, p, b within
1e-9 relative from the same numpy state and element tensors -- with
that test's physical checks (a zonal jet, periodic across the seam,
x-invariant) on the port's state, through the port's point evaluator.
"""

import numpy as np
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import ops_from_numpy, state_from_numpy
from nupgcm_tpu_torch.utils.pointeval import FieldEvaluator
from torch_parity import assert_same_rcm_branch

FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


def _jet(npg, **kw):
    m3 = npg.generators.channel3D(0.1)
    params = npg.Parameters(eps=0.3, alpha=1.0, mu_rho=1.0, N2=1.0,
                            f=lambda x: 1.0 + 0 * x[1], H=lambda x: 0.5)
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=-0.05, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(m3, u_diri_tags=["bottom", "coastline"],
                        u_diri_vals=[(0, 0, 0)] * 2,
                        u_diri_masks=[(True, True, True)] * 2,
                        b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(m3, spaces)
    return npg.PGModel(fe, params, forc, npg.BDF1(t_start=0, t_stop=0.5, dt=0.1), **kw)


def test_channel_wind_driven_jet_matches_jax():
    assert_same_rcm_branch()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        mj, mt = _jet(npj), _jet(npt, dtype=torch.float64, device="cpu")
        assert mt.fe.n_inv == mj.fe.n_inv
        assert np.array_equal(mt.fe.spaces.u_space.active, mj.fe.spaces.u_space.active)
        sj = mj.rest_state()
        st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
        mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
        for i in range(5):
            _, sj, auxj = mj.step_jit(mj.ops, sj)
            st, aux = mt.step(st)
            assert aux["evo_iters"] == int(auxj["evo_iters"]), i
            assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0, i
            for f in ("u", "p", "b"):
                a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
                assert np.abs(a - b).max() <= 1e-9 * max(np.abs(a).max(), 1e-300), (i, f)
    finally:
        torch.set_num_threads(n)
    u = st.u.numpy()
    assert np.isfinite(u).all()
    assert np.abs(u[:, 0]).max() > 5 * np.abs(u[:, 1]).max()
    us = mt.fe.spaces.u_space
    ev = FieldEvaluator(mt.fe.mesh)
    pts0 = np.array([[0.001, 0.0, -0.2], [0.001, 0.1, -0.1]])
    pts1 = pts0.copy()
    pts1[:, 0] = 0.999
    u0, u1 = ev.eval(us, u, pts0), ev.eval(us, u, pts1)
    assert np.abs(u0 - u1).max() < 5e-3 * np.abs(u0).max()
    pts_mid = pts0.copy()
    pts_mid[:, 0] = 0.5
    assert np.abs(u0 - ev.eval(us, u, pts_mid)).max() < 0.05 * np.abs(u0).max()
