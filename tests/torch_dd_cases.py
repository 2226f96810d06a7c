"""Shared set-up of the domain-decomposition parity tests
(tests/test_torch_dd*.py): tests/test_parallel.py's bowl configurations
in either package (the port in f64 on the CPU)."""

import numpy as np
import torch

import nupgcm_tpu_torch as npt

ALPHA, EPS, MU = 0.5, 2e-1, 1e1
TIGHT = dict(inv_atol=1e-11, inv_rtol=1e-11, evo_atol=1e-13, evo_rtol=1e-13, inv_itmax=800)
NO_COARSE = dict(TIGHT, saddle_coarse=False, twogrid=False, inner_method="chebyshev",
                 inner_iters_u=10)
BOWL_DT = 1e-4 * MU / (ALPHA * EPS) ** 2


def kap(x):
    return 1e-2 + np.exp(-(x[2] + ALPHA * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * ALPHA))


def bic(x):
    return -0.05 * np.exp((x[2] - ALPHA * (1 - x[0] ** 2 - x[1] ** 2)) / (0.3 * ALPHA))


def bowl(npg, mesh, ts, kw, b_surface=0.0, **forc):
    """tests/test_parallel.py's bowl configuration on ``mesh`` in
    package ``npg`` (the port in f64 on the CPU)."""
    params = npg.Parameters(eps=EPS, alpha=ALPHA, mu_rho=MU, N2=1 / ALPHA,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: ALPHA * (1 - x[0] ** 2 - x[1] ** 2))
    base = dict(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                b_surface_bc=npg.SurfaceDirichletBC(b_surface))
    base.update(forc)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, b_surface])
    fe = npg.FEData(mesh, spaces)
    if npg is npt:
        kw = dict(kw, dtype=torch.float64, device="cpu")
    return npg.PGModel(fe, params, npg.Forcings(**base), ts(npg), **kw)


def bdf2(dt=BOWL_DT, **kw):
    return lambda npg: npg.BDF2(t_start=0, t_stop=1, dt=dt, **kw)


def eddy(npg):
    return dict(kappa_h=1e-2, kappa_v=1e-2,
                eddy_param=npg.EddyParameterization(f=lambda x: 1.0 + 0.5 * x[1], N2_min=1e-2))


def pair(mesh_fn, ts, kw, **forc):
    """(single-device port model, DD port model) on one mesh."""
    mesh = mesh_fn(npt)
    return bowl(npt, mesh, ts, kw, **forc), bowl(npt, mesh, ts, kw, **forc)


def eddy_pair():
    return pair(lambda npg: npg.generators.bowl2D(0.15, ALPHA), bdf2(), TIGHT, **eddy(npt))


def bowl015(npg, forc=None, **kw):
    return bowl(npg, npg.generators.bowl2D(0.15, ALPHA),
                lambda n: n.BDF2(t_start=0, t_stop=10 * BOWL_DT, dt=BOWL_DT), kw,
                **(forc or {}))


def maxdiff(a, b, f):
    return float(np.abs(np.asarray(getattr(a, f)) - np.asarray(getattr(b, f))).max())


def state_np(s):
    return {f: np.asarray(getattr(s, f)) for f in ("u", "p", "b", "u_prev", "b_prev")}
