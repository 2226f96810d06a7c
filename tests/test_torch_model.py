"""The PyTorch port's PGModel (the slice as a whole), in f64 on the CPU.

  * hydrostatic exactness and adaptive BDF2 (ports of
    tests/test_model.py's analytic checks);
  * the bowl2D mixing run against tests/data/bowl_mixing_2d.npz in the
    FE-integral norm (bar 1e-3, as tests/test_model.py);
  * parity with nupgcm_tpu on the iterative saddle-coarse + aggregate
    (L2) branch (the production branch) and on the dense saddle-coarse
    branch: the same operators (1e-12), and from the same numpy state
    and element tensors, the same per-step iteration counts and u, p, b
    within 1e-9 relative over 3 steps.
"""

import pathlib

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import ops_from_numpy, state_from_numpy


def test_hydrostatic_exactness():
    """Constant b on a closed box: u = 0 to solver tolerance, p = z + C
    exactly representable in P1."""
    mesh = npt.generators.rect_mesh(6, 6, x0=-1, x1=1, z0=-1, z1=0)
    params = npt.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npt.Forcings(nu=1.0, kappa_h=1.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npt.SurfaceDirichletBC(0.0))
    spaces = npt.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=[], b_diri_vals=[])
    fe = npt.FEData(mesh, spaces)
    ts = npt.BDF2(t_start=0, t_stop=1, dt=1e-2)
    model = npt.PGModel(fe, params, forc, ts, dtype=torch.float64, device="cpu",
                        inv_atol=1e-10, inv_rtol=1e-12)
    st = model.invert(model.set_b(model.rest_state(), lambda x: 1.0 + 0 * x[0]))
    assert float(st.u.abs().max()) < 1e-7
    zc = spaces.p_space.dof_coords[:, 2]
    assert np.abs(st.p.numpy() - (zc + 0.5)).max() < 1e-6


def test_adaptive_bdf2_variable_step():
    """Adaptive BDF2: dt ramps up (r <= 2 per step) to the CFL cap while
    the solution tracks the exact diffusion decay."""
    mesh = npt.generators.rect_mesh(5, 10)
    params = npt.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npt.Forcings(nu=1.0, kappa_h=0.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npt.SurfaceDirichletBC(0.0))
    spaces = npt.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
    fe = npt.FEData(mesh, spaces)
    cap = 2e-3
    ts = npt.BDF2(t_start=0, t_stop=1.0, dt=cap / 16, adaptive=True,
                  CFL_factor=cap * 0.01 / fe.h_cells.min())
    model = npt.PGModel(fe, params, forc, ts, dtype=torch.float64, device="cpu")
    st = model.run(model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2])),
                   n_info=0, max_steps=40)
    assert float(st.dt) == pytest.approx(cap, rel=1e-6)
    zc = spaces.b_space.dof_coords[:, 2]
    exact = np.exp(-np.pi ** 2 * float(st.t)) * np.sin(np.pi * zc)
    assert np.abs(st.b.numpy() - exact).max() < 2e-3


def _mixing(npg, mesh, dt, **kw):
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=50 * dt, dt=dt)
    return npg.PGModel(fe, params, forc, ts, **kw)


def _fe_rel_l2(fe, vals, ref, cell_dofs, phi):
    wq = fe.geom.wq

    def norm2(v):
        fq = np.einsum("qi,ci->cq", phi, v[cell_dofs])
        return float(np.einsum("cq,cq->", wq, fq ** 2))

    if vals.ndim == 2:
        return (sum(norm2(vals[:, k] - ref[:, k]) for k in range(3))
                / sum(norm2(ref[:, k]) for k in range(3)))
    return norm2(vals - ref) / norm2(ref)


def test_bowl_mixing_golden():
    """The reference bowl-mixing configuration (reference
    test/bowl_mixing_tests.jl:16-44) run as tests/test_model.py runs it,
    to t_stop = 50 dt, against the committed golden.  t accumulates to
    just below t_stop after 50 steps, so the run (and the golden, at
    t = 5.1) takes 51."""
    ref = np.load(pathlib.Path(__file__).parent / "data" / "bowl_mixing_2d.npz")
    dt = 1e-4 * 1e1 / (0.5 * 2e-1) ** 2
    model = _mixing(npt, npt.generators.bowl2D(0.1, 0.5), dt, dtype=torch.float64,
                    device="cpu")
    st = model.run(model.rest_state(), n_info=0)
    assert st.step == 51 and float(st.t) == pytest.approx(float(ref["t"]), rel=1e-14)
    fe = model.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref_b = bs.from_original_order(ref["b"])
    ref_u = np.stack([us.from_original_order(ref["u"].reshape(-1, 3)[:, k])
                      for k in range(3)], axis=1)
    b, u = st.b.numpy(), st.u.numpy()
    assert np.isfinite(u).all() and np.isfinite(b).all()
    assert np.abs(b[bs.tagged_dofs(["surface"])]).max() < 1e-14
    assert _fe_rel_l2(fe, b, ref_b, fe.cd_b, fe.tab_b.phi) < 1e-3
    assert _fe_rel_l2(fe, u, ref_u, fe.cd_u, fe.tab_u.phi) < 1e-3


BRANCHES = {
    # coarse_dense_max=256 forces the iterative saddle-coarse + L2
    # branch on a small mesh (as test_model.py's
    # test_saddle_coarse_l2_aggregate_level); the default takes the
    # dense coarse inverse there
    "iterative saddle coarse + L2 aggregate level": (0.25, 4, dict(coarse_dense_max=256)),
    "dense saddle coarse": (0.35, 3, {}),
}


@pytest.fixture(scope="module", params=list(BRANCHES), ids=["iterative_l2", "dense"])
def pair(request):
    """Both packages on the same bowl3D mixing configuration."""
    h, nz, kw = BRANCHES[request.param]
    mj = _mixing(npj, npj.generators.bowl3D(h, 0.5, nz=nz), 0.05, **kw)
    mt = _mixing(npt, npt.generators.bowl3D(h, 0.5, nz=nz), 0.05,
                 dtype=torch.float64, device="cpu", **kw)
    return request.param, mj, mt


def test_branch_options_and_operators_match(pair):
    branch, mj, mt = pair
    assert mt.preconditioner_branch == branch
    for k in ("saddle_coarse", "saddle_coarse_dense", "saddle_coarse_l2", "twogrid",
              "inner_method", "saddle_coarse_inner", "inner_iters", "inv_opts",
              "evo_opts"):
        assert getattr(mt, k) == getattr(mj, k), k
    assert sorted(mt.ops) == sorted(mj.ops)
    for k, v in mj.ops.items():
        a, b = np.asarray(v), mt.ops[k].numpy()
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(a).max(), 1e-300), k


def test_branch_steps_match(pair):
    """From the same numpy state and element tensors: the same
    per-step iteration counts and u, p, b within 1e-9 relative."""
    _, mj, mt = pair
    bic = lambda x: 0.1 * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)
    sj = mj.set_b(mj.rest_state(), bic)
    fields = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in fields}, "cpu")
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    for _ in range(3):
        _, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"]) > 0
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0
        for f in ("u", "p", "b"):
            a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
            assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), f
    assert st.step == int(sj.step) == 3
    assert float(st.t) == pytest.approx(float(sj.t), rel=1e-15)


def test_default_device_is_the_card(monkeypatch):
    """PGModel runs on the card unless the caller asks for the CPU; with
    no CUDA device it raises instead of falling back."""
    import inspect

    from nupgcm_tpu_torch.ops import build

    assert inspect.signature(npt.PGModel).parameters["device"].default == "cuda"
    mesh = npt.generators.rect_mesh(2, 2)
    spaces = npt.Spaces(mesh, u_diri_tags=["boundary"], u_diri_masks=[(True,) * 3])
    fe = npt.FEData(mesh, spaces)
    params = npt.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npt.Forcings(nu=1.0, kappa_h=1.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npt.SurfaceDirichletBC(0.0))
    ts = npt.BDF1(t_start=0, t_stop=1, dt=0.1)
    monkeypatch.setattr(build, "load", lambda: None)  # as if nvcc had built them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        npt.PGModel(fe, params, forc, ts)
    assert npt.PGModel(fe, params, forc, ts, device="cpu").device.type == "cpu"
