"""The port's production and north-star configurations against
nupgcm_tpu, in f64 on the CPU:

  * the four channel-basin generators at h = 0.1, alpha = 0.2: the same
    vertices, cells, tags and periodic pairs; quality_report agrees;
  * tools.production.build_model(0.2) (484 tets, P1 buoyancy, both
    closures, adaptive BDF1): equal dof counts, free masks, solver
    options and inner_method, and 3 steps within 1e-10 relative with
    equal iteration counts;
  * the same at h = 0.2 on the branch the tool takes from h = 0.04 on
    (iterative coarse + aggregate level): the same stalled FGMRES;
  * tools.northstar.build_model("full"): the same parameters, solver
    options and forcings at quadrature points (on a coarse bowl patched
    in for the tool's h = 0.1 mesh).

Run as a script, it writes tests/data/bowl3d_full_30.npz, the golden of
the north-star full-physics configuration: nupgcm_tpu on the CPU in
f64, the tool's own generated mesh, run(max_steps=30,
n_precond_refresh=10) (eddy rebuilds inside steps 10, 20 and 30, each
followed by a preconditioner refresh), u and b in mesh-canonical dof
order.  With ``counts f32`` or ``counts f64`` it prints nupgcm_tpu's
per-step solver counts of the same configuration over its first 25
steps with no refresh instead: FGMRES reaches its cap of 500 after the
step-20 rebuild, on the preconditioner of the build-time viscosity.
With ``lockstep`` it runs the golden's recipe through both packages in
f64 side by side and prints, per step, both iteration counts and the
relative max difference of b, u and t (the solves agree to their
tolerance, and the closures amplify that)::

    python tests/test_torch_production.py [counts f32|f64 | lockstep]
"""

import pathlib

import numpy as np
import pytest
import torch

GOLDEN = pathlib.Path(__file__).parent / "data" / "bowl3d_full_30.npz"
FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _packages():
    import nupgcm_tpu as npj
    import nupgcm_tpu_torch as npt

    return npj, npt


# ----------------------------------------------------------------------
# mesh generators and quality
# ----------------------------------------------------------------------

GENERATORS = ("channel_basin", "channel_basin_flat", "channel_basin_no_flat",
              "channel_basin_no_flat_round_end")


@pytest.mark.parametrize("name", GENERATORS)
def test_channel_basin_generators_match(name):
    npj, npt = _packages()
    mj = getattr(npj.generators, name)(0.1, alpha=0.2)
    mt = getattr(npt.generators, name)(0.1, alpha=0.2)
    assert mt.n_cells > 1000 and mt.periodic_pairs is not None
    assert np.array_equal(mj.coords, mt.coords)
    assert np.array_equal(mj.cells, mt.cells)
    assert np.array_equal(mj.periodic_pairs, mt.periodic_pairs)
    assert sorted(mj.tagged) == sorted(mt.tagged)
    for tag, by_dim in mj.tagged.items():
        assert sorted(by_dim) == sorted(mt.tagged[tag]), tag
        for d, ents in by_dim.items():
            assert np.array_equal(ents, mt.tagged[tag][d]), (tag, d)


def test_quality_report_matches():
    npj, npt = _packages()
    from nupgcm_tpu.mesh.quality import quality_report as qj
    from nupgcm_tpu_torch.mesh.quality import quality_report as qt

    for mesh in (npt.generators.channel_basin_no_flat_round_end(0.2),
                 npt.generators.bowl2D(0.2, 0.5)):
        a, b = qj(mesh), qt(mesh)
        assert a == b
        assert b["angles"]["min"] > 0 and b["volumes"]["min"] > 0


# ----------------------------------------------------------------------
# production.build_model
# ----------------------------------------------------------------------

def test_production_build_and_steps_match():
    from nupgcm_tpu.tools import production as pj

    from nupgcm_tpu_torch.models.model import state_from_numpy
    from nupgcm_tpu_torch.tools import production as pt

    mj, mesh_j, dims_j = pj.build_model(0.2)
    mt, mesh_t, dims_t = pt.build_model(0.2, dtype=torch.float64, device="cpu")
    assert dims_j == dims_t
    assert mesh_t.n_cells == mesh_j.n_cells == 484
    fj, ft = mj.fe, mt.fe
    assert (ft.spaces.n_u, ft.spaces.n_p, ft.spaces.n_b, ft.n_inv) == (
        fj.spaces.n_u, fj.spaces.n_p, fj.spaces.n_b, fj.n_inv)
    assert ft.spaces.b_order == 1
    for k in ("free_u", "free_b", "free_inv", "bdiri", "tg_coarse_free"):
        assert np.array_equal(np.asarray(mj.const[k]), mt.const[k].numpy()), k
    for k in ("inner_method", "saddle_coarse_dense", "saddle_coarse_l2",
              "saddle_coarse_inner", "inner_iters", "inv_opts", "evo_opts", "variable_nu"):
        assert getattr(mt, k) == getattr(mj, k), k
    assert mt.preconditioner_branch == "dense saddle coarse"
    sj = mj.rest_state()
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    for _ in range(3):
        mj.ops, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"]) > 0
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0
    for f in ("u", "p", "b"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert np.isfinite(b).all()
        assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max(), f
    assert float(st.t) == pytest.approx(float(sj.t), rel=1e-13)
    assert float(st.dt) == pytest.approx(float(sj.dt), rel=1e-13)


def test_production_aggregate_branch_matches():
    """The branch the tool takes from h = 0.04 on (iterative saddle
    coarse + aggregate level, Chebyshev smoothing, the cycle applied
    once as the coarse solve), forced at h = 0.2 by a small
    coarse_dense_max.  On this mesh FGMRES stalls in both packages (its
    residual stays near 0.3 of the initial one); the port follows the
    reference's stalled iteration: the same residual to 1e-9 relative
    and the same state after 60 iterations per step."""
    from nupgcm_tpu.tools import production as pj

    from nupgcm_tpu_torch.models.model import state_from_numpy
    from nupgcm_tpu_torch.tools import production as pt

    kw = dict(coarse_dense_max=64, inner_method="chebyshev")
    mj, _, _ = pj.build_model(0.2, **kw)
    mt, _, _ = pt.build_model(0.2, dtype=torch.float64, device="cpu", **kw)
    assert mt.preconditioner_branch == "iterative saddle coarse + L2 aggregate level"
    assert (mt.saddle_coarse_inner, mt.saddle_coarse_l2) == (
        mj.saddle_coarse_inner, mj.saddle_coarse_l2) == (0, True)
    mj.inv_opts["itmax"] = mt.inv_opts["itmax"] = 60
    sj = mj.rest_state()
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    for _ in range(2):
        mj.ops, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"])
        assert aux["inv_iters"] == int(auxj["inv_iters"]) == 60
        assert aux["inv_res"] == pytest.approx(float(auxj["inv_res"]), rel=1e-9)
        assert aux["inv_res"] > 0.1  # the stall
    for f in ("u", "p", "b"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        assert np.abs(a - b).max() <= 1e-8 * np.abs(a).max(), f


# ----------------------------------------------------------------------
# northstar.build_model("full")
# ----------------------------------------------------------------------

def test_northstar_full_configuration_matches(monkeypatch):
    npj, npt = _packages()
    from nupgcm_tpu.tools import northstar as nj

    from nupgcm_tpu_torch.tools import northstar as nt

    bowl_j = npj.generators.bowl3D
    monkeypatch.setattr(npj.generators, "bowl3D", lambda h, a, nz: bowl_j(0.35, a, nz=3))
    monkeypatch.setattr(nt, "reference_mesh",
                        lambda: (npt.generators.bowl3D(0.35, 0.5, nz=3), "coarse bowl3D"))
    mj, _ = nj.build_model("full")
    mt, _ = nt.build_model("full", dtype=torch.float64, device="cpu")
    assert mt.fe.mesh.n_cells == mj.fe.mesh.n_cells
    for k in ("eps", "alpha", "mu_rho", "N2", "a2e2"):
        assert getattr(mt.params, k) == getattr(mj.params, k), k
    for k in ("kappa_c", "N2_min", "is_on"):
        assert getattr(mt.forcings.conv_param, k) == getattr(mj.forcings.conv_param, k), k
    for k in ("N2_min", "is_on", "smoothing", "nu_min"):
        assert getattr(mt.forcings.eddy_param, k) == getattr(mj.forcings.eddy_param, k), k
    assert (type(mt.ts).__name__, mt.ts.dt, mt.ts.adaptive, mt.ts.CFL_factor) == (
        type(mj.ts).__name__, mj.ts.dt, mj.ts.adaptive, mj.ts.CFL_factor)
    for k in ("inner_method", "inv_opts", "evo_opts", "variable_nu", "saddle_coarse_inner",
              "inner_iters"):
        assert getattr(mt, k) == getattr(mj, k), k
    assert mt.inner_method == "inner_gmres"
    for k in ("f_q", "nu_q", "kh_q", "kv_q", "f_eddy_q", "taux_q", "tauy_q", "bdiri",
              "free_u", "free_b"):
        a, b = np.asarray(mj.const[k]), mt.const[k].numpy()
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-14 * max(np.abs(a).max(), 1.0), k
    assert float(np.abs(np.asarray(mj.const["taux_q"])).max()) > 0.05  # wind is on


@pytest.mark.parametrize("tool", ("production", "northstar"))
def test_tool_main_needs_cuda(tool, monkeypatch):
    """The tools measure the card: off it, main() raises."""
    import importlib

    monkeypatch.setattr("sys.argv", [tool])
    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module(f"nupgcm_tpu_torch.tools.{tool}").main()


def make_golden(path=GOLDEN):
    """nupgcm_tpu's north-star full-physics run on the CPU in f64: 30
    adaptive BDF1 steps, an eddy rebuild and then a refresh at 10, 20
    and 30, saved in mesh-canonical dof order."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from nupgcm_tpu.tools import northstar as nj

    model, mesh_src = nj.build_model("full")
    state = model.run(model.rest_state(), n_info=10, max_steps=30, n_precond_refresh=10)
    fe = model.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    u = np.asarray(state.u)
    np.savez_compressed(
        path, u=np.stack([us.to_original_order(u[:, c]) for c in range(3)], axis=1),
        b=bs.to_original_order(np.asarray(state.b)), t=float(state.t),
        steps=int(state.step))
    print(f"{mesh_src}: {fe.mesh.n_cells} cells; t = {float(state.t)!r} after "
          f"{int(state.step)} steps -> {path}")


def jax_counts(dtype, n=25):
    """nupgcm_tpu's north-star full-physics configuration on the CPU in
    ``dtype`` ("f32" or "f64"): per-step solver counts and FGMRES
    residual over ``n`` steps with no refresh."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from nupgcm_tpu.models.model import PGModel
    from nupgcm_tpu.tools import northstar as nj

    m, _ = nj.build_model("full")
    if dtype == "f32":
        m = PGModel(m.fe, m.params, m.forcings, m.ts, dtype=jnp.float32, inv_atol=1e-7,
                    inv_rtol=1e-7, evo_atol=1e-8, evo_rtol=1e-8, inner_method="inner_gmres")
    st = m.rest_state()
    for i in range(n):
        m.ops, st, a = m.step_jit(m.ops, st)
        print(f"{dtype} step {i + 1}: evo_iters {int(a['evo_iters'])} inv_iters "
              f"{int(a['inv_iters'])} inv_res {float(a['inv_res']):.3g}", flush=True)


def lockstep(n=30):
    """The golden's recipe through nupgcm_tpu and the port side by side
    on the CPU in f64: per step, both packages' iteration counts and the
    relative max difference of b and u and the difference of t."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from nupgcm_tpu.tools import northstar as nj

    from nupgcm_tpu_torch.models.model import state_from_numpy
    from nupgcm_tpu_torch.tools import northstar as nt

    mj, _ = nj.build_model("full")
    mt, _ = nt.build_model("full", dtype=torch.float64, device="cpu")
    sj = mj.rest_state()
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")

    def rel(a, b):
        a = np.asarray(a)
        return np.abs(a - b.numpy()).max() / np.abs(a).max()

    for i in range(1, n + 1):
        mj.ops, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        print(f"step {i}: evo {int(auxj['evo_iters'])} / {aux['evo_iters']}, inv "
              f"{int(auxj['inv_iters'])} / {aux['inv_iters']}; max|db|/max|b| "
              f"{rel(sj.b, st.b):.2e}, max|du|/max|u| {rel(sj.u, st.u):.2e}, "
              f"t differs by {abs(float(sj.t) - float(st.t)):.2e}", flush=True)
        if i % 10 == 0:
            mj.ops = mj.refresh_precond(mj.ops, sj)
            mt.ops = mt.refresh_precond(mt.ops, st)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    if sys.argv[1:2] == ["counts"]:
        jax_counts(sys.argv[2])
    elif sys.argv[1:] == ["lockstep"]:
        lockstep()
    else:
        make_golden()
