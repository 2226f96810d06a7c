"""The port on the sphere mesh (f = z, closed rotating ball) against
nupgcm_tpu and tests/test_sphere.py, in f64 on the CPU:

  * sphere_mesh geometry (a port of test_sphere_mesh_geometry);
  * 10 BDF2 steps of the buoyant blob: stable, bounded b, converged
    solves (test_sphere_run_stability), and within 1e-3 FE-integral
    relative L2 of tests/data/sphere_n4_10.npz in u and b;
  * the azimuthal / meridional flow ratio grows as the Ekman number
    falls (test_sphere_inversion_rotational_structure);
  * parity in the sphere example's configuration (eps = 0.1, dt = 2e-3,
    the equatorial start; in test_sphere.py's the evolution residual
    starts below its tolerance and steps 2-3 take no iteration): from
    the same numpy state and element tensors, 3 steps with the same
    iteration counts and u, p, b within 1e-9 relative.

Run as a script with ``golden``, it writes tests/data/sphere_n4_10.npz:
nupgcm_tpu on the CPU in f64, sphere_mesh(4) with test_sphere.py's
configuration (eps = 0.2, dt = 1e-3, BDF2, the blob start),
run(max_steps=10), u and b in mesh-canonical dof order::

    python tests/test_torch_sphere.py golden
"""

import pathlib

import numpy as np
import pytest
import torch

GOLDEN = pathlib.Path(__file__).parent / "data" / "sphere_n4_10.npz"
FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_model(eps=0.2, dt=1e-3):
    """tests/test_sphere.py's configuration in nupgcm_tpu (``eps``,
    ``dt``: the sphere example's 0.1, 2e-3)."""
    import nupgcm_tpu as npg

    mesh = npg.generators.sphere_mesh(4)
    params = npg.Parameters(eps=eps, alpha=1.0, mu_rho=1.0, N2=1.0,
                            f=lambda x: x[2], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"], u_diri_vals=[(0, 0, 0)],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["surface"], b_diri_vals=[0.0])
    fe = npg.FEData(mesh, spaces)
    return npg.PGModel(fe, params, forc, npg.BDF2(t_start=0, t_stop=1e9, dt=dt))


def port_model(eps=0.2, dt=1e-3, **kw):
    """The same configuration in the port (the sphere example's model)."""
    import nupgcm_tpu_torch as npt
    from nupgcm_tpu_torch.examples import sphere

    kw = {"dtype": torch.float64, "device": "cpu", **kw}
    return sphere.build_model(npt.generators.sphere_mesh(4), eps=eps, dt=dt, **kw)


def fe_rel_l2(fe, vals, ref, cd, phi):
    """FE-integral relative L2 (squared-norm ratio), as tests/_helpers.py."""
    from nupgcm_tpu_torch.tools.northstar import rel_l2

    return rel_l2(fe, vals, ref, cd, phi)


def golden_errors(model, state, path=GOLDEN):
    """(rel-L2 of u, of b) of ``state`` against the golden, in the
    golden's mesh-canonical order mapped to the model's dofs."""
    ref = np.load(path)
    fe = model.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref_u = np.stack([us.from_original_order(ref["u"][:, c]) for c in range(3)], axis=1)
    ref_b = bs.from_original_order(ref["b"])
    u, b = state.u.double().cpu().numpy(), state.b.double().cpu().numpy()
    return (fe_rel_l2(fe, u, ref_u, fe.cd_u, fe.tab_u.phi),
            fe_rel_l2(fe, b, ref_b, fe.cd_b, fe.tab_b.phi))


@pytest.fixture(scope="module")
def port10():
    from nupgcm_tpu_torch.examples.sphere import blob

    m = port_model()
    st = m.run(m.set_b(m.rest_state(), blob), n_info=0, max_steps=10)
    return m, st


def test_sphere_mesh_geometry():
    import nupgcm_tpu_torch as npt
    from nupgcm_tpu_torch.mesh.quality import volumes

    mesh = npt.generators.sphere_mesh(4)
    r = np.linalg.norm(mesh.coords, axis=1)
    assert r.max() <= 1.0 + 1e-12
    bnodes = np.unique(mesh.tagged["boundary"][2])
    assert np.allclose(r[bnodes], 1.0, atol=1e-12)
    vol = volumes(mesh.coords, mesh.cells).sum()
    assert abs(vol - 4.0 / 3.0 * np.pi) / (4.0 / 3.0 * np.pi) < 0.05


def test_sphere_run_stability_and_golden(port10):
    m, st = port10
    u, b = st.u.numpy(), st.b.numpy()
    assert st.step == 10
    assert np.isfinite(u).all() and np.isfinite(b).all()
    assert b.min() > -1e-3 and b.max() < 0.11
    assert 1e-4 < np.abs(u).max() < 1.0
    ref = np.load(GOLDEN)
    assert int(ref["steps"]) == 10 and float(st.t) == pytest.approx(float(ref["t"]), rel=1e-14)
    eu, eb = golden_errors(m, st)
    assert eu < 1e-3 and eb < 1e-3, (eu, eb)


def test_sphere_inversion_rotational_structure():
    def az_ratio(eps):
        m = port_model(eps)
        st = m.invert(m.set_b(m.rest_state(),
                              lambda x: 0.1 * np.exp(-(x[0] ** 2 + x[1] ** 2) / 0.2)))
        u = st.u.numpy()
        xy = np.asarray(m.fe.spaces.u_space.dof_coords)[:, :2]
        rho = np.linalg.norm(xy, axis=1)
        sel = rho > 0.3
        az = np.stack([-xy[:, 1], xy[:, 0]], axis=1) / np.maximum(rho, 1e-12)[:, None]
        u_az = (u[:, :2] * az).sum(axis=1)
        u_mer = np.linalg.norm(u[:, :2] - u_az[:, None] * az, axis=1)
        return float((u_az[sel] ** 2).sum() / (u_mer[sel] ** 2).sum())

    weak, strong = az_ratio(0.5), az_ratio(0.05)
    assert strong > 2.0 * weak


def test_sphere_steps_match_jax():
    from nupgcm_tpu_torch.examples.sphere import b0
    from nupgcm_tpu_torch.models.model import ops_from_numpy, state_from_numpy
    from torch_parity import assert_same_rcm_branch

    assert_same_rcm_branch()
    mj, mt = jax_model(0.1, 2e-3), port_model(0.1, 2e-3)
    assert mt.preconditioner_branch == "dense saddle coarse"
    assert mt.inner_method == mj.inner_method and mt.inner_iters == mj.inner_iters
    sj = mj.set_b(mj.rest_state(), b0)
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    for i in range(3):
        _, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"]) == min(i, 1), i
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0, i
        for f in ("u", "p", "b"):
            a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
            assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), (i, f)


def make_golden(path=GOLDEN):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from nupgcm_tpu_torch.examples.sphere import blob

    model = jax_model()
    state = model.run(model.set_b(model.rest_state(), blob), n_info=0, max_steps=10)
    fe = model.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    u = np.asarray(state.u)
    np.savez_compressed(
        path, u=np.stack([us.to_original_order(u[:, c]) for c in range(3)], axis=1),
        b=bs.to_original_order(np.asarray(state.b)), t=float(state.t),
        steps=int(state.step))
    print(f"sphere_mesh(4): {fe.n_inv} inversion DoF; t = {float(state.t)!r} after "
          f"{int(state.step)} steps -> {path}")


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    if sys.argv[1:] == ["golden"]:
        make_golden()
    else:
        sys.exit("usage: python tests/test_torch_sphere.py golden")
