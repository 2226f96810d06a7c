"""Element-matvec kernels of the PyTorch port (nupgcm_tpu_torch/ops/kernels.py)
against the JAX package's.

On the CPU the port's wrappers run their plain versions; those are held
against the JAX Pallas kernels (ops/window.py, in interpret mode exactly
as tests/test_window.py runs them) and against the JAX take-path
SaddleOperator / ElementOperator, on the same random element tensors and
vectors.  Bars: f64 1e-12 max|y| (summation order), f32 2e-6 max|y|
(the bar of tests/test_window.py).  The CUDA kernels themselves run only
on the card (chip_smoke.py phase 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.ops import window as W
from nupgcm_tpu.ops.element import ElementOperator, SaddleOperator
from nupgcm_tpu_torch.ops import build
from nupgcm_tpu_torch.ops import kernels as K

BARS = {"float64": 1e-12, "float32": 2e-6}


@pytest.fixture(scope="module")
def fe():
    mesh = npj.generators.bowl3D(0.35, 0.5, nz=3)
    spaces = npj.Spaces(mesh, u_diri_tags=[], u_diri_vals=[],
                        b_diri_tags=[], b_diri_vals=[])
    return npj.FEData(mesh, spaces)


@pytest.fixture
def interpret():
    W._INTERPRET = True
    yield
    W._INTERPRET = False


def _case(fe, mode, dtype, seed):
    """Random blocks, dof tables, sizes and x for one saddle mode.
    "full"/"uu"/"up" use the P2-P1 plan, "full_pp" the P1-P1 vertex plan."""
    rng = np.random.default_rng(seed)
    sp = fe.spaces
    nc = fe.n_cells_padded
    if mode == "full_pp":
        cd_u, cd_p, n, n_p = fe.cd_p, fe.cd_p, sp.n_p, sp.n_p
    else:
        cd_u, cd_p, n, n_p = fe.cd_u, fe.cd_p, sp.u_space.ndof, sp.n_p
    nlu, nlp = cd_u.shape[1], cd_p.shape[1]
    T = {k: rng.standard_normal(s).astype(dtype) for k, s in {
        "uu": (nc, 3 * nlu, 3 * nlu), "up": (nc, 3 * nlu, nlp),
        "pu": (nc, nlp, 3 * nlu), "pp": (nc, nlp, nlp)}.items()}
    n_x = {"full": 3 * n + n_p, "full_pp": 3 * n + n_p, "uu": 3 * n, "up": n_p}[mode]
    x = rng.standard_normal(n_x).astype(dtype)
    return T, cd_u, cd_p, n, n_p, x


def _port_saddle(T, cd_u, cd_p, n, x, mode):
    t = {k: torch.from_numpy(v) for k, v in T.items()}
    used = {"full": "uu up pu", "full_pp": "uu up pu pp", "uu": "uu", "up": "up"}[mode]
    blocks = [t[k] if k in used.split() else None for k in ("uu", "up", "pu", "pp")]
    y = K.saddle_matvec(*blocks, torch.from_numpy(cd_u.astype(np.int32)),
                        torch.from_numpy(cd_p.astype(np.int32)),
                        torch.from_numpy(x), mode, n)
    return y.numpy()


def _jax_take_saddle(fe, T, cd_u, cd_p, n, x, mode):
    vertex = mode == "full_pp"
    sop = SaddleOperator(
        uu=jnp.asarray(T["uu"]),
        up=None if mode == "uu" else jnp.asarray(T["up"]),
        pu=None if mode == "uu" else jnp.asarray(T["pu"]),
        pp=jnp.asarray(T["pp"]) if vertex else None,
        cd_u=jnp.asarray(cd_u, jnp.int32),
        cd_p=jnp.asarray(cd_p if mode != "uu" else cd_p[:, :0], jnp.int32),
        u_plan=fe.vec_plan_p if vertex else fe.vec_plan_u_nodes,
        p_plan=fe.vec_plan_p, n_u_nodes=n)
    if mode == "up":
        return np.asarray(sop.up_matvec(jnp.asarray(x)))
    return np.asarray(sop.matvec(jnp.asarray(x)))


def _jax_window_saddle(T, cd_u, cd_p, n, n_p, x, mode):
    plan = W.build_window_plan(cd_u, cd_p, n, n_p, B=128)
    J = {k: jnp.asarray(v) for k, v in T.items()}
    uu_b, up_b, pu_b = W.blocked_saddle_tensors(
        J["uu"], None if mode == "uu" else J["up"],
        None if mode == "uu" else J["pu"], plan)
    pp_b = W.blocked_pp_tensor(J["pp"], plan) if mode == "full_pp" else None
    return np.asarray(W.saddle_matvec(uu_b, up_b, pu_b, jnp.asarray(x), plan,
                                      mode, pp_b=pp_b))


def _close(y, y0, dtype):
    assert y.shape == y0.shape
    assert np.abs(y - y0).max() <= BARS[dtype] * np.abs(y0).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full", "full_pp", "uu", "up"])
def test_saddle_matches_pallas_kernel(fe, interpret, mode, dtype):
    T, cd_u, cd_p, n, n_p, x = _case(fe, mode, dtype, seed=1)
    y = _port_saddle(T, cd_u, cd_p, n, x, mode)
    _close(y, _jax_window_saddle(T, cd_u, cd_p, n, n_p, x, mode), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full", "full_pp", "uu", "up"])
def test_saddle_matches_take_path(fe, mode, dtype):
    T, cd_u, cd_p, n, n_p, x = _case(fe, mode, dtype, seed=2)
    y = _port_saddle(T, cd_u, cd_p, n, x, mode)
    _close(y, _jax_take_saddle(fe, T, cd_u, cd_p, n, x, mode), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("space", ["b", "p"])
def test_scalar_matches_pallas_kernel_and_take_path(fe, interpret, space, dtype):
    rng = np.random.default_rng(3)
    cd = fe.cd_b if space == "b" else fe.cd_p
    n = fe.spaces.n_b if space == "b" else fe.spaces.n_p
    nc, nl = cd.shape
    ae = rng.standard_normal((nc, nl, nl)).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    y = K.scalar_matvec(torch.from_numpy(ae), torch.from_numpy(cd.astype(np.int32)),
                        torch.from_numpy(x)).numpy()
    plan = W.build_window_plan(cd, np.zeros((nc, 0)), n, 0, B=128)
    yw = np.asarray(W.scalar_matvec(W.blocked_scalar_tensor(jnp.asarray(ae), plan),
                                    jnp.asarray(x), plan))
    _close(y, yw, dtype)
    plan_v = fe.vec_plan_b if space == "b" else fe.vec_plan_p
    op = ElementOperator(Ae=jnp.asarray(ae), cd_rows=jnp.asarray(cd, jnp.int32),
                         cd_cols=jnp.asarray(cd, jnp.int32), row_plan=plan_v)
    _close(y, np.asarray(op.matvec(jnp.asarray(x))), dtype)


def test_element_operator_diagonals_match(fe):
    rng = np.random.default_rng(4)
    nc = fe.n_cells_padded
    sp = fe.spaces
    uu = rng.standard_normal((nc, 30, 30))
    pp = rng.standard_normal((nc, 4, 4))
    jop = SaddleOperator(
        uu=jnp.asarray(uu), up=jnp.zeros((nc, 30, 4)), pu=jnp.zeros((nc, 4, 30)),
        pp=jnp.asarray(pp), cd_u=jnp.asarray(fe.cd_u, jnp.int32),
        cd_p=jnp.asarray(fe.cd_p, jnp.int32), u_plan=fe.vec_plan_u_nodes,
        p_plan=fe.vec_plan_p, n_u_nodes=sp.u_space.ndof)
    from nupgcm_tpu_torch.ops.element import SaddleOperator as TSaddle

    top = TSaddle(uu=torch.from_numpy(uu), up=torch.zeros(nc, 30, 4, dtype=torch.float64),
                  pu=torch.zeros(nc, 4, 30, dtype=torch.float64), pp=torch.from_numpy(pp),
                  cd_u=torch.from_numpy(fe.cd_u.astype(np.int32)),
                  cd_p=torch.from_numpy(fe.cd_p.astype(np.int32)),
                  n_u_nodes=sp.u_space.ndof, n_p=sp.n_p)
    d0 = np.asarray(jop.diagonal())
    assert np.abs(top.diagonal().numpy() - d0).max() <= 1e-12 * np.abs(d0).max()


def test_cpu_wrappers_count_plain_calls_not_launches():
    K.reset_counts()
    cd = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    ae = torch.eye(3, dtype=torch.float64)[None]
    x = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    assert torch.equal(K.scalar_matvec(ae, cd, x), x)
    assert K.plain_calls["scalar"] == 1
    assert all(v == 0 for v in K.launches.values())


def test_wrappers_raise_on_devices_without_a_kernel():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused."""
    x = torch.zeros(3, device="meta")
    cd = torch.zeros((1, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.scalar_matvec(torch.zeros((1, 3, 3), device="meta"), cd, x)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.saddle_matvec(torch.zeros((1, 9, 9), device="meta"), None, None, None,
                        cd[:, :1], cd[:, :0], torch.zeros(3, device="meta"), "uu", 1)


def _small_model_args():
    mesh = npt.generators.rect_mesh(3, 3)
    params = npt.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npt.Forcings(nu=1.0, kappa_h=1.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npt.SurfaceDirichletBC(0.0))
    spaces = npt.Spaces(mesh, u_diri_tags=["boundary"], u_diri_masks=[(True,) * 3],
                        b_diri_tags=["top"], b_diri_vals=[0.0])
    return (npt.FEData(mesh, spaces), params, forc,
            npt.BDF1(t_start=0, t_stop=1, dt=0.1))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Where there is no nvcc, building the CUDA kernels -- directly or
    through PGModel(device="cuda") -- raises a clear error naming nvcc;
    nothing falls back to the CPU."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        npt.PGModel(*_small_model_args(), device="cuda")
    assert not (tmp_path / "_build").exists()


def test_model_on_cpu_uses_plain_versions_only():
    model = npt.PGModel(*_small_model_args(), dtype=torch.float64, device="cpu")
    K.reset_counts()
    model.step(model.set_b(model.rest_state(), lambda x: x[2]))
    assert K.plain_calls["saddle"] > 0 and K.plain_calls["scalar"] > 0
    assert all(v == 0 for v in K.launches.values())
