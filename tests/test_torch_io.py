"""Checkpoints of the port (nupgcm_tpu_torch.io.checkpoint): ports of
tests/test_io_postprocess.py's round-trip and mismatch checks, and the
cross-package contract -- a checkpoint written by nupgcm_tpu loads into
the port and one written by the port loads into nupgcm_tpu, with every
field bit-identical."""

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.io import checkpoint as ckj
from nupgcm_tpu_torch.io import checkpoint as ckt

FIELDS = ("u", "p", "b", "u_prev", "b_prev")


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(npg, h=0.35, **kw):
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl3D(h, alpha, nz=2)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0])
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=0.5, dt=0.1)
    return npg.PGModel(fe, params, forc, ts, inv_itmax=200, **kw)


@pytest.fixture(scope="module")
def small_pair():
    mt = _small(npt, dtype=torch.float64, device="cpu")
    st = mt.run(mt.set_b(mt.rest_state(), lambda x: 0.05 * np.exp(2 * x[2])),
                n_info=0, max_steps=3)
    return _small(npj), mt, st


def test_checkpoint_roundtrip(small_pair, tmp_path):
    _, model, st = small_pair
    p = str(tmp_path / "state.npz")
    ckt.save_state(model, st, p)
    st2 = ckt.load_state(model, p)
    for f in FIELDS:
        a, b = getattr(st, f), getattr(st2, f)
        assert b.dtype == model.dtype and b.device == model.device
        assert torch.equal(a, b), f
    assert float(st2.t) == float(st.t) and float(st2.dt) == float(st.dt)
    assert st2.step == st.step == 3
    # resume: one more step from the restored state works
    st3, aux = model.step(st2)
    assert np.isfinite(aux["u_max"]) and st3.step == 4


def test_checkpoint_mismatch_raises(small_pair, tmp_path):
    _, model, st = small_pair
    p = str(tmp_path / "state.npz")
    ckt.save_state(model, st, p)
    mesh = npt.generators.bowl3D(0.45, 0.5, nz=2)
    spaces = npt.Spaces(mesh, b_diri_tags=[], b_diri_vals=[])
    fe = npt.FEData(mesh, spaces)
    m2 = npt.PGModel(fe, model.params, model.forcings, model.ts, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        ckt.load_state(m2, p)


def test_checkpoint_port_to_jax(small_pair, tmp_path):
    mj, mt, st = small_pair
    p = str(tmp_path / "port.npz")
    ckt.save_state(mt, st, p)
    sj = ckj.load_state(mj, p)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy()), f
    assert float(sj.t) == float(st.t) and int(sj.step) == st.step
    assert float(sj.dt) == float(st.dt)


def test_checkpoint_jax_to_port(small_pair, tmp_path):
    mj, mt, _ = small_pair
    sj = mj.run(mj.set_b(mj.rest_state(), lambda x: 0.05 * np.exp(2 * x[2])),
                n_info=0, max_steps=2)
    p = str(tmp_path / "jax.npz")
    ckj.save_state(mj, sj, p)
    st = ckt.load_state(mt, p)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy()), f
    assert float(st.t) == float(sj.t) and st.step == int(sj.step) == 2
    # a port model in f32 loads the same file in its own type
    m32 = _small(npt, dtype=torch.float32, device="cpu")
    s32 = ckt.load_state(m32, p)
    assert s32.b.dtype == s32.t.dtype == torch.float32
    assert np.allclose(s32.b.numpy(), np.asarray(sj.b), rtol=1e-6, atol=1e-12)
