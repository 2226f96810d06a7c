"""The port's saddle-coarse build -- float64 element blocks, the dense
and aggregate coarse matrices and their inverses, all on the model's
device -- against nupgcm_tpu's host float64 route, in f64 on the CPU:

  * the float64 coarse element blocks (uu, up, pu, stab) and the
    pressure pin weights against nupgcm_tpu's ``_sc_host_blocks``
    (1e-12 of each one's max);
  * the matrix of the model's branch (``_saddle_coarse_matrix`` on the
    dense branch, ``_aggregate_matrix`` on the aggregate one) against a
    numpy scatter of those JAX blocks by the JAX package's own formula,
    and the device inverse against ``np.linalg.inv`` of that matrix
    (1e-12 of the max);
  * cases, one parametrised test: a 3D bowl on each branch, an eddy
    closure (variable nu, at the viscosity of a stratified state), and
    the x-periodic channel on the aggregate branch, whose periodic
    slaves are pinned pressure dofs of the coarse level (identity rows,
    projected as P^T (I - F) P).  No cell reaches a slave, so its pin
    weight is zero with or without the free mask;
  * an f32 model's coarse inverses equal the f64 model's cast to
    float32 (blocks built from the model's float32 constants would not);
  * a singular coarse matrix raises, and the build calls no numpy
    inverse.
"""

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import PGModel
from torch_parity import assert_same_rcm_branch


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bowl(npg, eddy=False, f=lambda x: 1.0 + 0.5 * x[1], **kw):
    """bowl3D(0.35, nz=3) with the mixing parameters (and the eddy
    closure of tests/test_torch_refresh.py)."""
    alpha = 0.5
    mesh = npg.generators.bowl3D(0.35, alpha, nz=3)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    params = npg.Parameters(eps=2e-1, alpha=alpha, mu_rho=1e1, N2=1 / alpha, f=f,
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    extra = {}
    if eddy:
        extra["eddy_param"] = npg.EddyParameterization(
            f=lambda x: 1.0 + 0.5 * x[1], N2_min=float(np.sqrt(1e-3)))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0), **extra)
    return npg.PGModel(fe, params, forc, npg.BDF2(t_start=0, t_stop=1.0, dt=1e-2), **kw)


def _channel(npg, **kw):
    """channel3D(0.15) (96 vertices, 12 periodic pairs) in
    tests/test_channel.py's wind-driven jet configuration."""
    mesh = npg.generators.channel3D(0.15)
    params = npg.Parameters(eps=0.3, alpha=1.0, mu_rho=1.0, N2=1.0,
                            f=lambda x: 1.0 + 0 * x[1], H=lambda x: 0.5)
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=-0.05, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(mesh, u_diri_tags=["bottom", "coastline"], u_diri_vals=[(0, 0, 0)] * 2,
                        u_diri_masks=[(True, True, True)] * 2, b_diri_tags=[], b_diri_vals=[])
    fe = npg.FEData(mesh, spaces)
    return npg.PGModel(fe, params, forc, npg.BDF1(t_start=0, t_stop=0.5, dt=0.1), **kw)


L2 = dict(coarse_dense_max=256)  # the aggregate branch on these small meshes
CASES = {
    "bowl_dense": (_bowl, {}),
    "bowl_l2": (_bowl, L2),
    "eddy_dense": (lambda npg, **kw: _bowl(npg, eddy=True, **kw), {}),
    "channel_l2": (_channel, L2),
}


def _close(ref, got, what, rel=1e-12):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, what
    assert np.abs(ref - got).max() <= rel * max(np.abs(ref).max(), 1e-300), what


def _reference_matrix(mj, blocks, sigma=None):
    """nupgcm_tpu's coarse matrix from its host blocks, by its own
    formulas: ``_assemble_saddle_coarse_dense`` without a ``sigma``,
    ``_assemble_saddle_coarse_l2`` with its ``sc_sigma``."""
    uu, up, pu, stab, idx_u, idx_p, pv = blocks
    c, sp = mj.const, mj.fe.spaces
    nv = sp.p_space.ndof
    free = np.concatenate([np.asarray(c["tg_coarse_free"], np.float64),
                           np.asarray(c["free_inv"][sp.n_u:], np.float64)])
    if sigma is None:
        N, dofmap, mask = 4 * nv, np.arange(4 * nv), np.ones_like(free)
    else:
        _, na, dofmap = mj._sc2_cache
        N, mask = 4 * na, free
    A = np.zeros(N * N)
    for rows, cols, v in ((idx_u, idx_u, uu), (idx_u, idx_p, up), (idx_p, idx_u, pu),
                          (idx_p, idx_p, stab)):
        r = np.repeat(rows, cols.shape[1], axis=1).ravel()
        cc = np.tile(cols, (1, rows.shape[1])).ravel()
        np.add.at(A, dofmap[r] * N + dofmap[cc], v.ravel() * mask[r] * mask[cc])
    A = A.reshape(N, N)
    if sigma is None:
        A = free[:, None] * A * free[None, :] + np.diag(1.0 - free)
        w = np.concatenate([np.zeros(3 * nv), pv])
        w /= np.linalg.norm(w)
        return A + np.mean(np.abs(np.diagonal(A))) * np.outer(w, w)
    A[np.diag_indices(N)] += np.bincount(dofmap, weights=1.0 - free, minlength=N)
    w = np.concatenate([np.zeros(3 * nv), pv * free[3 * nv:]])
    w /= np.linalg.norm(w)
    wc = np.bincount(dofmap, weights=w, minlength=N)
    return A + sigma * np.outer(wc, wc)


@pytest.mark.parametrize("case", list(CASES))
def test_coarse_build_matches_jax(case):
    assert_same_rcm_branch()
    make, kw = CASES[case]
    mj = make(npj, **kw)
    mt = make(npt, dtype=torch.float64, device="cpu", **kw)
    dense = case.endswith("dense")
    assert (mt.saddle_coarse_dense, mt.saddle_coarse_l2) == (dense, not dense)
    nu_q = None
    if case == "eddy_dense":  # the viscosity of a stratified state
        assert mt.variable_nu
        st = mt.set_b(mt.rest_state(), lambda x: 0.1 * np.exp(x[2] / 0.1))
        nu_q = mt.forcings.eddy_param.nu(mt.const["f_eddy_q"], mt._abz(st.b))
        assert float(nu_q.max()) > 1.5 * float(nu_q.min())
    blocks = mj._sc_host_blocks(None if nu_q is None else nu_q.numpy())
    for name, ref, got in zip(("uu", "up", "pu", "stab"), blocks, mt._sc_blocks64(nu_q)):
        assert got.dtype == torch.float64 and got.device == mt.device
        _close(ref, got, name)
    _close(blocks[-1], mt._sc_pin_weights(), "pin weights")

    if dense:
        ref = _reference_matrix(mj, blocks)
        A = mt._saddle_coarse_matrix(nu_q)
    else:
        assert np.array_equal(mj._sc2_cache[2], mt._sc2_tables()[2].numpy())
        if case == "channel_l2":  # periodic slaves: pinned pressure dofs
            slaves = ~mt.fe.spaces.p_space.active
            assert slaves.any() and not blocks[-1][slaves].any()
        ref = _reference_matrix(mj, blocks, sigma=float(mj.ops["sc_sigma"]))
        A = mt._aggregate_matrix(mt.ops, nu_q)
    _close(ref, A, "matrix")
    inv = mt._coarse_inverse(A)
    _close(np.linalg.inv(ref), inv, "inverse")
    if nu_q is None:  # the build's own inverse
        _close(np.linalg.inv(ref), mt.ops["saddle_coarse_inv" if dense else "sc2_inv"],
               "ops inverse")


@pytest.mark.parametrize("kw", [{}, L2], ids=["dense", "l2"])
def test_f32_model_inverse_is_the_f64_one_cast(kw):
    """With f and nu exact in float32 (f = 1, nu = 1), the f32 model's
    float64 coarse inputs are the f64 model's bit for bit, so its dense
    inverse is the f64 one cast.  The aggregate matrix also holds the
    pin sigma w w^T with sigma the f32 model's own (its element tensors'
    mean |diagonal|, as nupgcm_tpu has it): equal matrices given the
    same sigma, and the inverses within 1e-8 of the max (sigma's float32
    rounding moves them about 5e-9)."""
    one = lambda x: 1.0 + 0 * x[0]
    m64 = _bowl(npt, f=one, dtype=torch.float64, device="cpu", **kw)
    m32 = _bowl(npt, f=one, dtype=torch.float32, device="cpu", **kw)
    key = "sc2_inv" if kw else "saddle_coarse_inv"
    x64, x32 = m64.ops[key], m32.ops[key]
    assert x32.dtype == torch.float32 and x32.shape == x64.shape
    if not kw:
        assert torch.equal(x32, x64.float())
        assert torch.equal(m32._saddle_coarse_matrix(), m64._saddle_coarse_matrix())
        return
    assert torch.equal(m32._aggregate_matrix(m64.ops), m64._aggregate_matrix(m64.ops))
    assert float((x32 - x64.float()).abs().max()) <= 1e-8 * float(x64.abs().max())


def test_singular_coarse_matrix_raises():
    A = torch.eye(6, dtype=torch.float64)
    A[3] = 0.0
    with pytest.raises(torch.linalg.LinAlgError, match="singular"):
        PGModel._coarse_inverse(A)


@pytest.mark.parametrize("kw", [{}, L2], ids=["dense", "l2"])
def test_coarse_build_calls_no_numpy_inverse(kw, monkeypatch):
    """The coarse level's build and a refresh invert on the model's
    device: with ``np.linalg.inv`` unavailable both still run, the
    build to the same inverse."""
    mt = _bowl(npt, eddy=True, dtype=torch.float64, device="cpu", **kw)
    key = "sc2_inv" if kw else "saddle_coarse_inv"
    assert {"saddle_coarse": not kw, "aggregate_level": bool(kw)} == {
        k: k in mt.build_seconds for k in ("saddle_coarse", "aggregate_level")}
    built = mt.ops[key].clone()
    state = mt.set_b(mt.rest_state(), lambda x: 0.1 * np.exp(x[2] / 0.1))

    def refuse(*a, **k):
        raise AssertionError("np.linalg.inv called")

    monkeypatch.setattr(np.linalg, "inv", refuse)
    ops = dict(mt.ops)
    mt._assemble_saddle_coarse(ops)
    assert torch.equal(ops[key], built)
    assert not torch.equal(mt.refresh_precond(mt.ops, state)[key], built)


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [{}, L2], ids=["dense", "l2"])
def test_chip_smoke_coarse_phase(kw, monkeypatch, capsys):
    """chip_smoke.py's phase 12 on a small CPU model (the card's
    synchronisation a no-op): it passes on the model's own matrices, and
    fails on an inverse that is off by one part in 1e-9."""
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    mt = _bowl(npt, dtype=torch.float64, device="cpu", **kw)
    cs.phase_coarse(mt, "12x", "cpu", host=True)
    out = capsys.readouterr().out
    assert ("dense coarse level" if not kw else "aggregate level") in out
    assert "||A X - I||_inf" in out and "np.linalg.inv" in out
    assert "constants" in cs.build_parts(mt)
    inverse = mt._coarse_inverse
    monkeypatch.setattr(mt, "_coarse_inverse", lambda A: inverse(A) * (1 + 1e-9))
    with pytest.raises(RuntimeError, match="n u kappa"):
        cs.phase_coarse(mt, "12x", "cpu")
