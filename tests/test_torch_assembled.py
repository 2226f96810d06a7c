"""The assembled vertex-block form of the P1-P1 coarse saddle operator
(nupgcm_tpu_torch/ops/assembled.py) against the JAX package's.

On the CPU the vertex-block wrapper runs its plain version; it is held,
in modes "full_pp" and "up" on P1-P1 (cd_p, cd_p) tables, against the
JAX Pallas kernel (ops/window.py, in interpret mode, as
tests/test_window.py runs it) and against the JAX take-path
SaddleOperator, on the same seeded element tensors and vectors, on a 3D
bowl, a 2D bowl (triangles) and the x-periodic channel.  Bars: f64
1e-12 max|y|, f32 2e-6 max|y| (summation order; the bars of
tests/test_torch_kernels.py).  The pattern is checked against the dof
table, the values against a fresh assembly after an eddy refresh, and
a CPU model's step against JAX's iteration counts with the coarse
level on the new path.  The CUDA kernel itself runs only on the card
(chip_smoke.py phases 3, 3c and 11c).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.ops import window as W
from nupgcm_tpu.ops.element import SaddleOperator
from nupgcm_tpu_torch.models.model import ops_from_numpy, state_from_numpy
from nupgcm_tpu_torch.ops import assembled as A
from nupgcm_tpu_torch.ops import kernels as K
from torch_parity import assert_same_rcm_branch

BARS = {"float64": 1e-12, "float32": 2e-6}
MESHES = {
    "bowl3D": lambda g: g.bowl3D(0.35, 0.5, nz=3),
    "bowl2D": lambda g: g.bowl2D(0.1, 0.5),
    "channel": lambda g: g.channel3D(0.2),
}


@pytest.fixture(autouse=True)
def _two_threads():
    """Small meshes: two intra-op threads a test under the suite's workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(MESHES))
def fe(request):
    mesh = MESHES[request.param](npj.generators)
    spaces = npj.Spaces(mesh, u_diri_tags=[], u_diri_vals=[], b_diri_tags=[], b_diri_vals=[])
    return request.param, npj.FEData(mesh, spaces)


@pytest.fixture
def interpret():
    W._INTERPRET = True
    yield
    W._INTERPRET = False


def _case(fe, dtype, seed):
    """Seeded P1-P1 element tensors, the vertex count and x for both modes."""
    rng = np.random.default_rng(seed)
    nc, nl = fe.cd_p.shape
    n = fe.spaces.n_p
    T = {k: rng.standard_normal(s).astype(dtype) for k, s in {
        "uu": (nc, 3 * nl, 3 * nl), "up": (nc, 3 * nl, nl),
        "pu": (nc, nl, 3 * nl), "pp": (nc, nl, nl)}.items()}
    return T, n, {"full_pp": rng.standard_normal(4 * n).astype(dtype),
                  "up": rng.standard_normal(n).astype(dtype)}


def _port(fe, T, n, x, mode):
    cd = torch.from_numpy(fe.cd_p.astype(np.int32))
    pat = A.vertex_pattern(cd, n)
    t = {k: torch.from_numpy(v) for k, v in T.items()}
    op = A.AssembledSaddle(pat, cd, t["uu"].dtype).fill(t["uu"], t["up"], t["pu"], t["pp"])
    xt = torch.from_numpy(x)
    return (op.matvec(xt) if mode == "full_pp" else op.up_matvec(xt)).numpy()


def _close(y, y0, dtype):
    assert y.shape == y0.shape
    assert np.abs(y - y0).max() <= BARS[dtype] * np.abs(y0).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full_pp", "up"])
def test_assembled_matches_pallas_kernel(fe, interpret, mode, dtype):
    _, fe = fe
    T, n, xs = _case(fe, dtype, seed=1)
    plan = W.build_window_plan(fe.cd_p, fe.cd_p, n, n, B=128)
    J = {k: jnp.asarray(v) for k, v in T.items()}
    uu_b, up_b, pu_b = W.blocked_saddle_tensors(J["uu"], J["up"], J["pu"], plan)
    pp_b = W.blocked_pp_tensor(J["pp"], plan) if mode == "full_pp" else None
    yw = np.asarray(W.saddle_matvec(uu_b, up_b, pu_b, jnp.asarray(xs[mode]), plan, mode,
                                    pp_b=pp_b))
    _close(_port(fe, T, n, xs[mode], mode), yw, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["full_pp", "up"])
def test_assembled_matches_take_path(fe, mode, dtype):
    _, fe = fe
    T, n, xs = _case(fe, dtype, seed=2)
    sop = SaddleOperator(
        uu=jnp.asarray(T["uu"]), up=jnp.asarray(T["up"]), pu=jnp.asarray(T["pu"]),
        pp=jnp.asarray(T["pp"]), cd_u=jnp.asarray(fe.cd_p, jnp.int32),
        cd_p=jnp.asarray(fe.cd_p, jnp.int32), u_plan=fe.vec_plan_p, p_plan=fe.vec_plan_p,
        n_u_nodes=n)
    x = jnp.asarray(xs[mode])
    y0 = np.asarray(sop.matvec(x) if mode == "full_pp" else sop.up_matvec(x))
    _close(_port(fe, T, n, xs[mode], mode), y0, dtype)


def test_pattern_rebuilds_the_dof_table(fe):
    """Every cell's nl^2 vertex pairs are blocks, sorted by row then
    column with none repeated and none beyond the real cells' pairs
    (padding repeats vertex 0), each row's blocks lie between its
    pointers, and a vertex no cell references (a periodic slave) has an
    empty row, which the operator leaves zero."""
    name, fe = fe
    cd = fe.cd_p.astype(np.int64)
    n = fe.spaces.n_p
    pat = A.vertex_pattern(torch.from_numpy(cd.astype(np.int32)), n)
    row, col = pat.row.numpy().astype(np.int64), pat.col.numpy().astype(np.int64)
    slot, row_ptr = pat.slot.numpy(), pat.row_ptr.numpy()
    nc, nl = cd.shape
    assert slot.shape == (nc, nl * nl) and row_ptr.shape == (n + 1,)
    assert np.array_equal(row[slot], np.repeat(cd, nl, axis=1))
    assert np.array_equal(col[slot], np.tile(cd, (1, nl)))
    keys = row * n + col
    assert np.all(np.diff(keys) > 0)
    real = cd[: fe.mesh.n_cells]
    assert len(keys) == len(np.unique((real[:, :, None] * n + real[:, None, :]).ravel()))
    assert row_ptr[0] == 0 and row_ptr[-1] == len(keys)
    assert np.array_equal(np.searchsorted(keys, np.arange(n + 1) * n), row_ptr)
    empty = np.setdiff1d(np.arange(n), cd)
    assert (len(empty) > 0) == (name == "channel")  # the seam's slave vertices
    assert np.all(row_ptr[empty] == row_ptr[empty + 1])
    T, _, xs = _case(fe, "float64", seed=3)
    for mode in ("full_pp", "up"):
        y = _port(fe, T, n, xs[mode], mode)
        cols = 4 if mode == "full_pp" else 3
        rows_of = (np.concatenate([(3 * empty[:, None] + np.arange(3)).ravel(), 3 * n + empty])
                   if cols == 4 else (3 * empty[:, None] + np.arange(3)).ravel())
        assert np.all(y[rows_of] == 0.0)


def test_pattern_and_values_follow_the_cells_not_their_order(fe):
    """A shuffled cell order gives the same blocks, and values equal to
    rounding (index_add_ sums a block's cells in another order)."""
    _, fe = fe
    n = fe.spaces.n_p
    cd = torch.from_numpy(fe.cd_p.astype(np.int32))
    T, _, _ = _case(fe, "float64", seed=4)
    t = {k: torch.from_numpy(v) for k, v in T.items()}
    perm = torch.as_tensor(np.random.default_rng(5).permutation(cd.shape[0]))
    pats = [A.vertex_pattern(cd, n), A.vertex_pattern(cd[perm], n)]
    assert torch.equal(pats[0].row_ptr, pats[1].row_ptr) and torch.equal(pats[0].col, pats[1].col)
    ops = [A.AssembledSaddle(pats[0], cd, torch.float64).fill(*(t[k] for k in
                                                                 ("uu", "up", "pu", "pp"))),
           A.AssembledSaddle(pats[1], cd[perm], torch.float64).fill(
               *(t[k][perm] for k in ("uu", "up", "pu", "pp")))]
    (v0, u0), (v1, u1) = ((o.vals, o.up_vals) for o in ops)
    for a, b in ((v0, v1), (u0, u1)):
        assert float((a - b).abs().max()) <= 1e-14 * float(a.abs().max())
    assert torch.equal(u0, v0.view(-1, 4, 4)[:, :3, 3])


def _eddy_model(g, **kw):
    """tests/test_torch_refresh.py's eddy-closure bowl in package ``g``,
    on the iterative coarse path (coarse_dense_max lowered)."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    mesh = g.generators.bowl3D(0.35, alpha, nz=3)
    spaces = g.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    params = g.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                          f=lambda x: 1.0 + 0.5 * x[1],
                          H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = g.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
        b_surface_bc=g.SurfaceDirichletBC(0.0),
        eddy_param=g.EddyParameterization(f=lambda x: 1.0 + 0.5 * x[1],
                                          N2_min=float(np.sqrt(1e-3))))
    return g.PGModel(g.FEData(mesh, spaces), params, forc,
                     g.BDF2(t_start=0, t_stop=1e9, dt=1e-2), coarse_dense_max=256, **kw)


def test_values_follow_refresh_precond():
    """After refresh_precond with an eddy-changed viscosity, the coarse
    operator's blocks (refilled in the same tensors) equal a fresh
    assembly of the rebuilt element tensors, and its products the
    element path's; an ops dict set on the model refills them too."""
    m = _eddy_model(npt, dtype=torch.float64, device="cpu")
    assert m.preconditioner_branch == "iterative saddle coarse + L2 aggregate level"
    op = m._sc_op
    vals0, before = op.vals, op.vals.clone()
    st = m.set_b(m.rest_state(), lambda x: 0.5 * np.exp(-(x[2] + 0.25) ** 2 / 0.01))
    ops = m.refresh_precond(m.ops, st)
    assert m._sc_op is op and op.vals is vals0 and float((op.vals - before).abs().max()) > 0
    sc = tuple(ops[k] for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp"))
    cd = m.const["cd_p"]
    fresh = A.AssembledSaddle(m.const["vblk_coarse"], cd, torch.float64).fill(*sc)
    assert torch.equal(op.vals, fresh.vals) and torch.equal(op.up_vals, fresh.up_vals)
    nv = m.fe.spaces.p_space.ndof
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(4 * nv))
    y0 = K.saddle_matvec_plain(*sc, cd, cd, x, "full_pp", nv)
    assert float((op.matvec(x) - y0).abs().max()) <= 1e-12 * float(y0.abs().max())
    # an ops dict set from outside (fresh tensors) is filled in on assignment
    copied = {k: v.clone() for k, v in ops.items()}
    copied["sc_pp"].mul_(2.0)
    m.ops = copied
    y2 = m._sc_op.matvec(x)
    sc2 = tuple(copied[k] for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp"))
    y20 = K.saddle_matvec_plain(*sc2, cd, cd, x, "full_pp", nv)
    assert float((y2 - y20).abs().max()) <= 1e-12 * float(y20.abs().max())


def test_cpu_model_steps_through_the_assembled_plain_version(monkeypatch):
    """A CPU PGModel on the iterative coarse path applies its coarse
    saddle and coupling through the vertex-block plain version and never
    through K1's P1-P1 "full_pp" / "up" plain version, and its step takes
    the JAX model's iteration counts from the same state and tensors."""
    assert_same_rcm_branch()
    mt = _eddy_model(npt, dtype=torch.float64, device="cpu")
    mj = _eddy_model(npj)
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    k1, vb = [], []
    k1_plain, vb_plain = K.saddle_matvec_plain, K.vblock_matvec_plain
    monkeypatch.setattr(K, "saddle_matvec_plain", lambda *a: k1.append(
        (a[7], a[4].shape[1], a[5].shape[1])) or k1_plain(*a))
    monkeypatch.setattr(K, "vblock_matvec_plain", lambda *a: vb.append(a[4]) or vb_plain(*a))
    bic = lambda x: 0.1 * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)
    sj = mj.set_b(mj.rest_state(), bic)
    fields = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in fields}, "cpu")
    for _ in range(2):
        _, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"]) > 0
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0
        for f in ("u", "p", "b"):
            a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
            assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), f
    assert {"full_pp", "up"} <= set(vb)
    assert not [c for c in k1 if c[0] == "full_pp" or (c[0] == "up" and c[1] == c[2])], k1
    assert ("full", 10, 4) in k1  # the fine operator stays on K1's path


def test_bench_cases_match_k1_and_the_csr_yardstick():
    """kernel_bench's assembled cases (chip_smoke.py phases 3 and 11c) on
    a CPU model: the vertex-block plain version on the case's values
    equals K1's plain version on its element tensors (K2's for the P1
    pressure mass) and the CSR product of the yardstick, at 1e-12 of
    max|y| (f64); the second application is bitwise the first."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    m = _eddy_model(npt, dtype=torch.float64, device="cpu")
    cases = kb.assembled_cases(m)
    assert [c["mode"] for c in cases] == ["full_pp", "up", "uu", "uu", "scalar", "up"]
    rng = np.random.default_rng(7)
    for case in cases:
        vals, pat = kb.vblock_values(case, torch.float64)
        assert vals.shape == (pat.n_blocks, K.VBLOCK_WIDTH[case["mode"]])
        x = torch.as_tensor(rng.standard_normal(case["n_x"]))
        y = K.vblock_matvec_plain(vals, pat.col, pat.row, x, case["mode"], pat.n_rows)
        assert torch.equal(y, K.vblock_matvec_plain(vals, pat.col, pat.row, x, case["mode"],
                                                    pat.n_rows))
        if case["mode"] == "scalar":
            y0 = K.scalar_matvec_plain(*case["blocks"], *case["cd"], x)
        else:
            y0 = K.saddle_matvec_plain(*case["blocks"], *case["cd"], x, case["mode"],
                                       case["n_nodes"])
        y1 = torch.sparse.mm(kb.operator_csr(case, case["blocks"], case["n_x"]), x[:, None])[:, 0]
        for other in (y0, y1):
            assert float((y - other).abs().max()) <= 1e-12 * float(other.abs().max())
    # the model without an iterative coarse level has no coarse saddle case
    assert [c["mode"] for c in kb.assembled_cases(_eddy_model(
        npt, dtype=torch.float64, device="cpu", saddle_coarse=False, twogrid=True))] == [
        "uu", "scalar", "up"]


def test_rotating_copies_evict_the_l2():
    """kernel_bench.rotating takes its copies in turn, with enough of them
    that EVICT_BYTES pass between two uses of one copy."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    made, calls = [], []

    def make():
        i = len(made)
        made.append(i)
        return lambda: calls.append(i)

    f = kb.rotating(make, kb.EVICT_BYTES // 3 + 1)
    assert f.copies == 3 == len(made)
    for _ in range(7):
        f()
    assert calls == [1, 2, 0, 1, 2, 0, 1]
    assert kb.rotating(make, 2 * kb.EVICT_BYTES).copies == 1
    assert kb.EVICT_BYTES >= 2 * kb.L2_BYTES


def test_vblock_wrapper_counts_and_refuses():
    """The CPU wrapper counts a plain call and no launch; a tensor on a
    device without a kernel, or values of the wrong width, are refused."""
    pat = A.vertex_pattern(torch.tensor([[0, 1, 2]], dtype=torch.int32), 3)
    vals = torch.zeros((pat.n_blocks, 16), dtype=torch.float64)
    K.reset_counts()
    y = K.vblock_matvec(vals, pat.col, pat.row_ptr, pat.row, torch.ones(12, dtype=torch.float64),
                        "full_pp")
    assert torch.equal(y, torch.zeros(12, dtype=torch.float64))
    assert K.plain_calls["vblock"] == 1 and not any(K.launches.values())
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.vblock_matvec(vals, pat.col, pat.row_ptr, pat.row, torch.zeros(12, device="meta"),
                        "full_pp")
    with pytest.raises(ValueError, match=r"shape \(n_blocks, 3\)"):
        K.vblock_matvec(vals, pat.col, pat.row_ptr, pat.row, torch.ones(3, dtype=torch.float64),
                        "up")
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.VBlockLaunch(vals, pat.col, pat.row_ptr, "full_pp")


def test_vblock_params_mirror_the_c_struct():
    # struct VbLaunch: 3 pointers, 2 long long, 4 int, 1 pointer
    import ctypes

    assert ctypes.sizeof(K._VbParams) == 64
    assert K._VbParams.n_rows.offset == 24 and K._VbParams.launcher.offset == 56


def test_step_cost_tool_needs_cuda_and_finds_the_coarse_operator():
    """tools/step_cost.py refuses to run without a card, and reads the
    coarse saddle operator a solve applies (the model's assembled one)."""
    from nupgcm_tpu_torch.tools import step_cost

    with pytest.raises(RuntimeError, match="CUDA"):
        step_cost.main([])
    m = _eddy_model(npt, dtype=torch.float64, device="cpu")
    assert step_cost.coarse_operator(m) is m._sc_op
