"""The assembled P1 vector velocity blocks and P2-P1 pressure coupling
(nupgcm_tpu_torch/ops/assembled.py ``AssembledBlocks``) against the JAX
package's.

On the CPU the block wrapper runs its plain version; it is held, in mode
"uu" on the P1-P1 (cd_p, cd_p) pattern (3x3 blocks, row-major)
and in mode "up" on the rectangular P2-P1 (cd_u, cd_p) pattern, against
the JAX Pallas kernel (ops/window.py, in interpret mode, as
tests/test_window.py runs it) and against the JAX take-path
SaddleOperator, on the same seeded element tensors and vectors, on a 3D
bowl, a 2D bowl (triangles) and the x-periodic channel.  Bars: f64
1e-12 max|y|, f32 2e-6 max|y| (summation order; the bars of
tests/test_torch_kernels.py).  The rectangular pattern is checked
against the dof tables; the model's held operators against fresh fills
after each write of their element tensors (the eddy rebuild,
refresh_precond, the ops setter); CPU models on the saddle-coarse and
the two-grid element branches, and the north-star full physics through
an eddy rebuild and a refresh, step with JAX's iteration counts.  The
CUDA kernel itself runs only on the card (chip_smoke.py phases 3, 3c
and 11c).
"""

import ctypes
import pathlib
import re

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

ROOT = pathlib.Path(__file__).resolve().parents[1]
BARS = {"float64": 1e-12, "float32": 2e-6}
MESHES = {
    "bowl3D": lambda g: g.bowl3D(0.35, 0.5, nz=3),
    "bowl2D": lambda g: g.bowl2D(0.1, 0.5),
    "channel": lambda g: g.channel3D(0.2),
}
STATE = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


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


def _tables(fe, mode):
    """(cd_r, n_rows, cd_c, n_cols) of the pattern of ``mode``: P1 vertices
    for "uu", P2 velocity nodes against vertices for "up"."""
    nv = fe.spaces.n_p
    if mode == "uu":
        return fe.cd_p, nv, fe.cd_p, nv
    return fe.cd_u, fe.spaces.u_space.ndof, fe.cd_p, nv


def _case(fe, mode, dtype, seed):
    """A seeded element tensor of ``mode`` and x: the P1 vector velocity
    block (nc, 3 nlp, 3 nlp) and x over 3 n_p, or the P2-P1 coupling
    (nc, 3 nlu, nlp) and x over n_p."""
    rng = np.random.default_rng(seed)
    cd_r, n_r, cd_c, n_c = _tables(fe, mode)
    nc, nl_r = cd_r.shape
    shape = (nc, 3 * nl_r, 3 * nl_r) if mode == "uu" else (nc, 3 * nl_r, cd_c.shape[1])
    e = rng.standard_normal(shape).astype(dtype)
    return e, rng.standard_normal(3 * n_r if mode == "uu" else n_c).astype(dtype)


def _operator(fe, mode, e):
    cd_r, n_r, cd_c, n_c = (torch.from_numpy(np.asarray(t).astype(np.int32))
                            if isinstance(t, np.ndarray) else t for t in _tables(fe, mode))
    pat = A.vertex_pattern(cd_r, n_r, cd_c, n_c)
    return A.AssembledBlocks(pat, mode, e.dtype, cd_r).fill(e)


def _port(fe, mode, e, x):
    return _operator(fe, mode, torch.from_numpy(e)).matvec(torch.from_numpy(x)).numpy()


def _close(y, y0, dtype):
    assert y.shape == y0.shape
    assert np.abs(y - y0).max() <= BARS[dtype] * np.abs(y0).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["uu", "up"])
def test_blocks_match_pallas_kernel(fe, interpret, mode, dtype):
    _, fe = fe
    e, x = _case(fe, mode, dtype, seed=1)
    cd_r, n_r, cd_c, n_c = _tables(fe, mode)
    plan = W.build_window_plan(cd_r, cd_c, n_r, n_c, B=128)
    if mode == "uu":
        uu_b, _, _ = W.blocked_saddle_tensors(jnp.asarray(e), None, None, plan)
        yw = W.saddle_matvec(uu_b, None, None, jnp.asarray(x), plan, "uu")
    else:
        _, up_b, _ = W.blocked_saddle_tensors(None, jnp.asarray(e), None, plan)
        yw = W.saddle_matvec(None, up_b, None, jnp.asarray(x), plan, "up")
    _close(_port(fe, mode, e, x), np.asarray(yw), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("mode", ["uu", "up"])
def test_blocks_match_take_path(fe, mode, dtype):
    _, fe = fe
    e, x = _case(fe, mode, dtype, seed=2)
    if mode == "uu":
        sop = SaddleOperator(uu=jnp.asarray(e), up=None, pu=None,
                             cd_u=jnp.asarray(fe.cd_p, jnp.int32),
                             cd_p=np.zeros((fe.cd_p.shape[0], 0), np.int32),
                             u_plan=fe.vec_plan_p, p_plan=fe.vec_plan_p, n_u_nodes=fe.spaces.n_p)
        y0 = sop.matvec(jnp.asarray(x))
    else:
        sop = SaddleOperator(uu=None, up=jnp.asarray(e), pu=None,
                             cd_u=jnp.asarray(fe.cd_u, jnp.int32),
                             cd_p=jnp.asarray(fe.cd_p, jnp.int32), u_plan=fe.vec_plan_u_nodes,
                             p_plan=fe.vec_plan_p, n_u_nodes=fe.spaces.u_space.ndof)
        y0 = sop.up_matvec(jnp.asarray(x))
    _close(_port(fe, mode, e, x), np.asarray(y0), dtype)


def test_rectangular_pattern_rebuilds_the_dof_tables(fe):
    """Every cell's P2 node x vertex pairs are blocks, sorted by row then
    column with none repeated and none beyond the real cells' pairs
    (padding repeats node 0), each row's blocks lie between its
    pointers, a P2 node no cell references (the channel's periodic
    slaves) has an empty row whose outputs are zero, and the square call
    keeps its pattern."""
    name, fe = fe
    cd_u, nu, cd_p, n_p = _tables(fe, "up")
    cu, cp = cd_u.astype(np.int64), cd_p.astype(np.int64)
    pat = A.vertex_pattern(torch.from_numpy(cu.astype(np.int32)), nu,
                           torch.from_numpy(cp.astype(np.int32)), n_p)
    nc, nlu = cu.shape
    nlp = cp.shape[1]
    row, col = pat.row.numpy().astype(np.int64), pat.col.numpy().astype(np.int64)
    slot, row_ptr = pat.slot.numpy(), pat.row_ptr.numpy()
    assert pat.sizes == (nlu, nlp) and (pat.n_rows, pat.n_cols) == (nu, n_p)
    assert slot.shape == (nc, nlu * nlp) and row_ptr.shape == (nu + 1,)
    assert np.array_equal(row[slot], np.repeat(cu, nlp, axis=1))
    assert np.array_equal(col[slot], np.tile(cp, (1, nlu)))
    keys = row * n_p + col
    assert np.all(np.diff(keys) > 0)
    real = slice(0, fe.mesh.n_cells)
    assert len(keys) == len(np.unique((cu[real][:, :, None] * n_p + cp[real][:, None, :]).ravel()))
    assert row_ptr[0] == 0 and row_ptr[-1] == len(keys)
    assert np.array_equal(np.searchsorted(keys, np.arange(nu + 1) * n_p), row_ptr)
    empty = np.setdiff1d(np.arange(nu), cu)
    assert (len(empty) > 0) == (name == "channel")
    assert np.all(row_ptr[empty] == row_ptr[empty + 1])
    e, x = _case(fe, "up", "float64", seed=3)
    y = _port(fe, "up", e, x)
    assert np.all(y[(3 * empty[:, None] + np.arange(3)).ravel()] == 0.0)
    # the square call's pattern is the (cd_p, cd_p) one
    cdp = torch.from_numpy(cp.astype(np.int32))
    sq, sq2 = A.vertex_pattern(cdp, n_p), A.vertex_pattern(cdp, n_p, cdp, n_p)
    assert sq.sizes == (nlp, nlp) and sq.n_cols == n_p
    for f in ("row_ptr", "col", "row", "slot"):
        assert torch.equal(getattr(sq, f), getattr(sq2, f)), f


def test_rows_hold_each_block_value(fe):
    """The "uu" operator keeps value (r, s) of block k at vals[k, 3 r + s],
    the sum over the cells sharing the block's vertex pair, and its
    diagonal is the element operator's."""
    _, fe = fe
    e, _ = _case(fe, "uu", "float64", seed=4)
    op = _operator(fe, "uu", torch.from_numpy(e))
    pat = op.pattern
    nc, nl = fe.cd_p.shape
    k = pat.slot.numpy().reshape(nc, nl, nl).astype(np.int64)
    ref = np.zeros((pat.n_blocks, 3, 3))
    np.add.at(ref, k.reshape(-1), e.reshape(nc, nl, 3, nl, 3).transpose(0, 1, 3, 2, 4)
              .reshape(-1, 3, 3))
    assert np.abs(op.vals.numpy().reshape(-1, 3, 3) - ref).max() <= 1e-14 * np.abs(ref).max()
    du = np.zeros((fe.spaces.n_p, 3))
    np.add.at(du, fe.cd_p.reshape(-1), np.einsum("cii->ci", e).reshape(-1, 3))
    assert np.abs(op.diagonal().numpy() - du.reshape(-1)).max() <= 1e-14 * np.abs(du).max()


def _eddy_model(g, **kw):
    """The eddy-closure bowl of tests/test_torch_refresh.py in package
    ``g`` (coarse_dense_max lowered: the iterative coarse levels)."""
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


BRANCHES = {"saddle_coarse": {}, "twogrid": dict(saddle_coarse=False, twogrid=True)}
HELD = {"saddle_coarse": ["sc_uu", "sc_visc_e", "A_up_e"], "twogrid": ["coarse_e", "A_up_e"]}


def BIC(x):
    return 0.1 * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)


def _k1_plain(m, ops, key, x):
    """K1's plain version on the element tensor ``ops[key]``."""
    c, sp = m.const, m.fe.spaces
    if key == "A_up_e":
        return K.saddle_matvec_plain(None, ops[key], None, None, c["cd_u"], c["cd_p"], x, "up",
                                     sp.u_space.ndof)
    return K.saddle_matvec_plain(ops[key], None, None, None, c["cd_p"], c["cd_none"], x, "uu",
                                 sp.p_space.ndof)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_held_operators_follow_every_write(branch):
    """The model holds one assembled operator per element tensor it
    applies from blocks.  Each is refilled in place (its values tensor
    kept) wherever the tensor is written: the eddy rebuild (A_up_e),
    refresh_precond (every one) and an ops dict set on the model; after
    each, its values equal a fresh fill of the tensor and its products
    K1's plain version (1e-12 of max|y|, f64).  Stale values are wiped
    first, so a missing refill shows."""
    m = _eddy_model(npt, dtype=torch.float64, device="cpu", **BRANCHES[branch])
    keys = HELD[branch]
    assert sorted(m._held) == sorted(keys) and m.build_seconds["patterns"] >= 0
    vals0 = {k: m._held[k].vals for k in keys}
    built = {k: v.clone() for k, v in vals0.items()}
    rng = np.random.default_rng(8)
    xs = {k: torch.as_tensor(rng.standard_normal(
        m.fe.spaces.n_p if k == "A_up_e" else 3 * m.fe.spaces.p_space.ndof)) for k in keys}

    def follows(ops, ks):
        for k in ks:
            op = m._held[k]
            assert op.vals is vals0[k], k
            fresh = A.AssembledBlocks(op.pattern, op.mode, torch.float64, op.cd).fill(ops[k])
            assert torch.equal(op.vals, fresh.vals), k
            y, y0 = op.matvec(xs[k]), _k1_plain(m, ops, k, xs[k])
            assert float((y - y0).abs().max()) <= 1e-12 * float(y0.abs().max()), k

    follows(m.ops, keys)
    st = m.set_b(m.rest_state(), BIC)
    m._held["A_up_e"].vals.zero_()
    m._eddy_rebuild(m.ops, st)
    follows(m.ops, ["A_up_e"])
    for k in keys:
        m._held[k].vals.zero_()
    ops = m.refresh_precond(m.ops, st)
    follows(ops, keys)
    coarse = [k for k in keys if k != "A_up_e"]
    assert all(float((vals0[k] - built[k]).abs().max()) > 0 for k in coarse)  # nu changed
    copied = {k: v.clone() for k, v in ops.items()}
    for k in keys:
        copied[k].mul_(2.0)
    m.ops = copied
    follows(copied, keys)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cpu_model_steps_through_the_assembled_blocks(branch, monkeypatch):
    """A CPU PGModel on each branch applies its coarse P1 vector blocks and
    its P2-P1 coupling through the block plain version, never through
    K1's P1 "uu" or any K1 "up", and its steps take the JAX model's
    iteration counts from the same state and tensors."""
    assert_same_rcm_branch()
    mt = _eddy_model(npt, dtype=torch.float64, device="cpu", **BRANCHES[branch])
    mj = _eddy_model(npj, **BRANCHES[branch])
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    k1, vb = [], []
    k1_plain, vb_plain = K.saddle_matvec_plain, K.vblock_matvec_plain
    monkeypatch.setattr(K, "saddle_matvec_plain", lambda *a: k1.append(
        (a[7], a[4].shape[1], a[5].shape[1])) or k1_plain(*a))
    monkeypatch.setattr(K, "vblock_matvec_plain",
                        lambda *a: vb.append((a[4], a[5])) or vb_plain(*a))
    sj = mj.set_b(mj.rest_state(), BIC)
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in STATE}, "cpu")
    ops_j = mj.ops
    for _ in range(2):
        ops_j, sj, auxj = mj.step_jit(ops_j, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"]) > 0
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0
        for f in ("u", "p", "b"):
            a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
            assert np.abs(a - b).max() <= 1e-9 * np.abs(a).max(), f
    nu, nv = mt.fe.spaces.u_space.ndof, mt.fe.spaces.p_space.ndof
    assert {("uu", nv), ("up", nu)} <= set(vb)
    assert not [c for c in k1 if c[0] == "up" or (c[0] == "uu" and c[1] == 4)], k1
    assert ("full", 10, 4) in k1  # the fine operator stays on K1's path


def test_northstar_full_steps_with_jax_counts(monkeypatch):
    """The north-star full physics (convection, eddy closure, wind) on a
    coarse bowl: 10 steps (the eddy rebuild rewrites A_up_e in the
    tenth), refresh_precond, and 2 steps more, every step with the JAX
    model's CG and FGMRES counts, the P2-P1 coupling on its assembled
    blocks throughout."""
    from nupgcm_tpu.tools import northstar as nj

    from nupgcm_tpu_torch.tools import northstar as nt

    assert_same_rcm_branch()
    bowl_j = npj.generators.bowl3D
    monkeypatch.setattr(npj.generators, "bowl3D", lambda h, a, nz: bowl_j(0.35, a, nz=3))
    monkeypatch.setattr(nt, "reference_mesh",
                        lambda: (npt.generators.bowl3D(0.35, 0.5, nz=3), "coarse bowl3D"))
    mj, _ = nj.build_model("full")
    mt, _ = nt.build_model("full", dtype=torch.float64, device="cpu")
    assert "A_up_e" in mt._held
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    sj = mj.rest_state()
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in STATE}, "cpu")
    ops_j, counts = mj.ops, []
    for i in range(12):
        if i == 10:
            mj.ops = ops_j
            ops_j = mj.refresh_precond(ops_j, sj)
            mt.ops = mt.refresh_precond(mt.ops, st)
        ops_j, sj, auxj = mj.step_jit(ops_j, sj)
        st, aux = mt.step(st)
        counts.append((aux["evo_iters"], aux["inv_iters"]))
        assert counts[-1] == (int(auxj["evo_iters"]), int(auxj["inv_iters"])), i
    assert any(c[1] > 0 for c in counts[10:])
    y = mt._held["A_up_e"].matvec(torch.ones(mt.fe.spaces.n_p, dtype=torch.float64))
    y0 = _k1_plain(mt, mt.ops, "A_up_e", torch.ones(mt.fe.spaces.n_p, dtype=torch.float64))
    assert float((y - y0).abs().max()) <= 1e-12 * float(y0.abs().max())


def _c_fields(struct: str):
    """(name, ctypes type) of each field of ``struct`` in
    csrc/vertex_block_matvec.cu, in order."""
    src = (ROOT / "nupgcm_tpu_torch" / "csrc" / "vertex_block_matvec.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        m = re.match(r"(.*?[\s*])(\w+(?:\s*,\s*\w+)*)$", decl, re.S)
        ctype, names = m.group(1).strip(), [n.strip() for n in m.group(2).split(",")]
        kind = (ctypes.c_void_p if ctype.endswith("*") else
                {"long long": ctypes.c_longlong, "int": ctypes.c_int}[ctype])
        out += [(n, kind) for n in names]
    return out


def test_vb_params_follow_the_c_struct():
    """_VbParams holds the fields of struct VbLaunch, in its order and of
    its types."""
    assert list(K._VbParams._fields_) == _c_fields("VbLaunch")
    assert ctypes.sizeof(K._VbParams) == 64


def test_block_wrapper_refuses_wrong_shapes():
    """The wrapper counts a plain call of each new case and no launch, and
    refuses values in the other layout, x of the wrong length (the row
    count where "up" takes the column count), a rectangular pattern in
    "uu", and a launch on the CPU."""
    cd_u = torch.tensor([[0, 1, 2, 3, 4, 5]], dtype=torch.int32)
    cd_p = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    up_pat = A.vertex_pattern(cd_u, 6, cd_p, 3)
    uu_pat = A.vertex_pattern(cd_p[:, :2].contiguous(), 2)
    assert (up_pat.n_blocks, up_pat.sizes, uu_pat.n_blocks) == (18, (6, 3), 4)
    up = torch.ones((up_pat.n_blocks, 3), dtype=torch.float64)
    uu = torch.ones((uu_pat.n_blocks, 9), dtype=torch.float64)
    K.reset_counts()
    y = K.vblock_matvec(up, up_pat.col, up_pat.row_ptr, up_pat.row,
                        torch.ones(3, dtype=torch.float64), "up", n_cols=3)
    assert torch.equal(y, torch.full((18,), 3.0, dtype=torch.float64))
    y = K.vblock_matvec(uu, uu_pat.col, uu_pat.row_ptr, uu_pat.row,
                        torch.ones(6, dtype=torch.float64), "uu")
    assert torch.equal(y, torch.full((6,), 6.0, dtype=torch.float64))
    assert K.plain_calls["vblock"] == 2 and not any(K.launches.values())
    with pytest.raises(ValueError, match=r"shape \(n_blocks, 9\)"):
        K.vblock_matvec(uu.t().contiguous(), uu_pat.col, uu_pat.row_ptr, uu_pat.row,
                        torch.ones(6, dtype=torch.float64), "uu")
    with pytest.raises(ValueError, match="must be a vector over the 6 x 3 pattern"):
        K.vblock_matvec(up, up_pat.col, up_pat.row_ptr, up_pat.row,
                        torch.ones(6, dtype=torch.float64), "up", n_cols=3)
    with pytest.raises(ValueError, match="needs a square pattern"):
        K.VBlockLaunch(torch.ones((up_pat.n_blocks, 9), dtype=torch.float64), up_pat.col,
                       up_pat.row_ptr, "uu", (6, 3), n_cols=3)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.VBlockLaunch(up, up_pat.col, up_pat.row_ptr, "up", up_pat.sizes, 3)
    op = A.AssembledBlocks(up_pat, "up", torch.float64)
    with pytest.raises(ValueError, match="must be a vector"):
        op.matvec(torch.ones(6, dtype=torch.float64))
