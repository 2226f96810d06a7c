"""The P1 pressure mass on assembled vertex blocks
(nupgcm_tpu_torch/ops/assembled.py ``AssembledBlocks`` in mode
"scalar") against the JAX package's.

On the CPU the block wrapper runs its plain version (a gather, a
multiply and an ``index_add_`` over the blocks' rows); it is held, on
the square (cd_p, cd_p) vertex pattern with one value a block, against
the JAX Pallas kernel ``scalar_matvec`` (ops/window.py, in interpret
mode, as tests/test_window.py runs it) and against the JAX and the
port's element ``ElementOperator`` on the same seeded element tensors
(padded cells zero) and vectors, on a 3D bowl, a 2D bowl (triangles)
and the x-periodic channel.  Bars: f64 1e-12 max|y|, f32 2e-6 max|y|
(summation order; the bars of tests/test_torch_kernels.py).  The
diagonal keeps the element operator's bits; the model's held mass
follows every write of ``ops`` and is what every preconditioner branch
applies; the wrapper refuses wrong shapes.  The CUDA kernel itself runs
only on the card (chip_smoke.py phases 3, 3c, 8b, 9 and 11c).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.ops import element as EJ
from nupgcm_tpu.ops import window as W
from nupgcm_tpu_torch.ops import assembled as A
from nupgcm_tpu_torch.ops import kernels as K
from nupgcm_tpu_torch.ops.element import ElementOperator

ROOT = pathlib.Path(__file__).resolve().parents[1]
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
    """A seeded (nc, nl, nl) element tensor over the P1 dof table, zero on
    the padded cells (which repeat node 0), and x over the vertices."""
    rng = np.random.default_rng(seed)
    nc, nl = fe.cd_p.shape
    e = rng.standard_normal((nc, nl, nl)).astype(dtype)
    e[fe.mesh.n_cells:] = 0.0
    return e, rng.standard_normal(fe.spaces.n_p).astype(dtype)


def _mass(fe, e):
    cd = torch.from_numpy(np.ascontiguousarray(fe.cd_p).astype(np.int32))
    pat = A.vertex_pattern(cd, fe.spaces.n_p)
    return A.AssembledBlocks(pat, "scalar", e.dtype, cd).fill(e)


def _port(fe, e, x):
    return _mass(fe, torch.from_numpy(e)).matvec(torch.from_numpy(x)).numpy()


def _close(y, y0, dtype):
    assert y.shape == y0.shape
    assert np.abs(y - y0).max() <= BARS[dtype] * np.abs(y0).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mass_blocks_match_pallas_kernel(fe, interpret, dtype):
    _, fe = fe
    e, x = _case(fe, dtype, seed=1)
    nc = fe.cd_p.shape[0]
    plan = W.build_window_plan(fe.cd_p, np.zeros((nc, 0)), fe.spaces.n_p, 0, B=128)
    yw = W.scalar_matvec(W.blocked_scalar_tensor(jnp.asarray(e), plan), jnp.asarray(x), plan)
    _close(_port(fe, e, x), np.asarray(yw), dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mass_blocks_match_element_operator(fe, dtype):
    """Against the JAX take path and the port's element operator (K2's
    plain version); a vertex no cell references (the channel's periodic
    slaves) has an empty row and a zero output, as K2 leaves it."""
    name, fe = fe
    e, x = _case(fe, dtype, seed=2)
    cd = jnp.asarray(fe.cd_p, jnp.int32)
    y0 = np.asarray(EJ.ElementOperator(Ae=jnp.asarray(e), cd_rows=cd, cd_cols=cd,
                                       row_plan=fe.vec_plan_p).matvec(jnp.asarray(x)))
    y = _port(fe, e, x)
    _close(y, y0, dtype)
    ek = ElementOperator(Ae=torch.from_numpy(e), cd=torch.from_numpy(fe.cd_p.astype(np.int32)),
                         n=fe.spaces.n_p)
    _close(y, ek.matvec(torch.from_numpy(x)).numpy(), dtype)
    empty = np.setdiff1d(np.arange(fe.spaces.n_p), fe.cd_p)
    assert (len(empty) > 0) == (name == "channel")
    assert np.all(y[empty] == 0.0)


def test_mass_blocks_hold_each_entry_and_the_diagonal_bits(fe):
    """Block k holds the sum of the element entries over its vertex pair
    (slot), and the diagonal has the element operator's bits (f64 and
    f32), the JAX operator's to rounding."""
    _, fe = fe
    for dtype in ("float64", "float32"):
        e, _ = _case(fe, dtype, seed=3)
        op = _mass(fe, torch.from_numpy(e))
        nc, nl = fe.cd_p.shape
        k = op.pattern.slot.numpy().astype(np.int64)
        ref = np.zeros(op.pattern.n_blocks)
        np.add.at(ref, k.reshape(-1), e.astype(np.float64).reshape(-1))
        assert op.vals.shape == (op.pattern.n_blocks, 1)
        assert np.abs(op.vals.numpy()[:, 0] - ref).max() <= BARS[dtype] * np.abs(ref).max()
        ek = ElementOperator(Ae=torch.from_numpy(e),
                             cd=torch.from_numpy(fe.cd_p.astype(np.int32)), n=fe.spaces.n_p)
        assert torch.equal(op.diagonal(), ek.diagonal())
        cd = jnp.asarray(fe.cd_p, jnp.int32)
        d0 = np.asarray(EJ.ElementOperator(Ae=jnp.asarray(e), cd_rows=cd, cd_cols=cd,
                                           row_plan=fe.vec_plan_p).diagonal())
        _close(op.diagonal().numpy(), d0, dtype)


def _model(**kw):
    from nupgcm_tpu_torch.tools._common import mixing_setup

    return mixing_setup(npt.generators.bowl3D(0.35, 0.5, nz=3), "cpu", torch.float64, **kw)


# every preconditioner (coarse_dense_max 256: the iterative coarse levels)
PRECONDS = {"saddle_coarse": dict(coarse_dense_max=256), "dense_coarse": {},
            "twogrid": dict(saddle_coarse=False, twogrid=True, coarse_dense_max=256),
            "twogrid_dense": dict(saddle_coarse=False, twogrid=True),
            "no_coarse": dict(saddle_coarse=False, twogrid=False),
            "diag": dict(preconditioner="diag")}


@pytest.mark.parametrize("precond", list(PRECONDS))
def test_every_preconditioner_applies_the_mass_from_its_blocks(precond):
    """On every branch the model holds the mass on the vertex pattern
    (built once, timed in build_seconds["patterns"]) and no K2 table of
    it; mp_dinv has the element operator's bits and lmax_p its value to
    rounding (a power iteration through the blocks)."""
    from nupgcm_tpu_torch.ops.sparse import MaskedOperator
    from nupgcm_tpu_torch.solvers.preconditioners import power_lmax

    m = _model(**PRECONDS[precond])
    c, sp = m.const, m.fe.spaces
    op = m._mp_operator()
    assert op is m._held["Mp_e"] and op.mode == "scalar" and op.pattern is c["vblk_coarse"]
    assert "blk_p" not in c and m.build_seconds["patterns"] >= 0
    ek = ElementOperator(Ae=m.ops["Mp_e"], cd=c["cd_p"], n=sp.n_p)
    free_p = c["free_inv"][sp.n_u:]
    assert torch.equal(m.ops["mp_dinv"], 1.0 / MaskedOperator(ek, free_p).diagonal())
    lmax = power_lmax(MaskedOperator(ek, free_p), m.ops["mp_dinv"], sp.n_p)
    assert abs(float(m.ops["lmax_p"]) - float(lmax)) <= 1e-12 * float(lmax)


@pytest.mark.parametrize("precond", ["saddle_coarse", "dense_coarse"])
def test_held_mass_follows_every_write(precond):
    """The held mass keeps its values tensor and equals a fresh fill of
    ``ops["Mp_e"]`` after the build, a retune, a refresh_precond (which
    writes every other held tensor but not the mass) and an ops dict set
    on the model (the values wiped first, so a missing refill shows); its
    products are K2's plain version's (1e-12 of max|y|, f64)."""
    m = _model(**PRECONDS[precond])
    op = m._mp_operator()
    vals0 = op.vals
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(m.fe.spaces.n_p))

    def follows():
        assert m._mp_operator() is op and op.vals is vals0
        fresh = A.AssembledBlocks(op.pattern, "scalar", torch.float64, op.cd).fill(m.ops["Mp_e"])
        assert torch.equal(op.vals, fresh.vals)
        y, y0 = op.matvec(x), K.scalar_matvec_plain(m.ops["Mp_e"], m.const["cd_p"], x)
        assert float((y - y0).abs().max()) <= 1e-12 * float(y0.abs().max())

    follows()
    m.retune(saddle_coarse_inner=2, inner_iters_p=4)
    follows()
    mp_e = m.ops["Mp_e"]
    m.ops = m.refresh_precond(m.ops, m.rest_state())
    assert m.ops["Mp_e"] is mp_e
    follows()
    ops = dict(m.ops, Mp_e=2.0 * m.ops["Mp_e"])
    op.vals.zero_()
    m.ops = ops
    follows()
    assert float(op.vals.abs().max()) > 0


def test_mass_wrapper_refuses_wrong_shapes():
    """The wrapper counts a plain call of the mode and no launch, and
    refuses values of another width, x of another length, a rectangular
    pattern, and a launch on the CPU."""
    cd = torch.tensor([[0, 1, 2], [1, 2, 3]], dtype=torch.int32)
    pat = A.vertex_pattern(cd, 4)
    assert pat.n_blocks == 14
    vals = torch.ones((pat.n_blocks, 1), dtype=torch.float64)
    K.reset_counts()
    y = K.vblock_matvec(vals, pat.col, pat.row_ptr, pat.row, torch.ones(4, dtype=torch.float64),
                        "scalar")
    assert torch.equal(y, torch.tensor([3.0, 4.0, 4.0, 3.0], dtype=torch.float64))
    assert K.plain_calls["vblock"] == 1 and not any(K.launches.values())
    assert "vblock_scalar" in K.launches and K.VBLOCK_WIDTH["scalar"] == 1
    with pytest.raises(ValueError, match=r"shape \(n_blocks, 1\)"):
        K.vblock_matvec(torch.ones((pat.n_blocks, 3), dtype=torch.float64), pat.col,
                        pat.row_ptr, pat.row, torch.ones(4, dtype=torch.float64), "scalar")
    with pytest.raises(ValueError, match="must be a vector over the 4 x 4 pattern"):
        K.vblock_matvec(vals, pat.col, pat.row_ptr, pat.row, torch.ones(12, dtype=torch.float64),
                        "scalar")
    rect = A.vertex_pattern(cd, 4, cd[:, :2].contiguous(), 3)
    with pytest.raises(ValueError, match="needs a square pattern"):
        K.VBlockLaunch(torch.ones((rect.n_blocks, 1), dtype=torch.float64), rect.col,
                       rect.row_ptr, "scalar", rect.sizes, n_cols=3)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.VBlockLaunch(vals, pat.col, pat.row_ptr, "scalar", pat.sizes)
    op = A.AssembledBlocks(pat, "scalar", torch.float64, cd)
    with pytest.raises(ValueError, match="must be a vector"):
        op.matvec(torch.ones(5, dtype=torch.float64))


def test_mode_ids_follow_the_c_enum():
    """Every vertex-block mode's id (the element kernel's, ``_MODE_ID``)
    is the one the C side's ``enum Mode`` dispatches on, and the scalar
    mode's lane count is a compile-time constant of its own."""
    src = (ROOT / "nupgcm_tpu_torch" / "csrc" / "vertex_block_matvec.cu").read_text()
    enum = re.search(r"enum Mode \{([^}]*)\}", src).group(1)
    ids = {n: int(v) for n, v in re.findall(r"(\w+)\s*=\s*(\d+)", enum)}
    names = {"full_pp": "kFullPP", "uu": "kUU", "up": "kUP", "scalar": "kScalar"}
    assert set(names) == set(K.VBLOCK_MODES)
    assert {m: ids[names[m]] for m in names} == {m: K._MODE_ID[m] for m in names}
    from nupgcm_tpu_torch.tools import scalar_lanes

    assert len(scalar_lanes.GROUP.findall(src)) == 1
    assert int(scalar_lanes.GROUP.search(src).group(1)) in (8, 16)


def test_scalar_lanes_tool_needs_cuda():
    """tools/scalar_lanes.py measures the card and refuses to run without
    one."""
    from nupgcm_tpu_torch.tools import scalar_lanes

    with pytest.raises(RuntimeError, match="CUDA"):
        scalar_lanes.main([])
