"""Block tables of the port's element-matvec kernel (nupgcm_tpu_torch/ops/blocks.py).

The CUDA kernel (csrc/element_matvec.cu) cuts cells into blocks of B
cells and reads, per block, a sorted list of unique dofs and each
(cell, slot)'s index into it.  These tests check the tables, and check
the kernel's blocked algorithm written in plain PyTorch
(``blocked_saddle_plain`` / ``blocked_scalar_plain``, which read only
the tables: gather each block's unique x, apply the cell blocks, add
per block) against the JAX package's operators on the same random
tensors: the take-path SaddleOperator / ElementOperator everywhere, and
the Pallas kernels (ops/window.py, interpret mode, as
tests/test_window.py runs them) on the 3D tet tables.  Cases: P2-P1
tets, the P1-P1 coarse tables, 2D triangles, the RCM cell order and a
shuffled one (the widest block lists), a block size that does not
divide the cell count, and padded cells.  Bars: f64 1e-12, f32 2e-6 of
max|y|.  The kernel itself runs only on the card (chip_smoke.py).
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nupgcm_tpu as npj
from nupgcm_tpu.fem.assembly import build_vector_plan
from nupgcm_tpu.ops import window as W
from nupgcm_tpu.ops.element import ElementOperator as JElement
from nupgcm_tpu.ops.element import SaddleOperator as JSaddle
from nupgcm_tpu_torch.ops import blocks
from nupgcm_tpu_torch.ops import kernels as K
from nupgcm_tpu_torch.ops.element import ElementOperator, SaddleOperator

BARS = {"float64": 1e-12, "float32": 2e-6}
SHUFFLED_B = 20  # does not divide the padded cell counts below


def _fe(dim):
    mesh = (npj.generators.bowl3D(0.35, 0.5, nz=3) if dim == 3
            else npj.generators.bowl2D(0.1, 0.5))
    spaces = npj.Spaces(mesh, u_diri_tags=[], u_diri_vals=[],
                        b_diri_tags=[], b_diri_vals=[])
    return npj.FEData(mesh, spaces)


@pytest.fixture(scope="module")
def fes():
    return {3: _fe(3), 2: _fe(2)}


def _tables_of(fe, family):
    """(cd_u, cd_p, n_u_nodes, n_p) of the fine P2-P1 or the P1-P1 coarse operator."""
    sp = fe.spaces
    if family == "coarse":
        return fe.cd_p, fe.cd_p, sp.n_p, sp.n_p
    return fe.cd_u, fe.cd_p, sp.u_space.ndof, sp.n_p


def _order(nc, order):
    return (np.arange(nc) if order == "rcm"
            else np.random.default_rng(11).permutation(nc))


def test_meshes_have_padding_and_a_ragged_last_block(fes):
    for fe in fes.values():
        assert fe.n_cells_padded > fe.mesh.n_cells
        assert fe.n_cells_padded % SHUFFLED_B != 0


@pytest.mark.parametrize("order", ["rcm", "shuffled"])
@pytest.mark.parametrize("cells", [4, SHUFFLED_B, 64])
@pytest.mark.parametrize("table", ["u", "p", "b"])
@pytest.mark.parametrize("dim", [3, 2])
def test_block_tables_reconstruct_the_dof_table(fes, dim, table, cells, order):
    fe = fes[dim]
    cd = {"u": fe.cd_u, "p": fe.cd_p, "b": fe.cd_b}[table]
    cd = cd[_order(cd.shape[0], order)]
    t = blocks.build(cd, cells)
    nc, nl = cd.shape
    assert (t.nc, t.nl, t.cells, t.nblk) == (nc, nl, cells, -(-nc // cells))
    assert t.lists.dtype == torch.int32 and t.list_stride % 4 == 0
    assert t.slot.dtype == torch.int16 and t.slot.shape == (nc, nl)
    lists, slot = t.lists.numpy(), t.slot.numpy().astype(np.int64)
    blk = np.arange(nc) // cells
    np.testing.assert_array_equal(lists[blk[:, None], blocks.HEADER + slot], cd)
    counts = lists[:, 0]
    assert t.max_count == counts.max() and t.list_stride >= blocks.HEADER + counts.max()
    for b in range(t.nblk):
        lst = t.block_lists(b).numpy()
        np.testing.assert_array_equal(lst, np.unique(cd[b * cells:(b + 1) * cells]))
    assert (slot >= 0).all() and (slot < counts[blk][:, None]).all()
    # the kernel's copy of the slots: block by block, 16-byte strides
    assert t.slot_stride % 8 == 0 and t.slot_stride >= cells * nl
    sb = t.slot_blocks.numpy().reshape(t.nblk, t.slot_stride)
    local = np.arange(nc) % cells
    np.testing.assert_array_equal(
        sb[blk[:, None], local[:, None] * nl + np.arange(nl)], slot)


def _random_saddle(fe, family, mode, dtype, order, seed):
    cd_u, cd_p, n, n_p = _tables_of(fe, family)
    perm = _order(cd_u.shape[0], order)
    cd_u, cd_p = cd_u[perm], cd_p[perm]
    nc, nlu = cd_u.shape
    nlp = cd_p.shape[1]
    rng = np.random.default_rng(seed)
    T = {k: rng.standard_normal(s).astype(dtype) for k, s in {
        "uu": (nc, 3 * nlu, 3 * nlu), "up": (nc, 3 * nlu, nlp),
        "pu": (nc, nlp, 3 * nlu), "pp": (nc, nlp, nlp)}.items()}
    n_x = {"full": 3 * n + n_p, "full_pp": 3 * n + n_p, "uu": 3 * n, "up": n_p}[mode]
    return T, cd_u, cd_p, n, n_p, rng.standard_normal(n_x).astype(dtype)


def _jax_take(T, cd_u, cd_p, n, n_p, x, mode):
    cdp = cd_p if mode != "uu" else cd_p[:, :0]
    sop = JSaddle(
        uu=jnp.asarray(T["uu"]),
        up=None if mode == "uu" else jnp.asarray(T["up"]),
        pu=None if mode == "uu" else jnp.asarray(T["pu"]),
        pp=jnp.asarray(T["pp"]) if mode == "full_pp" else None,
        cd_u=jnp.asarray(cd_u, jnp.int32), cd_p=jnp.asarray(cdp, jnp.int32),
        u_plan=build_vector_plan(cd_u, n), p_plan=build_vector_plan(cd_p, n_p),
        n_u_nodes=n)
    if mode == "up":
        return np.asarray(sop.up_matvec(jnp.asarray(x)))
    return np.asarray(sop.matvec(jnp.asarray(x)))


def _jax_window(T, cd_u, cd_p, n, n_p, x, mode):
    plan = W.build_window_plan(cd_u, cd_p, n, n_p, B=128)
    J = {k: jnp.asarray(v) for k, v in T.items()}
    uu_b, up_b, pu_b = W.blocked_saddle_tensors(
        J["uu"], None if mode == "uu" else J["up"], None if mode == "uu" else J["pu"], plan)
    pp_b = W.blocked_pp_tensor(J["pp"], plan) if mode == "full_pp" else None
    W._INTERPRET = True
    try:
        return np.asarray(W.saddle_matvec(uu_b, up_b, pu_b, jnp.asarray(x), plan, mode,
                                          pp_b=pp_b))
    finally:
        W._INTERPRET = False


def _close(y, y0, dtype):
    assert y.shape == y0.shape
    assert np.abs(y - y0).max() <= BARS[dtype] * np.abs(y0).max()


@pytest.mark.parametrize("order", ["rcm", "shuffled"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("family,mode", [("fine", "full"), ("fine", "uu"), ("fine", "up"),
                                         ("coarse", "full_pp"), ("coarse", "uu"),
                                         ("coarse", "up")])
@pytest.mark.parametrize("dim", [3, 2])
def test_blocked_saddle_matches_jax(fes, dim, family, mode, dtype, order):
    fe = fes[dim]
    T, cd_u, cd_p, n, n_p, x = _random_saddle(fe, family, mode, dtype, order, seed=dim)
    item = np.dtype(dtype).itemsize
    if order == "rcm":  # the model's block size
        tu, tp = blocks.saddle_tables(cd_u, cd_p, mode, item)
    else:
        tu, tp = blocks.build(cd_u, SHUFFLED_B), blocks.build(cd_p, SHUFFLED_B)
    t = {k: torch.from_numpy(v) if k in K._USED[mode] else None for k, v in T.items()}
    y = blocks.blocked_saddle_plain(t["uu"], t["up"], t["pu"], t["pp"], tu,
                                    None if mode == "uu" else tp, torch.from_numpy(x),
                                    mode, n).numpy()
    _close(y, _jax_take(T, cd_u, cd_p, n, n_p, x, mode), dtype)
    if dim == 3 and order == "rcm":
        _close(y, _jax_window(T, cd_u, cd_p, n, n_p, x, mode), dtype)


@pytest.mark.parametrize("order", ["rcm", "shuffled"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("space", ["b", "p"])
@pytest.mark.parametrize("dim", [3, 2])
def test_blocked_scalar_matches_jax(fes, dim, space, dtype, order):
    fe = fes[dim]
    cd = fe.cd_b if space == "b" else fe.cd_p
    cd = cd[_order(cd.shape[0], order)]
    n = fe.spaces.n_b if space == "b" else fe.spaces.n_p
    nc, nl = cd.shape
    rng = np.random.default_rng(5)
    ae = rng.standard_normal((nc, nl, nl)).astype(dtype)
    x = rng.standard_normal(n).astype(dtype)
    t = (blocks.scalar_table(cd, np.dtype(dtype).itemsize) if order == "rcm"
         else blocks.build(cd, SHUFFLED_B))
    y = blocks.blocked_scalar_plain(torch.from_numpy(ae), t, torch.from_numpy(x)).numpy()
    op = JElement(Ae=jnp.asarray(ae), cd_rows=jnp.asarray(cd, jnp.int32),
                  cd_cols=jnp.asarray(cd, jnp.int32), row_plan=build_vector_plan(cd, n))
    _close(y, np.asarray(op.matvec(jnp.asarray(x))), dtype)


@pytest.mark.parametrize("nc,cell_bytes,expect", [
    (23392, 4560, 4),     # P2-P1 "full", f32, the h = 0.08 slice
    (23392, 3600, 4),     # P2 "uu", f32
    (23392, 9120, 4),     # "full" in f64
    (23392, 1024, 16),    # P1-P1 "full_pp", f32
    (23392, 480, 32),     # P2-P1 "up", f32
    (23392, 64, 48),      # K2 nl = 4, f32: capped by the block count
    (336072, 64, 256),    # K2 nl = 4 at h = 0.02: capped by MAX_CELLS
    (344, 4560, 4),       # a small mesh
])
def test_cells_per_block(nc, cell_bytes, expect):
    b = blocks.cells_per_block(nc, cell_bytes)
    assert b == expect and b % blocks.CELL_MULTIPLE == 0
    assert b == blocks.CELL_MULTIPLE or b * cell_bytes <= blocks.STAGE_BYTES


def _op_tensors(nc=8, nlu=10, nlp=4, dtype=torch.float64):
    cd_u = torch.zeros((nc, nlu), dtype=torch.int32)
    cd_p = torch.zeros((nc, nlp), dtype=torch.int32)
    return dict(uu=torch.zeros((nc, 3 * nlu, 3 * nlu), dtype=dtype),
                up=torch.zeros((nc, 3 * nlu, nlp), dtype=dtype),
                pu=torch.zeros((nc, nlp, 3 * nlu), dtype=dtype), cd_u=cd_u, cd_p=cd_p,
                n_u_nodes=1, n_p=1)


@pytest.mark.parametrize("fault,match", [
    (dict(uu=torch.zeros((8, 30, 29), dtype=torch.float64)), "block uu has shape"),
    (dict(up=torch.zeros((8, 30, 4), dtype=torch.float32)), "one float type"),
    (dict(pu=torch.zeros((8, 3, 30), dtype=torch.float64)), "block pu has shape"),
    (dict(cd_p=torch.zeros((7, 4), dtype=torch.int32)), "over the same cells"),
    (dict(pp=torch.zeros((8, 4, 4), dtype=torch.float32)), "one float type"),
])
def test_saddle_operator_refuses_bad_tensors_at_construction(fault, match):
    with pytest.raises(ValueError, match=match):
        SaddleOperator(**{**_op_tensors(), **fault})


@pytest.mark.parametrize("ae", [torch.zeros((8, 4, 3), dtype=torch.float64),
                                torch.zeros((8, 4, 4), dtype=torch.int64)])
def test_element_operator_refuses_bad_tensors_at_construction(ae):
    with pytest.raises(ValueError, match="must be a float"):
        ElementOperator(Ae=ae, cd=torch.zeros((8, 4), dtype=torch.int32), n=1)


def test_prepared_launch_is_for_cuda_tensors_only():
    t = _op_tensors()
    tables = blocks.saddle_tables(t["cd_u"], t["cd_p"], "full", 8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.saddle_launch(t["uu"], t["up"], t["pu"], None, tables, "full", 1, 1)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        K.scalar_launch(torch.zeros((8, 4, 4)), blocks.build(t["cd_p"], 4), 1)


def test_launch_params_mirror_the_c_struct():
    # struct EmLaunch: 8 pointers, 4 long long, 14 int, 1 pointer
    assert ctypes.sizeof(K._LaunchParams) == 160
    assert K._LaunchParams.launcher.offset == 152
    assert K._LaunchParams.nblk.offset == 96


def test_model_builds_block_tables_once_and_operators_share_them():
    import nupgcm_tpu_torch as npt
    from nupgcm_tpu_torch.tools._common import mixing_setup

    model = mixing_setup(npt.generators.bowl3D(0.35, 0.5, nz=3), "cpu", torch.float64)
    c, fe = model.const, model.fe
    tu, tp = c["blk_fine"]["full"]
    assert c["blk_fine"]["uu"][1] is None and c["blk_coarse"]["full_pp"][0].nl == 4
    for t, cd in ((tu, fe.cd_u), (tp, fe.cd_p), (c["blk_b"], fe.cd_b), (c["blk_p"], fe.cd_p)):
        blk = np.arange(t.nc) // t.cells
        np.testing.assert_array_equal(
            t.lists.numpy()[blk[:, None], blocks.HEADER + t.slot.numpy()], cd)
    assert model._inv_matrix(model.ops).tables is c["blk_fine"]
    assert model._visc_operator(model.ops["visc_e"]).tables is c["blk_fine"]
    assert model._evo_matrix(model.ops, 0.5).table is c["blk_b"]
    ops = model.refresh_precond(model.ops, model.rest_state())
    assert model._mp_operator(ops).table is c["blk_p"]


@pytest.fixture(scope="module")
def model():
    import nupgcm_tpu_torch as npt
    from nupgcm_tpu_torch.tools._common import mixing_setup

    # the production branch: iterative saddle coarse + aggregate level
    return mixing_setup(npt.generators.bowl3D(0.35, 0.5, nz=3), "cpu", torch.float64,
                        coarse_dense_max=256)


def test_every_kernel_case_of_the_model_runs_blocked_on_its_tables(model):
    """Each K1/K2 case the step runs (tools/kernel_bench.py), computed
    blocked from the model's own block tables, equals the plain version
    at 1e-12 of max|y| (f64)."""
    from nupgcm_tpu_torch.tools import kernel_bench

    cases = kernel_bench.kernel_cases(model)
    assert {c["mode"] for c in cases} == {"full", "up", "uu", "full_pp", None}
    assert len(cases) == 10
    rng = np.random.default_rng(6)
    for case in cases:
        x = torch.as_tensor(rng.standard_normal(case["n_x"]))
        tables = model.const[case["key"]]
        if case["mode"] is None:
            y = blocks.blocked_scalar_plain(*case["blocks"], tables, x)
            y0 = K.scalar_matvec_plain(*case["blocks"], *case["cd"], x)
        else:
            tu, tp = tables[case["mode"]]
            y = blocks.blocked_saddle_plain(*case["blocks"], tu, tp, x, case["mode"],
                                            case["n_nodes"])
            y0 = K.saddle_matvec_plain(*case["blocks"], *case["cd"], x, case["mode"],
                                       case["n_nodes"])
        _close(y.numpy(), y0.numpy(), "float64")


def test_kernel_bench_needs_cuda():
    from nupgcm_tpu_torch.tools import kernel_bench

    with pytest.raises(RuntimeError, match="CUDA"):
        kernel_bench.run(("slice",))
