"""The u-block two-grid preconditioner (``saddle_coarse=False,
twogrid=True``) of the port against nupgcm_tpu, in f64 on the CPU.

  * Steps: the bowl3D(0.25, 0.5, nz=4) mixing configuration (220
    vertices) with dt = 0.05 on both coarse branches -- the dense
    Cholesky inverse (3 n_vertices <= coarse_dense_max) and the
    element-local P1 operator with inner CG (``coarse_dense_max=256``):
    the same operators (1e-12), and from the same numpy state and
    element tensors, the same per-step iteration counts (72, 12, 12)
    and u, p, b within 1e-9 relative over 3 steps.
  * ``refresh_precond`` with an eddy closure: on the element branch
    ``coarse_e`` and ``coarse_dinv`` match JAX's refresh to 1e-12; on
    the dense branch JAX's refresh raises ``KeyError`` (it reads
    ``coarse_e``, which that branch never sets) while the port rebuilds
    ``coarse_inv``, which matches JAX's own ``_assemble_coarse`` on the
    same viscosity.
"""

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import ops_from_numpy, state_from_numpy
from nupgcm_tpu_torch.tools._common import initial_b
from test_torch_model import _mixing
from test_torch_refresh import _eddy3d
from torch_parity import assert_same_rcm_branch

TWOGRID = dict(saddle_coarse=False, twogrid=True)
BRANCHES = {"dense": {}, "element": dict(coarse_dense_max=256)}
FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")


@pytest.fixture(autouse=True)
def _two_threads():
    """These meshes gain nothing from many CPU threads, and under the
    suite's parallel workers many threads thrash: two per test."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_twogrid_steps_match(branch):
    assert_same_rcm_branch()
    kw = {**TWOGRID, **BRANCHES[branch]}
    mj = _mixing(npj, npj.generators.bowl3D(0.25, 0.5, nz=4), 0.05, **kw)
    mt = _mixing(npt, npt.generators.bowl3D(0.25, 0.5, nz=4), 0.05,
                 dtype=torch.float64, device="cpu", **kw)
    dense = branch == "dense"
    assert mt.fe.mesh.n_vertices == 220 and mt.coarse_dense == mj.coarse_dense == dense
    assert mt.preconditioner_branch == ("u-block two-grid, dense coarse" if dense
                                        else "u-block two-grid, element coarse + CG")
    for k in ("saddle_coarse", "twogrid", "inner_method", "inner_iters", "inv_opts",
              "evo_opts"):
        assert getattr(mt, k) == getattr(mj, k), k
    assert mt.inner_iters == (4, 5)
    assert sorted(mt.ops) == sorted(mj.ops)
    assert ("coarse_inv" in mt.ops) == dense and ("coarse_e" in mt.ops) == (not dense)
    for k, v in mj.ops.items():
        assert _rel(v, mt.ops[k]) <= 1e-12, k
    sj = mj.set_b(mj.rest_state(), initial_b)
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    iters = []
    for i in range(3):
        _, sj, auxj = mj.step_jit(mj.ops, sj)
        st, aux = mt.step(st)
        assert aux["evo_iters"] == int(auxj["evo_iters"]) > 0, i
        assert aux["inv_iters"] == int(auxj["inv_iters"]) > 0, i
        iters.append(aux["inv_iters"])
        for f in ("u", "p", "b"):
            assert _rel(getattr(sj, f), getattr(st, f)) <= 1e-9, (i, f)
    assert iters == [72, 12, 12]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_twogrid_refresh(branch):
    kw = {**TWOGRID, **BRANCHES[branch]}
    mj = _eddy3d(npj, **kw)
    mt = _eddy3d(npt, dtype=torch.float64, device="cpu", **kw)
    dense = branch == "dense"
    assert mt.twogrid and mt.coarse_dense == dense
    sj = mj.set_b(mj.rest_state(), initial_b)
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    old = {k: v.clone() for k, v in mt.ops.items()}
    new_t = mt.refresh_precond(mt.ops, st)
    assert sorted(new_t) == sorted(old)
    for k, v in old.items():
        assert new_t[k].shape == v.shape and new_t[k].dtype == v.dtype, k
    key = "coarse_inv" if dense else "coarse_e"
    assert float((new_t[key] - old[key]).abs().max()) > 0  # really updated
    if dense:
        with pytest.raises(KeyError, match="coarse_e"):
            mj.refresh_precond(mj.ops, sj)
        nu_q = mt.forcings.eddy_param.nu(mt.const["f_eddy_q"], mt._abz(st.b))
        ref = {}
        mj._assemble_coarse(ref, nu_q.numpy())
        assert _rel(ref["coarse_inv"], new_t["coarse_inv"]) <= 1e-12
    else:
        new_j = mj.refresh_precond(mj.ops, sj)
        for k in ("coarse_e", "coarse_dinv", "visc_e", "visc_dinv", "A_uu_e"):
            assert _rel(new_j[k], new_t[k]) <= 1e-12, k
    # the refreshed preconditioner still converges
    mt.ops = new_t
    st2, aux = mt.step(st)
    assert 0 < aux["inv_iters"] < mt.inv_opts["itmax"]
    assert np.isfinite(st2.u.numpy()).all()


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_twogrid_kernel_cases(branch):
    """tools/kernel_bench lists the element branch's P1 vector coarse
    block (the case the card's smoke run holds against plain), computed
    blocked from the model's own tables equal to the coarse operator
    the preconditioner applies (1e-12 of max|y|, f64); the dense branch
    has no such case."""
    from nupgcm_tpu_torch.ops import blocks
    from nupgcm_tpu_torch.tools import kernel_bench

    mt = _mixing(npt, npt.generators.bowl3D(0.25, 0.5, nz=4), 0.05, dtype=torch.float64,
                 device="cpu", **TWOGRID, **BRANCHES[branch])
    cases = [c for c in kernel_bench.kernel_cases(mt)
             if c["label"] == "P1 vector two-grid coarse block"]
    assert len(cases) == (branch == "element")
    if not cases:
        return
    (case,) = cases
    assert case["mode"] == "uu" and case["blocks"][0].shape[1:] == (12, 12)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(case["n_x"]))
    tu, tp = mt.const[case["key"]]["uu"]
    y = blocks.blocked_saddle_plain(*case["blocks"], tu, tp, x, "uu", case["n_nodes"])
    y0 = mt._coarse_operator(mt.ops["coarse_e"]).matvec(x)
    assert _rel(y0, y) < 1e-12
