"""The port's domain decomposition against nupgcm_tpu's DDModel(., 8) on
the CPU: the step on the same numpy state at tests/test_parallel.py's
bar, and DD checkpoints written by either package loaded in the other.
"""

import numpy as np
import pytest

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.parallel.dd import DDModel as DDModelJ
from nupgcm_tpu_torch.parallel.dd import DDModel
from torch_dd_cases import (ALPHA, NO_COARSE, TIGHT, bdf2, bic, bowl, bowl015, eddy,
                            maxdiff, state_np)
from torch_parity import assert_same_rcm_branch, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
MESH_008 = lambda npg: npg.generators.bowl2D(0.08, ALPHA)  # noqa: E731


def test_dd_step_matches_jax_ddmodel():
    """The port's DDModel(., 8) against nupgcm_tpu's on the same
    configuration: the same partition (halo depths, per-shard cell
    order), and three steps to machine precision."""
    assert_same_rcm_branch()
    m = bowl(npt, MESH_008(npt), bdf2(), NO_COARSE)
    dd = DDModel(m, 8)
    s2 = dd.run(m.rest_state(), n_info=0, max_steps=3)
    mj = bowl(npj, MESH_008(npj), bdf2(), NO_COARSE)
    ddj = DDModelJ(mj, 8)
    assert (ddj.part_u.K, ddj.part_p.K, ddj.part_b.K, ddj.nc_max) == (
        dd.part_u.K, dd.part_p.K, dd.part_b.K, dd.nc_max)
    np.testing.assert_array_equal(ddj.cell_order, dd.cell_order[:, : ddj.nc_max])
    sj = ddj.run(mj.rest_state(), max_steps=3)
    for f in ("u", "b", "p"):
        assert maxdiff(sj, s2, f) < 1e-12, f


def test_dd_checkpoint_exchange_with_jax(tmp_path):
    """A DD checkpoint written by either package loads in the other (the
    JAX DDModel's keys and layout, the eddy blocks included): loaded
    states are bitwise the written ones, and two more steps in the other
    package land on the writer's own four-step state."""
    assert_same_rcm_branch()
    mt = bowl015(npt, eddy(npt), **TIGHT)
    mj = bowl015(npj, eddy(npj), **TIGHT)
    ddt, ddj = DDModel(mt, 8), DDModelJ(mj, 8)
    st0 = mt.set_b(mt.rest_state(), bic)
    svt = ddt.to_dd(st0)
    svj = ddj.to_dd(mj.set_b(mj.rest_state(), bic))
    for _ in range(2):
        svt, _ = ddt.step(svt)
        svj, _ = ddj.step(svj)

    # port -> JAX
    ddt.save_checkpoint(svt, str(tmp_path / "t"))
    svj2 = ddj.load_checkpoint(str(tmp_path / "t"))
    for k in ("A_uu_e", "u", "b"):
        a = np.asarray(svj2[k])
        b = ddt.group.all_gather(svt[k]).numpy()
        b = b[:, : ddt.nc_max].reshape(a.shape) if k == "A_uu_e" else b.reshape(-1)
        np.testing.assert_array_equal(a, b)
    # JAX -> port
    ddj.save_checkpoint(svj, str(tmp_path / "j"))
    svt2 = ddt.load_checkpoint(str(tmp_path / "j"))
    for a, b in zip(state_np(ddt.from_dd(svt2)).values(), state_np(ddj.from_dd(svj)).values()):
        np.testing.assert_array_equal(a, b)
    assert svt2["step"] == 2 and float(svt2["t"]) == float(svj["t"])

    for _ in range(2):
        svt, _ = ddt.step(svt)
        svj, _ = ddj.step(svj)
        svt2, _ = ddt.step(svt2)
        svj2, _ = ddj.step(svj2)
    for f in ("u", "b", "p"):
        assert maxdiff(ddt.from_dd(svt), ddj.from_dd(svj2), f) < 1e-12, f
        assert maxdiff(ddj.from_dd(svj), ddt.from_dd(svt2), f) < 1e-12, f
