"""The metric arithmetic: the frozen trace readers on a synthetic trace,
the metric readers on a synthetic record, and the operator-work count."""

import numpy as np
import pytest
import torch

from pgbench import spec
from pgbench import trace as tr
from pgbench import work as wk
from pgbench.hooks import Hooks
from pgbench.tests.small import small


def ev(cat, name, ts, dur, corr=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def synthetic():
    """Two pad spin kernels, then a span with three launches: two kernels
    that overlap and one memcpy, with host ops between them."""
    return [
        ev("cuda_runtime", "cudaLaunchKernel", 0, 1, 1), ev("kernel", "spin_kernel", 2, 5, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 1, 1, 2), ev("kernel", "spin_kernel", 7, 5, 2),
        ev("user_annotation", "pgbench.invert", 20, 100),
        ev("cpu_op", "aten::mul", 21, 4),
        ev("cuda_runtime", "cudaLaunchKernel", 22, 2, 3), ev("kernel", "k_a", 30, 10, 3),
        ev("cuda_runtime", "cudaLaunchKernel", 24, 2, 4), ev("kernel", "k_b", 35, 10, 4),
        ev("cpu_op", "aten::item", 50, 30),
        ev("cuda_runtime", "cudaMemcpyAsync", 52, 2, 5), ev("gpu_memcpy", "Memcpy DtoH", 65, 5, 5),
    ]


def test_frozen_readers_on_a_synthetic_trace():
    events = synthetic()
    lost = tr.lost_events(events)
    assert lost["launches"] == 5 and lost["lost"] == [] and lost["orphans"] == 0
    assert lost["lag_us"] == 2.0
    body = tr.without_pad(events)
    assert not any("spin" in e["name"] for e in body)
    summ = tr.trace_summary(body)
    assert summ["busy_us"] == pytest.approx(15 + 5)        # [30, 45] and [65, 70]
    assert summ["by_name"]["k_a"] == (1, 10.0)
    assert len(tr.launches_of(body)) == 3
    gaps = dict(tr.idle_gaps(body))
    assert gaps == {"pgbench.invert/aten::item": pytest.approx(20e-6)}
    # a launch whose device event is missing is lost, at its position
    events.pop(7)
    assert tr.lost_events(events)["lost"] == [2]


def test_metric_readers_on_a_synthetic_record():
    rec = {"steps": 10, "window_s": 2.0, "step_s": [0.1] * 9 + [1.1], "peak_bytes": 3 * 2**20,
           "setup_s": 4.5, "aux": [{"inv_iters": 7, "evo_iters": 3}] * 10,
           "spans_s": {"invert": 0.5, "evolve": 0.2},
           "trace": {"steps": 5, "launches": 500, "least_s": 0.02, "kernel_s": 0.05,
                     "busy_s": 0.06, "wall_s": 0.2}}
    read = lambda n: spec.reader(n)(rec)
    assert read("steps_per_s") == 5.0
    assert read("step_ms_p95") == pytest.approx(np.percentile([100] * 9 + [1100], 95))
    assert read("peak_mem_mib") == 3.0 and read("setup_s") == 4.5
    assert read("invert_ms_per_step") == pytest.approx(50.0)
    assert read("evolve_ms_per_step") == pytest.approx(20.0)
    assert read("fgmres_iters_per_step") == 7 and read("cg_iters_per_step") == 3
    assert read("launches_per_step") == 100
    assert read("kernels_roofline") == pytest.approx(40.0)
    assert read("step_mfu_pct") == pytest.approx(10.0)
    assert read("device_idle_pct") == pytest.approx(70.0)
    rec["trace"] = {"tries": 5, "wall_s": 0.2}           # every trace lost a launch
    for n in ("launches_per_step", "kernels_roofline", "step_mfu_pct", "device_idle_pct"):
        assert read(n) is None


def test_pair_counts_match_an_assembled_pattern():
    import scipy.sparse as sp

    from pgbench.reference.pg_bowl import Reference

    cfg, _ = small("bowl870k-spinup")
    model, mesh = spec.system(cfg).build(cfg, "cpu")
    c = wk.pair_counts(mesh.cells, mesh.n_vertices)
    R = Reference(mesh.coords, mesh.cells, mesh.tagged, cfg, "cpu")
    assert c["n2"] == R.n2 == model.fe.spaces.u_space.ndof
    cd2, cd1 = R.cd2, np.asarray(mesh.cells)

    def nnz(rows, cols, n_r, n_c):
        r = np.repeat(rows, cols.shape[1], axis=1).ravel()
        k = np.tile(cols, (1, rows.shape[1])).ravel()
        m = sp.coo_matrix((np.ones(len(r)), (r, k)), shape=(n_r, n_c)).tocsr()
        return m.nnz

    assert c["N22"] == nnz(cd2, cd2, R.n2, R.n2)
    assert c["N21"] == nnz(cd2, cd1, R.n2, R.nv)
    assert c["N11"] == nnz(cd1, cd1, R.nv, R.nv)


def test_the_work_of_an_operator_is_the_same_whichever_kernel_applies_it():
    """The P2-P1 coupling, the P1 pressure mass and the P1-P1 coarse
    saddle, each applied by the element kernel (K1/K2) and from its
    assembled blocks, count the same bytes and flops."""
    from nupgcm_tpu_torch.ops.element import ElementOperator, SaddleOperator

    cfg, _ = small("bowl870k-spinup")
    cfg["solver"] = {"coarse_dense_max": 64}        # the iterative coarse level at this size
    model, mesh = spec.system(cfg).build(cfg, "cpu")
    ops, c = model.ops, model.const
    counts = wk.pair_counts(mesh.cells, mesh.n_vertices)
    nv, n2 = counts["n1"], counts["n2"]
    pairs = [
        (lambda: model._inv_matrix(ops).up_matvec(torch.ones(nv, dtype=torch.float32)),
         lambda: model._held["A_up_e"].matvec(torch.ones(nv, dtype=torch.float32))),
        (lambda: ElementOperator(Ae=ops["Mp_e"], cd=c["cd_p"], n=nv).matvec(torch.ones(nv)),
         lambda: model._held["Mp_e"].matvec(torch.ones(nv))),
        (lambda: SaddleOperator(uu=ops["sc_uu"], up=ops["sc_up"], pu=ops["sc_pu"],
                                pp=ops["sc_pp"], cd_u=c["cd_p"], cd_p=c["cd_p"],
                                n_u_nodes=nv, n_p=nv).matvec(torch.ones(4 * nv)),
         lambda: model._sc_op.matvec(torch.ones(4 * nv))),
        (lambda: SaddleOperator(uu=ops["sc_uu"], up=None, pu=None, cd_u=c["cd_p"],
                                cd_p=c["cd_none"], n_u_nodes=nv).matvec(torch.ones(3 * nv)),
         lambda: model._held["sc_uu"].matvec(torch.ones(3 * nv))),
    ]
    for k1, assembled in pairs:
        got = []
        for apply in (k1, assembled):
            w = wk.OperatorWork(model, counts, variable_nu=False)
            with Hooks(w):
                apply()
            (name, rec), = w.summary().items()
            got.append((name, rec["calls"], rec["bytes"], rec["flops"]))
        assert got[0] == got[1]
        assert got[0][1] == 1 and got[0][2] > 0
    assert n2 > nv
