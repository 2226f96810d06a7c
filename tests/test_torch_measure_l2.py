"""``nupgcm_tpu_torch.tools.measure_l2`` (the 0.87M-DoF bowl tool) at a
small size on the CPU, against the JAX package's ``PGModel`` on the
same configuration: the mixing bowl of the JAX ``tools/measure_l2*.py``
on ``bowl3D(0.25, 0.5, nz=4)`` (4,648 DoF), pushed onto the iterative
saddle-coarse + aggregate branch (``coarse_dense_max=256``) that the
0.87M bowl takes by default.  Both packages start from the same set_b
state and the same element tensors (the JAX model's, as the other
parity tests do); the invert's FGMRES count and every step's CG and
FGMRES counts must be equal, and the JSON must hold the JAX scripts'
keys.  Also the device-time rules: ``kernel_bench.device_ms``'s
acceptance rule with a fake trace, ``kernel_bench._trace``'s pad and
its refusal of a trace that lost a call's event, ``kernel_bench.busy_share``'s
retries, ``utils.timing.lost_events`` and ``chip_smoke.py``'s failure
on a kernel device time that was not measured.
"""

import json

import numpy as np
import pytest
import torch

import nupgcm_tpu as npj
from nupgcm_tpu_torch.models.model import ops_from_numpy
from nupgcm_tpu_torch.tools import _common, measure_l2
from torch_parity import assert_same_rcm_branch

H, NZ, STEPS = 0.25, 4, 2
KW = dict(coarse_dense_max=256)
# the JSON keys of the JAX scripts: measure_l2.py, measure_l2b.py / measure_l2c.py rows
BASE_KEYS = {"n_dof", "inv_seconds", "inv_iters", "steps_per_s", "evo_it", "inv_it",
             "inv_res", "b_max"}
ROW_KEYS = {"k", "steps_per_s", "inv_it", "inv_res", "evo_it", "b_max", "compile_s"}


def _jax_model(**kw):
    """The configuration of the JAX tools/measure_l2.py, at H, NZ."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npj.Parameters(eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npj.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npj.SurfaceDirichletBC(0.0))
    mesh = npj.generators.bowl3D(H, alpha, nz=NZ)
    spaces = npj.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npj.BDF2(t_start=0, t_stop=1e6 * dt, dt=dt)
    return npj.PGModel(npj.FEData(mesh, spaces), params, forc, ts, **KW, **kw)


@pytest.fixture(scope="module")
def pair():
    assert_same_rcm_branch()
    mj = _jax_model()
    mt, info = measure_l2.build(H, NZ, "cpu", torch.float64, **KW)
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    return mj, mt, info


def _jax_counts(mj, k=None):
    state = mj.set_b(mj.rest_state(), _common.initial_b)
    if k is not None:
        mj.retune(saddle_coarse_inner=k)
    _, _, aux = mj.invert_jit(mj.ops, state)
    _, _, auxs = mj.multi_step_jit(mj.ops, state, STEPS)
    return int(aux["inv_iters"]), {key: [int(v) for v in np.asarray(auxs[key])]
                                   for key in ("evo_iters", "inv_iters")}


def _counts(rec):
    return {key: [s[key] for s in rec["steps"]] for key in ("evo_iters", "inv_iters")}


def test_build_takes_the_aggregate_branch(pair):
    mj, mt, info = pair
    assert mt.preconditioner_branch == "iterative saddle coarse + L2 aggregate level"
    assert mt.saddle_coarse_inner == mj.saddle_coarse_inner
    assert info["n_dof"] == mt.fe.n_inv == mj.fe.n_inv
    assert info["n_agg"] == mj.ops["sc2_inv"].shape[0] // 4 > 0
    assert info["n_vertices"] == mj.fe.mesh.n_vertices and info["n_cells"] == mj.fe.mesh.n_cells
    parts = ("mesh_s", "fedata_s", "operators_s", "aggregate_s")
    assert all(info[k] >= 0 for k in parts)
    assert sum(info[k] for k in parts) == pytest.approx(info["build_s"])
    assert info["build_peak_mib"] is None  # no device memory on the CPU


def test_base_counts_match_jax(pair):
    mj, mt, info = pair
    res = measure_l2.run("base", model=mt, info=info, steps=STEPS, device="cpu",
                         log=lambda *a: None)
    inv, steps = _jax_counts(mj)
    assert res["inv_iters"] == inv and _counts(res) == steps
    assert BASE_KEYS <= set(res) and res["n_dof"] == mt.fe.n_inv and res["build"] == info
    assert res["inv_it"] == np.mean(steps["inv_iters"]) and res["steps_per_s"] > 0
    assert all(np.isfinite(s["inv_res"]) and s["inv_iters"] > 0 for s in res["steps"])
    json.dumps(res)


@pytest.mark.parametrize("mode, k", [("sweep", 2), ("k0", 0)])
def test_inner_budget_rows_match_jax(pair, mode, k):
    mj, mt, info = pair
    base = mt.saddle_coarse_inner
    rows = measure_l2.run(mode, model=mt, info=info, steps=STEPS, device="cpu",
                          log=lambda *a: None)
    assert mt.saddle_coarse_inner == base  # restored
    assert [r["k"] for r in rows] == (list(measure_l2.SWEEP_K) if mode == "sweep" else [0])
    assert all(ROW_KEYS <= set(r) for r in rows)
    row = next(r for r in rows if r["k"] == k)
    try:
        _, steps = _jax_counts(mj, k)
    finally:
        mj.retune(saddle_coarse_inner=base)
    assert _counts(row) == steps


def test_out_file_and_modes(pair, tmp_path):
    _, mt, info = pair
    out = tmp_path / "k0.json"
    rows = measure_l2.run("k0", model=mt, info=info, steps=1, device="cpu", out=str(out),
                          log=lambda *a: None)
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))
    with pytest.raises(ValueError, match="mode"):
        measure_l2.run("k1", model=mt, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        measure_l2.main([])


@pytest.mark.parametrize("traces, expect", [
    # every call's events on the first try: the busy time over n calls
    ({1: [(10.0, 3)], 2: [(20.0, 5)], 20: [(200.0, 41)]}, 0.01),
    # the n-call trace missed calls twice, then held them
    ({1: [(10.0, 3)], 2: [(20.0, 5)], 20: [(150.0, 30), (10.0, 2), (200.0, 41)]}, 0.01),
    # one-call traces that miss their call are not believed either
    ({1: [(0.0, 0), (10.0, 3)], 2: [(20.0, 5)], 20: [(200.0, 41)]}, 0.01),
    # never complete: not measured
    ({1: [(10.0, 3)], 2: [(20.0, 5)], 20: [(150.0, 30)] * 9}, None),
])
def test_device_ms_acceptance_rule(monkeypatch, traces, expect):
    """``kernel_bench.device_ms`` keeps a trace of n calls only if it
    holds E1 + (n - 1)(E2 - E1) device events, E1 and E2 the most events
    that traces of one and two calls held; else it traces again, and
    after its tries reports None."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    seq = {k: iter(v) for k, v in traces.items()}  # the last entry repeats
    monkeypatch.setattr(kb, "_trace", lambda fn, k: next(seq[k], traces[k][-1]))
    got = kb.device_ms(lambda: None)
    assert got == pytest.approx(expect) if expect is not None else got is None


@pytest.mark.parametrize("reads, expect, spread", [
    ([(200.0, 41), (200.0, 41), (200.0, 41)], 0.01, False),
    # one complete trace that reads far too little: the median leaves it out
    ([(200.0, 41), (120.0, 41), (204.0, 41)], 0.01, True),
    ([(120.0, 41), (150.0, 30), (200.0, 41), (10.0, 2), (202.0, 41)], 0.01, True),
    # refused traces end the tracing after ``tries``: the median of the kept
    ([(200.0, 41)] + [(150.0, 30)] * 5, 0.01, False),
])
def test_device_ms_reads_the_median_of_three_complete_traces(monkeypatch, reads, expect,
                                                             spread):
    """``kernel_bench.device_ms`` traces until DEVICE_READS traces of n
    calls held every call (or ``tries`` did not) and reads their
    median, so that one complete trace that reads too little does not
    set the time; readings further apart than SPREAD_BAR are recorded."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    seq = {1: iter([(10.0, 3)] * 5), 2: iter([(20.0, 5)] * 5), 20: iter(reads)}
    monkeypatch.setattr(kb, "_trace", lambda fn, k: next(seq[k]))
    monkeypatch.setattr(kb, "SPREADS", [])
    assert kb.device_ms(lambda: None) == pytest.approx(expect)
    assert bool(kb.SPREADS) is spread
    assert next(seq[20], None) is None  # no trace beyond those it needed


@pytest.mark.parametrize("lost, expect", [
    ([[64, 65], [0, 1, 2], [70]], [(2, 0), (0, 3)]),  # the pad may lose its events
    ([[3, 64]] * 5, [(1, 1)] * 5),                    # every try lost some: not measured
])
def test_busy_share_keeps_no_trace_that_lost_events(monkeypatch, lost, expect):
    """``kernel_bench.busy_share`` traces the same steps again while a
    trace lost device events of the steps (``utils.timing.lost_events``
    positions from PAD_LAUNCHES on), leaves the pad's spin kernels out
    of the busy time, and reads None after its tries."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb
    from nupgcm_tpu_torch.utils import timing

    seq = iter(lost)
    monkeypatch.setattr(timing, "lost_events", lambda path: {"lost": next(seq)})
    monkeypatch.setattr(timing, "trace_summary", lambda path: {
        "busy_us": 1.2e4, "by_name": {"spin_kernel(long)": (64, 2e3), "k": (9, 1e4)}})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    pads = []
    monkeypatch.setattr(torch.cuda, "_sleep", pads.append)

    class Stepper:
        starts = []

        def step(self, st):
            self.starts.append(st)
            return st + 1, None

    m = Stepper()
    share, wall, st, got = kb.busy_share(m, 0, n=3)
    assert got == expect and st == 3 and pads == [1] * kb.PAD_LAUNCHES * len(expect)
    assert m.starts == [0, 1, 2] * len(expect)  # every try from the same state
    assert share is None if expect[-1][0] else share == pytest.approx(1e-2 / wall)


def test_chip_smoke_fails_on_a_missing_device_time():
    """Phases 3, 3b, 8b and 11c require a device time of every kernel
    case; the CSR yardstick's may read None."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.check_bound(None, 1.0, "library")
    with pytest.raises(RuntimeError, match="not measured"):
        cs.check_bound(None, 1.0, "kernel", required=True)
    cs.check_bound(1.5, 1.0, "kernel", required=True)
    with pytest.raises(RuntimeError, match="below the bound"):
        cs.check_bound(0.5, 1.0, "kernel", required=True)


@pytest.mark.parametrize("device_ms, graph_ms, fails", [
    (None, 1.2, None),                # the profiler lost calls: the replay reads
    (1.1, 1.2, None),                 # the replay also counts the gaps
    (None, 0.9, "below the bound"),   # the replay is held to the bound too
    (1.5, 1.2, "CUDA-graph replay"),  # busy time above the replay's
    (0.9, 1.2, "below the bound"),
])
def test_chip_smoke_holds_device_time_to_the_graph_replay(device_ms, graph_ms, fails):
    """Every kernel case reads a device time without the profiler (a
    CUDA-graph replay), at or above the bound; a profiler reading, where
    there is one, sits between the bound and 1.1 times the replay."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rec = {"device_ms": device_ms, "graph_ms": graph_ms, "bound_ms": 1.0}
    if fails is None:
        cs.check_device(rec, "case")
    else:
        with pytest.raises(RuntimeError, match=fails):
            cs.check_device(rec, "case")


def test_lost_events_matches_launches_to_device_events(tmp_path):
    """``utils.timing.lost_events`` matches host launches to device
    events by correlation id, names the launches without one, counts the
    device events of no launch and the least launch-to-start lag."""
    from nupgcm_tpu_torch.tools import trace_check
    from nupgcm_tpu_torch.utils import timing

    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
           "args": {"correlation": c}} for t, c in ((0, 7), (5, 8), (9, 9))]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaMemsetAsync", "ts": 12,
            "args": {"correlation": 10}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 13,
            "args": {"correlation": 11}},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": 20, "dur": 3,
            "args": {"correlation": 9}},
           {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 30, "dur": 1,
            "args": {"correlation": 10}},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": -40, "dur": 3,
            "args": {"correlation": 3}}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    assert timing.lost_events(str(path)) == {
        "events": 3, "launches": 4, "lost": [0, 1], "orphans": 1, "lag_us": 11.0}
    with pytest.raises(RuntimeError, match="CUDA"):
        trace_check.main([])


def test_trace_check_describes_a_comparison():
    from nupgcm_tpu_torch.tools import trace_check

    res = {"calls": 20, "graph_ms": 0.0479, "lost": [10, 0, 0], "first_lost": [0],
           "orphans": [0, 0, 0], "lag_us": [None, 6.5, 8.25], "device_ms": [0.0463, 0.0471]}
    line = trace_check.describe(res)
    assert line.startswith("lost events per session [10, 0, 0] (first lost launch [0])")
    assert "device events of no launch [0, 0, 0], least launch-to-start lag 6.5-8.2 us" in line
    assert "complete traces 0.0463-0.0471 ms a call" in line
    assert line.endswith("CUDA-graph replay 0.0479 ms a call")
    res.update(lost=[20], lag_us=[None], device_ms=[])
    assert "no match; complete traces no complete trace" in trace_check.describe(res)


@pytest.mark.parametrize("lost, expect", [
    ([], (1e4, 9)),                   # a whole trace: the pad left out
    ([0, 5, 63], (1e4, 9)),           # the session lost the pad's first events
    ([3, 64], (0.0, 0)),              # and a call's first launch: no whole call
])
def test_trace_pads_and_drops_a_trace_that_lost_a_call(monkeypatch, lost, expect):
    """``kernel_bench._trace`` (under ``device_ms``) opens each trace with
    PAD_LAUNCHES spin kernels, leaves them out of the busy time and the
    event count, and reads (0, 0) from a trace in which a launch of the
    calls lost its device event (``utils.timing.lost_events`` positions
    from PAD_LAUNCHES on), so that ``device_ms`` keeps no such trace."""
    import contextlib

    from nupgcm_tpu_torch.tools import kernel_bench as kb
    from nupgcm_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "device_trace", lambda d: contextlib.nullcontext("trace"))
    monkeypatch.setattr(timing, "lost_events", lambda path: {"lost": lost})
    monkeypatch.setattr(timing, "trace_summary", lambda path: {
        "busy_us": 1.2e4, "by_name": {"spin_kernel(long)": (64, 2e3), "k": (9, 1e4)}})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    pads, calls = [], []
    monkeypatch.setattr(torch.cuda, "_sleep", pads.append)
    assert kb._trace(lambda: calls.append(1), 3) == expect
    assert pads == [1] * kb.PAD_LAUNCHES and calls == [1] * 3
