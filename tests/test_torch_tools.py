"""The port's measurement path on the CPU: ``multi_step`` and ``retune``
against the JAX package, the tools of ``nupgcm_tpu_torch.tools`` at a
tiny size, ``utils.timing`` (its registry and traces), and the tail of ``chip_smoke.py``.

Parity: from the same numpy state and element tensors (the ``pair``
fixture of tests/test_torch_model.py, both preconditioner branches),
the same per-step iteration counts and u, p, b within 1e-9 relative,
before and after a ``retune(saddle_coarse_inner=2)``.  The tools need a
CUDA device to measure anything; here their ``run`` drives the plain
versions and ``main`` must raise.
"""

import gzip
import importlib.util
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import AUX_KEYS, ops_from_numpy, state_from_numpy
from nupgcm_tpu_torch.ops import kernels as K
from nupgcm_tpu_torch.tools import (_common, profile_matvec, profile_step, profile_stream,
                                    sweep_inner)
from nupgcm_tpu_torch.utils import timing
from test_torch_model import pair  # noqa: F401  (fixture)
from torch_parity import assert_same_rcm_branch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("u", "p", "b", "u_prev", "b_prev", "t", "dt", "step")
TOOLS = {"profile_matvec": profile_matvec, "profile_stream": profile_stream,
         "profile_step": profile_step, "sweep_inner": sweep_inner}


def _same_start(mj, mt):
    assert_same_rcm_branch()
    sj = mj.set_b(mj.rest_state(), _common.initial_b)
    st = state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    return sj, st


def _assert_same(mj, sj, auxj, st, aux, n):
    """Equal per-step iteration counts, then u, p, b within 1e-9
    relative; a failure names the count or field, the step and the
    size of the difference, beside each JAX solve's final residual and
    its stopping tolerance (atol + rtol ||r0||)."""
    res = "; ".join(
        f"{k} residuals {np.asarray(auxj[k[:3] + '_res'])} (atol {opts['atol']}, "
        f"rtol {opts['rtol']})"
        for k, opts in (("evo_iters", mj.evo_opts), ("inv_iters", mj.inv_opts)))
    for k in ("evo_iters", "inv_iters"):
        assert aux[k].shape == (n,)
        a, b = np.asarray(auxj[k]), aux[k]
        bad = np.flatnonzero(a != b)
        assert not bad.size, (f"{k} differ from step {bad[0] + 1}: JAX {a}, port {b}; "
                              f"JAX {res}")
    assert aux["inv_iters"].min() > 0
    for f in ("u", "p", "b"):
        a, b = np.asarray(getattr(sj, f)), getattr(st, f).numpy()
        rel = np.abs(a - b).max() / np.abs(a).max()
        assert rel <= 1e-9, f"{f} after step {n}: max relative difference {rel:.3e}; JAX {res}"
    assert st.step == int(sj.step)


def test_multi_step_matches_jax(pair):  # noqa: F811
    _, mj, mt = pair
    sj, st = _same_start(mj, mt)
    _, sj, auxj = mj.multi_step_jit(mj.ops, sj, 3)
    st, aux = mt.multi_step(st, 3)
    assert sorted(aux) == sorted(AUX_KEYS) == sorted(auxj)
    _assert_same(mj, sj, auxj, st, aux, 3)


def test_retune_matches_jax(pair):  # noqa: F811
    _, mj, mt = pair
    sj, st = _same_start(mj, mt)
    ops = mt.ops
    base = mj.saddle_coarse_inner
    try:
        assert mt.retune(saddle_coarse_inner=2) is mt
        mj.retune(saddle_coarse_inner=2)
        assert mt.saddle_coarse_inner == mj.saddle_coarse_inner == 2
        assert mt.ops is ops
        _, sj, auxj = mj.multi_step_jit(mj.ops, sj, 2)
        st, aux = mt.multi_step(st, 2)
        _assert_same(mj, sj, auxj, st, aux, 2)
    finally:
        mj.retune(saddle_coarse_inner=base)
        mt.retune(saddle_coarse_inner=base)


@pytest.fixture(scope="module")
def small():
    """The mixing model on a tiny bowl, on the production (iterative
    saddle-coarse + aggregate) branch."""
    return _common.mixing_setup(npt.generators.bowl3D(0.35, 0.5, nz=3), "cpu",
                                torch.float64, coarse_dense_max=256)


def test_retune_budgets_and_multi_step_of_zero(small):
    m = small
    opts = (dict(m.inv_opts), dict(m.evo_opts), m.inner_iters, m.cond_ratio)
    try:
        assert m.retune(inner_iters_u=3, inner_iters_p=4, cond_ratio=10.0, inv_rtol=1e-7,
                        inv_atol=1e-8, inv_memory=10, evo_rtol=1e-5, evo_atol=1e-9) is m
        assert m.inner_iters == (3, 4) and m.cond_ratio == 10.0
        assert m.inv_opts == dict(atol=1e-8, rtol=1e-7, itmax=250, m=10)
        assert m.evo_opts == dict(atol=1e-9, rtol=1e-5, itmax=opts[1]["itmax"])
        m.retune()  # None keeps every budget
        assert m.inner_iters == (3, 4) and m.inv_opts["m"] == 10
    finally:
        inv, evo, (iu, ip), ratio = opts
        m.retune(inner_iters_u=iu, inner_iters_p=ip, cond_ratio=ratio, inv_rtol=inv["rtol"],
                 inv_atol=inv["atol"], inv_memory=inv["m"], evo_rtol=evo["rtol"],
                 evo_atol=evo["atol"])
    assert (m.inv_opts, m.evo_opts, m.inner_iters, m.cond_ratio) == opts
    st = m.rest_state()
    st2, auxs = m.multi_step(st, 0)
    assert st2 is st and all(auxs[k].shape == (0,) for k in AUX_KEYS)


def _run_tool(name, model):
    kw = dict(device="cpu", log=lambda *a: None)
    if name == "profile_matvec":
        return profile_matvec.run(model=model, n1=1, n2=2, **kw)
    if name == "profile_stream":
        return profile_stream.run(rows=1140, ncell=1024, reps=2, **kw)
    if name == "profile_step":
        return profile_step.run(model=model, n1=1, n2=2, **kw)
    return sweep_inner.run(model=model, steps=1, **kw)


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_runs_on_cpu(small, name):
    K.reset_counts()
    budget = small.saddle_coarse_inner
    res = _run_tool(name, small)
    assert all(v == 0 for v in K.launches.values())
    if name == "profile_matvec":
        assert sorted(res["ms"]) == sorted(profile_matvec.VARIANTS)
        assert res["bytes"] == sum(small.ops[k].numel() * 8
                                   for k in ("A_uu_e", "A_up_e", "A_pu_e"))
        assert set(res["not_applicable"]) == {"nodedup", "nobucket"}
        assert all(v is None for v in res["kernel_ms"].values())
        assert K.plain_calls["stream_saddle"] > 0
    elif name == "profile_stream":
        assert list(res["configs"]) == [profile_stream.config_name(*c)
                                        for c in profile_stream.CONFIGS]
        assert res["in_l2"] and res["configs"]["s1_B512"]["blocks"] == 2
        assert K.plain_calls["stream_probe"] > 0
    elif name == "profile_step":
        assert sorted(res["ms"]) == sorted(profile_step.PARTS)
        assert res["share"]["step"] == 1.0 and res["invert_iters"] > 0
    else:
        assert len(res) == len(sweep_inner.CONFIGS)
        assert [r.get("saddle_coarse_inner") for r in res] == [None, 16, 8, 4, 2, 0]
        assert all(np.isfinite(r["steps_per_s"]) and r["inv_it"] > 0 for r in res)
        assert small.saddle_coarse_inner == budget  # restored


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_main_needs_cuda(name):
    with pytest.raises(RuntimeError, match="CUDA"):
        TOOLS[name].main([])


def test_sweep_inner_writes_out_only_when_given(small, tmp_path):
    out = tmp_path / "sweep.json"
    rows = sweep_inner.run(model=small, steps=1, device="cpu", out=str(out),
                           log=lambda *a: None)
    assert json.loads(out.read_text()) == json.loads(json.dumps(rows))


def test_difference_quotient_cancels_constants():
    calls = []
    sec, first = _common.difference_quotient(calls.append, 2, 7, "cpu", reps=1)
    assert calls == [2, 7, 2] and np.isfinite(sec) and first >= 0


def test_timers_and_memory_status():
    """The registry: off, a span is one shared no-op and nothing counts;
    on, spans nest with self time, counters add, a read returns what the
    call it stands for returns and is counted and timed at its site; a
    build span records whatever the switch, into its dict too."""
    timing.set_timing(False)
    timing.reset()
    assert timing.span("a") is timing.span("b")
    with timing.span("off"):
        timing.count("c")
    t = torch.tensor([1.5, 2.5], dtype=torch.float32)
    assert timing.read(t[0], "x", "float") == 1.5
    assert timing.snapshot() == {"spans": {}, "counts": {}}
    timing.set_timing(True)
    try:
        with timing.span("a", args=3):
            with timing.span("a.b"):
                pass
            with timing.span("a.b"):
                pass
        timing.count("c", 2)
        with timing.applied("inv"):
            pass
        got = [timing.read(t[0], "x", "float"), timing.read(torch.tensor(3), "x", "int"),
               timing.read(t[1], "x"), timing.read(t, "y", "list"),
               timing.read(t, "y", "numpy")]
    finally:
        timing.set_timing(False)
    assert got[:4] == [1.5, 3, 2.5, [1.5, 2.5]] and type(got[1]) is int
    assert got[4].dtype == np.float32 and got[4].tolist() == [1.5, 2.5]
    snap = timing.snapshot()
    a, b = snap["spans"]["a"], snap["spans"]["a.b"]
    assert (a["n"], b["n"]) == (1, 2)
    assert a["self_s"] <= a["total_s"] and a["total_s"] >= b["total_s"]
    assert snap["counts"] == {"c": 2, "op.inv": 1, "sync.x": 3, "sync.y": 2}
    assert snap["spans"]["sync.x"]["n"] == 3 and snap["spans"]["op.inv"]["n"] == 1
    timing.reset()
    into = {}
    with timing.build_span("part", into, sync=lambda: None):
        pass
    assert set(into) == {"part"} and set(timing.snapshot()["spans"]) == {"build.part"}
    timing.reset()
    assert timing.snapshot() == {"spans": {}, "counts": {}}
    assert npt.memory_status().startswith("host maxrss:")
    assert npt.print_memory_status is timing.print_memory_status


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with timing.device_trace(str(tmp_path)) as path:
        x = torch.ones(64, 64)
        (x @ x).sum()
    with gzip.open(path, "rt") as f:
        assert json.load(f)["traceEvents"]
    summ = timing.trace_summary(path)
    assert summ["busy_us"] == 0.0 and summ["by_name"] == {}  # no device here


def test_trace_summary_merges_device_intervals(tmp_path):
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "gpu_memset", "name": "m", "ts": 30, "dur": 2},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 31, "dur": 4},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    summ = timing.trace_summary(str(path))
    assert summ["busy_us"] == 20.0
    assert summ["by_name"] == {"k1": (2, 14.0), "k2": (1, 10.0), "m": (1, 2.0)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_tail_order(capsys):
    """The docstring's contract: the card's line, then the kernels, then
    the verdict, as the last three lines."""
    kernels = [{"name": "stream_saddle", "launches": 1}]
    _chip_smoke().emit_tail(kernels, "NVIDIA H100 80GB HBM3, 700.00 W", "H100", 1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-2]) == {"kernels": kernels}
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "H100", "count": 1}}
    src = (ROOT / "chip_smoke.py").read_text()
    main_src = src[src.index("def main():"):]
    assert "emit_tail(" in main_src and "print(name_limit)" not in main_src


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _chip_smoke().main()
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


@pytest.mark.parametrize("n_traces, expect", [
    ([(150.0, 30)] + [(200.0, 41)] * 3, 0.01),  # the first trace missed calls
    ([(150.0, 30), (140.0, 28), (10.0, 2), (150.0, 30), (140.0, 28)], None),  # every try did
])
def test_device_ms_keeps_no_trace_that_missed_calls(monkeypatch, n_traces, expect):
    """kernel_bench.device_ms keeps a trace of 20 calls only if it holds
    E1 + 19 (E2 - E1) device events (traces of one and two calls: here
    one event a trace makes once and two a call); chip_smoke.py fails
    on a device time below its bound, and takes None as not measured."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    traces = {1: iter([(10.0, 3)] * 5), 2: iter([(20.0, 5)] * 5), 20: iter(n_traces)}
    monkeypatch.setattr(kb, "_trace", lambda fn, k: next(traces[k]))
    got = kb.device_ms(lambda: None)
    assert got == pytest.approx(expect) if expect is not None else got is None
    cs = _chip_smoke()
    cs.check_bound(None, 1.0, "case")
    cs.check_bound(1.0, 1.0, "case")
    with pytest.raises(RuntimeError, match="below the bound"):
        cs.check_bound(0.5, 1.0, "case")


def test_chip_smoke_csr_yardstick_matches_plain(small):
    """The library yardstick of chip_smoke.py (tools/kernel_bench.py):
    every kernel case's operator assembled to CSR gives the plain
    version's product, and the bound counts each input once."""
    from nupgcm_tpu_torch.tools import kernel_bench as cs

    rng = np.random.default_rng(0)
    cases = cs.kernel_cases(small)
    assert {c["mode"] for c in cases} == {"full", "up", "uu", "full_pp", None}
    for case in cases:
        x = torch.as_tensor(rng.standard_normal(case["n_x"]))
        blocks = case["blocks"]
        if case["mode"] is None:
            y0 = K.scalar_matvec_plain(*blocks, *case["cd"], x)
        else:
            y0 = K.saddle_matvec_plain(*blocks, *case["cd"], x, case["mode"], case["n_nodes"])
        y = torch.sparse.mm(cs.operator_csr(case, blocks, case["n_x"]), x[:, None])[:, 0]
        assert y.shape == y0.shape, case["label"]
        assert float((y - y0).abs().max()) <= 1e-12 * float(y0.abs().max()), case["label"]
    ms, by = cs.bound(3.35e9, 0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    assert cs.bound(0, 67e9) == (pytest.approx(1.0), "operations")
