"""The program pass (``pgbench/program.py``): the port's own spans and
counters read after the traced window, the readers of its metrics, and
the readers of its spans in a device trace."""

import io
import json

import pytest

from pgbench import program, spec
from pgbench import run as runmod
from pgbench.tests.small import small


@pytest.fixture(scope="module")
def small_run():
    """A ``--trace 1`` run of the small spinup cell with the program pass:
    (result line, rec)."""
    cfg, tr = small("bowl870k-spinup")
    kept, out = {}, io.StringIO()
    args = runmod.parse(["--workload", "bowl870k-spinup", "--seed", str(2**31 + 77),
                         "--seconds", "0.5", "--trace", "1"])
    assert program.run(args, device="cpu", cfg=cfg, traffic=tr, out=out, kept=kept) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), kept["rec"]


def test_the_pass_fills_the_program_record(small_run):
    res, rec = small_run
    p = rec["program"]
    assert res["correct"] is True, res["checks"]
    assert p["steps"] == p["replays"] * 5 and p["spans"]["step"]["n"] == p["steps"]
    # every host read the registry counted, the solvers' structure predicts
    assert p["syncs_counted"] == p["syncs_expected"] > 0
    assert {"build.mesh", "build.spaces", "build.fedata", "build.constants",
            "build.operators"} <= set(p["build"])
    assert p["off_s"] > 0 and p["on_s"] > 0 and "overhead_pct" in p
    # the existing readings are printed as before, the program's beside them
    assert {"invert_ms_per_step", "fgmres_iters_per_step"} <= set(res["metrics"])
    got = set(res["metrics"]) & set(program.PROGRAM_METRICS)
    assert got == set(program.PROGRAM_METRICS) - {"host_us_per_launch"}   # no trace off the card


@pytest.mark.parametrize("name", program.PROGRAM_METRICS)
def test_each_reader_reads_the_record_and_nothing_without_it(small_run, name):
    _, rec = small_run
    read = spec.reader(name)
    full = dict(rec, trace={"launches": 1000, "steps": 5})
    v = read(full)
    assert isinstance(v, float) and v > 0
    assert read({"trace": {"launches": 1000, "steps": 5}}) is None
    assert read({"program": None, "trace": None}) is None


def test_the_readers_numbers(small_run):
    _, rec = small_run
    p = rec["program"]
    full = dict(rec, trace={"launches": 1000, "steps": 5})
    steps = p["steps"]
    syncs = sum(n for k, n in p["counts"].items() if k.startswith("sync."))
    assert spec.reader("host_syncs_per_step")(full) == syncs / steps
    ops = sum(n for k, n in p["counts"].items() if k.startswith("op."))
    assert spec.reader("op_applications_per_step")(full) == ops / steps
    it = p["spans"]["fgmres.iter"]
    assert spec.reader("fgmres_iter_ms")(full) == pytest.approx(1e3 * it["total_s"] / it["n"])
    assert spec.reader("build_s")(full) == pytest.approx(
        sum(p["build"][k]["total_s"] for k in ("build.mesh", "build.spaces", "build.fedata",
                                                "build.constants", "build.operators")))


def test_a_program_without_the_registry_gives_nothing(monkeypatch):
    monkeypatch.setattr(program, "registry", lambda: None)
    assert program.program_pass(object(), 2) is None
    res = {"metrics": {}, "breakdown": {"device_ops": [["k", 1.0]], "idle_gaps": [["a/b", 2.0]]}}
    program.merge(res, {"program": None}, {m: spec.reader(m) for m in program.PROGRAM_METRICS})
    assert res == {"metrics": {}, "breakdown": {"device_ops": [["k", 1.0]],
                                                "idle_gaps": [["a/b", 2.0]]}}


def test_the_breakdown_keeps_its_keys_and_gains_two():
    before = {"device_ops": [["k1", 0.5]], "idle_gaps": [["pgbench.invert/none", 0.25]]}
    res = {"metrics": {}, "breakdown": dict(before)}
    rec = {"program": {"idle_gaps_by_span": [["fgmres.gs", 0.1]],
                       "device_by_span": [["op.inversion", 0.2]], "overhead_pct": 1.0}}
    program.merge(res, rec, {})
    assert {k: res["breakdown"][k] for k in before} == before
    assert list(res["breakdown"]) == ["device_ops", "idle_gaps", "idle_gaps_by_span",
                                      "device_by_span"]


def _ev(cat, name, ts, dur, corr=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def test_idle_gaps_and_device_time_go_to_the_innermost_span():
    ev = [_ev("user_annotation", "npg.step", 0, 100),
          _ev("user_annotation", "npg.invert", 10, 80),
          _ev("user_annotation", "npg.op.inversion", 20, 10),
          _ev("user_annotation", "npg.fgmres.gs", 40, 10),
          _ev("user_annotation", "pgbench.step", 0, 100),       # the harness's: not the program's
          _ev("cuda_runtime", "cudaLaunchKernel", 22, 2, corr=1),
          _ev("cuda_runtime", "cudaLaunchKernel", 42, 2, corr=2),
          _ev("cuda_runtime", "cudaLaunchKernel", 95, 2, corr=3),
          _ev("kernel", "k1", 25, 5, corr=1),        # launched in op.inversion
          _ev("kernel", "gemv", 45, 20, corr=2),      # launched in fgmres.gs
          _ev("kernel", "k1", 105, 5, corr=3),        # launched in step, after invert
          _ev("kernel", "orphan", 200, 1, corr=9)]
    gaps = dict(program.idle_gaps_by_span(ev))
    # gaps: 30-45 (mid 37.5: invert), 65-105 (mid 85: invert), 110-200 (mid 155: none)
    assert gaps == {"invert": pytest.approx(55e-6), "none": pytest.approx(90e-6)}
    dev = dict(program.device_by_span(ev))
    assert dev == {"fgmres.gs": pytest.approx(20e-6), "op.inversion": pytest.approx(5e-6),
                   "step": pytest.approx(5e-6), "?": pytest.approx(1e-6)}
    by_kernel = dict(program.device_by_span(ev, by_kernel=True))
    assert by_kernel["fgmres.gs/gemv"] == pytest.approx(20e-6)
    spans = program.Spans(ev)
    assert [spans.at(t) for t in (5, 25, 35, 45, 95, 150)] == [
        "step", "op.inversion", "invert", "fgmres.gs", "step", "none"]


@pytest.mark.chip
def test_the_pass_reads_a_trace_on_the_card(card):
    """At a size a test run holds: every host read counted as the solvers'
    structure predicts, the profiled replays launch what the harness's
    traced replays launch, and nearly all idle time lies in a program
    span."""
    cfg, tr = small("bowl870k-spinup", h=0.08, nz=9)
    kept, out = {}, io.StringIO()
    args = runmod.parse(["--workload", "bowl870k-spinup", "--seed", str(2**31 + 19),
                         "--seconds", "2", "--trace", "1"])
    assert program.run(args, cfg=cfg, traffic=tr, out=out, kept=kept) == 0
    res, rec = json.loads(out.getvalue().strip().splitlines()[-1]), kept["rec"]
    p = rec["program"]
    assert res["correct"] is True, res["checks"]
    assert p["syncs_counted"] == p["syncs_expected"]
    assert "idle_gaps_by_span" in p, p.get("traced_tries")
    launches = rec["trace"]["launches"] / rec["trace"]["steps"]
    assert abs(p["traced_launches_per_step"] - launches) <= 0.01 * launches
    assert p["idle_none_pct"] < 10.0
    assert set(program.PROGRAM_METRICS) <= set(res["metrics"])
    assert {"device_ops", "idle_gaps", "idle_gaps_by_span", "device_by_span"} <= set(
        res["breakdown"])
