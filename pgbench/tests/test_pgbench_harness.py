"""The harness finds its cells by name, replays a segment from a start
state restored bit for bit, and judges what the window produced."""

import io
import json

import pytest
import torch

from pgbench import run as runmod
from pgbench import session, spec
from pgbench.faults import FAULTS
from pgbench.tests.small import CELLS, small


def test_every_cell_names_files_that_exist():
    bench = spec.benchmark()
    assert [w["name"] for w in bench["workloads"]] == list(CELLS)
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        spec.system(cfg)
        tr = spec.traffic(w["traffic"])
        assert tr["segment_steps"] > 0
        for trace in (False, True):
            names = [m["name"] for m in spec.metrics_for(bench, w["name"], trace)]
            assert names
            for n in names:
                assert callable(spec.reader(n))
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")


def test_metrics_for_picks_a_cells_own():
    bench = spec.benchmark()
    only = dict(bench, per_layer=bench["per_layer"] + [
        {"name": "x_ms", "unit": "ms", "better": "lower", "source": "program_span",
         "layer": "model", "moves": "steps_per_s", "workloads": ["bowl870k-spinup"]}])
    settled = [m["name"] for m in spec.metrics_for(only, "bowl870k-northstar-settled", True)]
    spin = [m["name"] for m in spec.metrics_for(only, "bowl870k-spinup", True)]
    assert "x_ms" in spin and "x_ms" not in settled
    assert {m["name"] for m in spec.metrics_for(bench, "bowl870k-spinup", False)} == {
        "steps_per_s", "step_ms_p95", "peak_mem_mib", "setup_s"}
    # every per-layer metric moves an end-to-end metric each of its cells reports
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in [e["name"] for e in spec.metrics_for(bench, w, False)], m



def test_seed_draws_are_fixed_by_the_seed():
    tr = spec.traffic("spinup")
    a, b = session.draws(tr, 2**31 + 12345), session.draws(tr, 2**31 + 12345)
    assert a == b and set(a) == {"amp", "k", "theta", "phase"}
    assert session.draws(tr, 7) != a
    assert a["amp"] == tr["initial_b"]["fixed"]["amp"]


def _close(a, b):
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_replay_restores_state_and_rebuilt_operators_bit_for_bit():
    cfg, tr = small("bowl_full_54k", "closures", advance=4)
    tr.update(segment_steps=12, refresh_every=6)        # a rebuild after step 10, two refreshes
    s = session.Session(cfg, tr, 11, spec.system(cfg), device="cpu")
    model = s.model
    s.restore()                  # the set-up's warm replay left its rebuilds in place
    snap = {k: v.clone() if torch.is_tensor(v) else v for k, v in model.ops.items()}
    held = {k: op.vals.clone() for k, op in model._held.items()}
    _, aux1, kept1 = s.replay(keep=True)
    # the segment rebuilt and refreshed the operators ...
    assert any(not _close(model.ops[k], snap[k]) for k in snap if torch.is_tensor(snap[k]))
    s.restore()
    # ... and a restore puts back every one, and the assembled blocks
    for k, v in snap.items():
        assert _close(model.ops[k], v), k
    for k, op in model._held.items():
        assert torch.equal(op.vals, held[k]), k
    _, aux2, kept2 = s.replay(keep=True)
    assert [a["inv_iters"] for a in aux1] == [a["inv_iters"] for a in aux2]
    for (_, n1, _, _), (_, n2, _, _) in zip(kept1, kept2):
        for k in ("u", "p", "b"):
            assert torch.equal(n1[k], n2[k]), k


def test_a_sound_small_run_is_correct_and_prints_its_result_line():
    cfg, tr = small("bowl870k-spinup")
    out = io.StringIO()
    args = runmod.parse(["--workload", "bowl870k-spinup", "--seed", str(2**31 + 5),
                         "--seconds", "1", "--trace", "0"])
    assert runmod.run(args, device="cpu", cfg=cfg, traffic=tr, out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] % tr["segment_steps"] == 0 and res["failed"] == 0
    assert {"steps_per_s", "step_ms_p95", "setup_s"} <= set(res["metrics"])
    assert res["device"]["memory_peak_bytes"] is None          # no card: no device reading


STEP_FAULTS = {("bowl_mixing_870k", "spinup"): [
                   "state-unchanged", "half-left-out", "buoyancy-altered", "flow-altered",
                   "pressure-shifted", "start-altered"],
               ("bowl_northstar_870k", "settled"): [
                   "state-unchanged", "half-left-out", "buoyancy-altered", "flow-altered",
                   "pressure-shifted", "start-altered"],
               ("bowl_full_54k", "closures"): [
                   "state-unchanged", "half-left-out", "buoyancy-altered", "flow-altered",
                   "pressure-shifted", "dt-altered", "start-altered"]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in STEP_FAULTS.items() for f in fs],
                         ids=lambda v: "-".join(v) if isinstance(v, tuple) else v)
def test_a_broken_step_is_not_correct(cell, fault):
    cfg, tr = small(*cell, advance=4)
    tr["segment_steps"] = min(tr["segment_steps"], 6)
    if cell[1] == "closures":
        tr["refresh_every"] = 3
    out = io.StringIO()
    args = runmod.parse(["--workload", "bowl870k-spinup", "--seed", "99", "--seconds", "0.5",
                         "--trace", "0"])
    assert runmod.run(args, device="cpu", cfg=cfg, traffic=tr, fault=FAULTS[fault], out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("figure", ["vertices", "coastline.1", "volume_sq"])
def test_a_mesh_unlike_the_stored_one_is_not_correct(figure):
    cfg, tr = small("bowl870k-spinup")
    want = cfg["mesh"]["figures"]
    if isinstance(want[figure], list):
        want[figure] = [want[figure][0] - 1, want[figure][1]]
    else:
        want[figure] = want[figure] * (1 + 1e-6)
    out = io.StringIO()
    args = runmod.parse(["--workload", "bowl870k-spinup", "--seed", "4", "--seconds", "0.2"])
    assert runmod.run(args, device="cpu", cfg=cfg, traffic=tr, out=out) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["checks"]["mesh"]["value"] > res["checks"]["mesh"]["limit"]
    assert res["correct"] is False


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    args = runmod.parse(["--workload", "bowl870k-spinup", "--seed", "1", "--seconds", "1"])
    assert runmod.run(args, out=out) != 0
    assert out.getvalue() == ""
