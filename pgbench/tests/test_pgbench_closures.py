"""The full-physics cell ``bowlfull-closures`` (configuration
``bowl_full_54k_refresh``, traffic ``closures``): a sound run of its small
version is correct and its readers read the rebuilds; each planted fault
of the full-physics configuration fails it; on the card, the cell's sound
run is correct and its control (TF32 on) is not."""

import copy
import io
import json

import pytest

from pgbench import run as runmod
from pgbench import spec
from pgbench.faults import FAULTS
from pgbench.tests.small import small
from pgbench.tests.test_pgbench_harness import STEP_FAULTS

CELL = "bowlfull-closures"
READERS = ("rebuild_ms_per_step", "fgmres_iters_after_rebuild")


def _result(out):
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _small_run(trace, fault=None, seed=2**31 + 19, seconds="0.5"):
    """A run of the cell on the small bowl from step 4: a segment of 16
    steps (model steps 5-20, eddy rebuilds after steps 10 and 20, the
    last of the segment), a refresh after segment step 8."""
    cfg, tr = small("bowl_full_54k_refresh", "closures", advance=4)
    tr.update(segment_steps=16, refresh_every=8)
    kept, out = {}, io.StringIO()
    args = runmod.parse(["--workload", CELL, "--seed", str(seed), "--seconds", seconds,
                         "--trace", str(trace)])
    assert runmod.run(args, device="cpu", cfg=cfg, traffic=tr, fault=fault, out=out) == 0
    return _result(out)


def test_the_cell_names_its_files():
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    cfg = spec.config(bench, cell["config"])
    assert cfg["name"] == cell["config"] == "bowl_full_54k_refresh" and cell["chips"] == 1
    assert cfg["solver"]["refresh_on_rebuild"] is True
    # the configuration is the tests' full-physics one with that key alone
    base = json.loads((spec.HERE / "configs" / "bowl_full_54k.json").read_text())
    same = copy.deepcopy(cfg)
    del same["solver"]["refresh_on_rebuild"]
    for k in ("name", "about"):
        del same[k], base[k]
    assert same == base
    assert [m["name"] for m in spec.metrics_for(bench, CELL, True)] == list(READERS)
    assert {m["name"] for m in spec.metrics_for(bench, CELL, False)} == {
        "steps_per_s", "step_ms_p95", "peak_mem_mib", "setup_s"}


def test_a_sound_small_run_is_correct_and_reads_its_rebuilds():
    res = _small_run(1)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] % 16 == 0
    m = res["metrics"]
    assert set(READERS) <= set(m)
    assert m["rebuild_ms_per_step"]["value"] > 0 and m["rebuild_ms_per_step"]["unit"] == "ms"
    # FGMRES after a rebuild stays far below its cap of 500
    assert 0 < m["fgmres_iters_after_rebuild"]["value"] < 60


def _aux(iters, rebuilt, seconds=None):
    return [dict(inv_iters=i, rebuilt=r, rebuild_s=s)
            for i, r, s in zip(iters, rebuilt, seconds or [0.0] * len(iters))]


def test_the_readers_on_records():
    fgm, reb = (spec.reader(n) for n in ("fgmres_iters_after_rebuild", "rebuild_ms_per_step"))
    # the first step follows nothing in the record; steps 3 and 5 follow rebuilds
    rec = {"aux": _aux([40, 10, 30, 12, 20, 9], [0, 1, 0, 1, 0, 0],
                       [0.0, 0.2, 0.0, 0.1, 0.0, 0.0]), "steps": 6}
    assert fgm(rec) == 25.0
    assert reb(rec) == pytest.approx(1e3 * 0.3 / 6)
    # a record ending in a rebuild: nothing follows it
    assert fgm({"aux": _aux([40, 10], [1, 1])}) == 10.0
    assert fgm({"aux": _aux([40, 10], [0, 0])}) is None
    # a program without the keys (the parent's), or an empty record
    old = {"aux": [dict(inv_iters=10, evo_iters=3)], "steps": 1}
    for read in (fgm, reb):
        assert read(old) is None
        assert read({"aux": [], "steps": 0}) is None


@pytest.mark.parametrize("fault", STEP_FAULTS[("bowl_full_54k", "closures")])
def test_a_broken_step_is_not_correct(fault):
    cfg, tr = small("bowl_full_54k_refresh", "closures", advance=4)
    tr.update(segment_steps=6, refresh_every=3)
    out = io.StringIO()
    args = runmod.parse(["--workload", CELL, "--seed", "99", "--seconds", "0.5", "--trace", "0"])
    assert runmod.run(args, device="cpu", cfg=cfg, traffic=tr, fault=FAULTS[fault], out=out) == 0
    res = _result(out)
    assert res["correct"] is False, res["checks"]


def _card_run(control, seed):
    """The cell as the benchmark runs it, a window of one replay."""
    argv = ["--workload", CELL, "--seed", str(seed), "--seconds", "1", "--trace", "0"]
    out = io.StringIO()
    assert runmod.run(runmod.parse(argv + (["--control", control] if control else [])),
                      out=out) == 0
    return _result(out)


@pytest.mark.chip
def test_the_cell_is_correct_on_the_card(card):
    res = _card_run(None, 2**31 + 23)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]


@pytest.mark.chip
def test_the_cells_tf32_control_is_not_correct(card):
    import torch

    try:
        res = _card_run("tf32", 2**31 + 29)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert res["correct"] is False, res["checks"]
