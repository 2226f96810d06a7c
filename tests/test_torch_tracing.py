"""The port's span and counter registry (``nupgcm_tpu_torch/utils/timing.py``)
where the step does its work, on a tiny CPU bowl.

With the switch off a step records nothing; with it on, the spans nest
as the step's calls do, every host read of a device value is counted at
its site as the solvers' structure predicts from the step's own
iteration counts, every operator application is counted by operator, a
running profiler sees the spans as user annotations, and the step's
results are the same bits as with the switch off.
"""

import math

import pytest
import torch

from nupgcm_tpu_torch import generators
from nupgcm_tpu_torch.ops import assembled, element
from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup
from nupgcm_tpu_torch.utils import timing

# the iterative coarse level with the aggregate level (the 0.87M bowl's
# branch), and the dense coarse level of a small mesh
BRANCHES = {"aggregate": dict(coarse_dense_max=256), "dense": {}}


@pytest.fixture(scope="module", params=sorted(BRANCHES))
def case(request):
    mesh = generators.bowl3D(0.25, 0.5, nz=3)
    model = mixing_setup(mesh, "cpu", torch.float64, **BRANCHES[request.param])
    st = model.set_b(model.rest_state(), initial_b)
    st, _ = model.step(st)           # from a state with a flow: both solvers iterate
    return request.param, model, st


@pytest.fixture
def traced():
    """Tracing on, a clean registry, and both put back after the test."""
    timing.reset()
    timing.set_timing(True)
    yield
    timing.set_timing(False)
    timing.reset()


def test_a_step_with_tracing_off_records_nothing(case):
    _, model, st = case
    timing.set_timing(False)
    timing.reset()
    model.step(st)
    assert timing.snapshot() == {"spans": {}, "counts": {}}


def _same(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("u", "p", "b", "dt", "t"))


def test_a_step_is_the_same_bits_with_tracing_on_and_off(case):
    _, model, st = case
    off1, aux_off = model.step(st)
    off2, aux_off2 = model.step(off1)
    timing.set_timing(True)
    try:
        on1, aux_on = model.step(st)
        on2, aux_on2 = model.step(on1)
    finally:
        timing.set_timing(False)
        timing.reset()
    assert _same(off1, on1) and _same(off2, on2)
    assert aux_off == aux_on and aux_off2 == aux_on2


def _bound_reads(model):
    return 2 + (2 if "sc_uu" in model.ops else 0)


def test_the_host_reads_of_a_step_follow_its_iteration_counts(case, traced):
    """The preconditioner's spectral bounds are read when ``ops`` is set,
    not in the step."""
    name, model, st = case
    _, aux = model.step(st)
    counts = timing.snapshot()["counts"]
    evo, inv, m = aux["evo_iters"], aux["inv_iters"], model.inv_opts["m"]
    assert evo > 0 and inv > 0
    assert counts["sync.cg.rnorm"] == evo + 1
    assert counts["sync.gmres.beta0"] == 1
    assert counts["sync.gmres.beta"] == math.ceil(inv / m)
    assert counts["sync.gmres.h"] == inv
    assert counts.get("sync.precond.bound", 0) == 0
    assert counts["sync.step.aux"] == 1
    total = sum(n for k, n in counts.items() if k.startswith("sync."))
    assert total == (evo + 1) + (inv + 1 + math.ceil(inv / m)) + 1
    timing.reset()
    model.ops = model.ops
    counts = timing.snapshot()["counts"]
    assert counts["sync.precond.bound"] == _bound_reads(model) == (4 if name == "aggregate" else 2)
    assert timing.snapshot()["spans"]["invert.precond_setup"]["n"] == 1


ENTRY_POINTS = [(element.SaddleOperator, "matvec"), (element.SaddleOperator, "up_matvec"),
                (element.ElementOperator, "matvec"), (assembled.AssembledBlocks, "matvec"),
                (assembled.AssembledSaddle, "matvec"), (assembled.AssembledSaddle, "up_matvec")]


def test_the_operator_counters_match_a_count_of_the_entry_points(case, traced, monkeypatch):
    _, model, st = case
    seen = {}
    for cls, meth in ENTRY_POINTS:
        fn = getattr(cls, meth)

        def counted(op, *a, _fn=fn, _meth=meth, **k):
            key = "op." + op.name + (".up" if _meth == "up_matvec" else "")
            seen[key] = seen.get(key, 0) + 1
            return _fn(op, *a, **k)

        monkeypatch.setattr(cls, meth, counted)
    model.step(st)
    snap = timing.snapshot()
    ops = {k: n for k, n in snap["counts"].items() if k.startswith("op.")}
    assert ops == seen and sum(ops.values()) > 0
    # every operator of the step carries the name the model gave it
    assert {"op.inversion", "op.visc", "op.evolution", "op.Mp_e", "op.A_up_e"} <= set(ops)
    for k, n in ops.items():
        assert snap["spans"][k]["n"] == n


def _profiled_step(model, st):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.step(st)
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("npg.")]


def test_the_span_tree_nests_as_the_step_calls(case, traced):
    _, model, st = case
    ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[4:])
          for e in _profiled_step(model, st)]

    def inside(inner, outer):
        return [i for i in ev if i[2] == inner
                and any(o[2] == outer and o[0] <= i[0] and i[1] <= o[1] for o in ev)]

    chain = ["step", "invert", "invert.fgmres", "fgmres.iter", "fgmres.precond"]
    for outer, inner in zip(chain, chain[1:]):
        assert inside(inner, outer) and len(inside(inner, outer)) == sum(
            1 for i in ev if i[2] == inner), (outer, inner)
    ops_in_precond = [i for i in ev if i[2].startswith("op.")
                      and any(o[2] == "fgmres.precond" and o[0] <= i[0] and i[1] <= o[1]
                              for o in ev)]
    assert ops_in_precond
    for inner, outer in (("evolve", "step"), ("evolve.cg", "evolve"), ("cg.iter", "evolve.cg"),
                         ("evolve.rhs", "evolve"),
                         ("fgmres.op", "fgmres.iter"), ("fgmres.gs", "fgmres.iter"),
                         ("precond.smooth_u", "fgmres.precond"), ("step.aux", "step"),
                         ("sync.gmres.h", "fgmres.iter")):
        assert inside(inner, outer), (inner, outer)


def test_the_spans_are_user_annotations_of_a_profile(case, traced):
    _, model, st = case
    ev = _profiled_step(model, st)
    assert ev and all(e.is_user_annotation() for e in ev)
    names = {e.name()[4:] for e in ev}
    assert names == set(timing.snapshot()["spans"])
    step = [e for e in ev if e.name() == "npg.step"]
    assert len(step) == 1


def test_self_time_is_never_above_total_time(case, traced):
    _, model, st = case
    model.step(st)
    spans = timing.snapshot()["spans"]
    assert spans["step"]["n"] == 1
    for name, s in spans.items():
        assert 0.0 <= s["self_s"] <= s["total_s"], name
    # a span's self time excludes its children: the step's is a small part
    assert spans["step"]["self_s"] < spans["step"]["total_s"]
    assert spans["invert"]["total_s"] >= spans["invert.fgmres"]["total_s"]


def test_build_seconds_is_a_read_only_view_of_the_build_spans(case):
    name, model, _ = case
    bs = model.build_seconds
    keys = {"constants", "operators", "patterns"}
    keys |= {"aggregate_level", "aggregation"} if name == "aggregate" else {"saddle_coarse"}
    assert set(bs) == keys and all(v >= 0 for v in bs.values())
    assert bs["operators"] >= bs.get("aggregate_level", bs.get("saddle_coarse"))
    with pytest.raises(TypeError):
        bs["constants"] = 0.0
