"""The program's own spans and counters, read after the traced window.

The port records itself in ``nupgcm_tpu_torch/utils/timing.py``: spans
around the step's parts (``step``, ``evolve``, ``invert``, the
preconditioner's set-up, each Krylov iteration, each operator
application), counters of operator applications (``op.<operator>``) and
of the host's blocking reads (``sync.<site>``), and the build's parts
(``build.*``), recorded whatever the switch.  The switch is off in every
timed window; ``program_pass`` turns it on for replays of its own:

(a) ``replays`` replays with the switch off and (b) as many with it on,
    one of each in turn, timed on the host clock: the on-cost of the
    program's tracing, ``overhead_pct`` = 100 (b - a) / a, and the
    registry's snapshot of (b);
(c) as many replays with the switch on under the profiler, with the
    frozen pad-and-retry rule of ``trace.traced``: the device's idle time
    and each device operation put down to the innermost program span
    (``npg.*``) around it.

``python3 -m pgbench.program --workload <cell> --seed <n> --seconds <s>``
makes a ``--trace 1`` run of ``pgbench.run`` with ``rec["program"] =
program_pass(session, trace_replays)`` after the traced window, and
prints the run's result line with the readers of ``PROGRAM_METRICS``
added to ``metrics`` and ``idle_gaps_by_span`` and ``device_by_span``
added to ``breakdown``.  Every reading of ``pgbench.run`` is taken as it
is there: the pass runs after them.  Against a program without the
registry, ``program_pass`` returns None and the readers find nothing.
"""

from __future__ import annotations

from . import run as runmod  # first: its clock starts, and its thread settings hold

import argparse
import bisect
import importlib
import io
import json
import math
import sys
import time
from collections import defaultdict

from . import session as sessmod
from . import spec
from . import trace as tr

PREFIX = "npg."
PROGRAM_METRICS = ("host_syncs_per_step", "sync_wait_ms_per_step", "host_us_per_launch",
                   "precond_setup_ms_per_step", "fgmres_iter_ms", "op_applications_per_step",
                   "build_s")


def registry():
    """The port's registry module, or None where the program has none."""
    try:
        timing = importlib.import_module("nupgcm_tpu_torch.utils.timing")
    except ImportError:
        return None
    return timing if hasattr(timing, "snapshot") else None


# -- the program's spans in a trace -----------------------------------
class Spans:
    """The ``npg.*`` ranges of a trace, nested: for a host time, the
    innermost range open then."""

    def __init__(self, events):
        iv = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(PREFIX)), key=lambda s: (s[0], -s[1]))
        self.iv, self.starts, self.parent = iv, [s[0] for s in iv], []
        stack = []
        for i, (a, b, _) in enumerate(iv):
            while stack and iv[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.iv[i][1] < t:
            i = self.parent[i]
        return self.iv[i][2] if i >= 0 else "none"


def _device(events):
    return sorted((e for e in events if e.get("cat") in tr.DEVICE_CATEGORIES),
                  key=lambda e: float(e["ts"]))


def idle_gaps_by_span(events, top=10, spans=None):
    """Device idle time between consecutive device events, in seconds,
    summed by the innermost program span at the gap's middle ("none"
    outside every one): all of them, largest first, cut to ``top``."""
    spans = spans or Spans(events)
    gaps, end = defaultdict(float), None
    for e in _device(events):
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if end is not None and a > end:
            gaps[spans.at(0.5 * (a + end))] += (a - end) / 1e6
        end = b if end is None else max(end, b)
    ranked = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])
    return ranked[:top] if top else ranked


def _launch_spans(events, spans):
    """{correlation id: the innermost program span around its launch}."""
    return {e["args"]["correlation"]: spans.at(float(e["ts"])) for e in tr.launches_of(events)}


def device_by_span(events, top=10, spans=None, by_kernel=False):
    """Device seconds of every kernel, memcpy and memset, put down to the
    innermost program span around the host call that launched it
    (matched by correlation id; "none" outside every span, "?" for a
    device event of no launch), largest first; with ``by_kernel``,
    keyed "<span>/<device operation>"."""
    spans = spans or Spans(events)
    owner = _launch_spans(events, spans)
    out = defaultdict(float)
    for e in _device(events):
        key = owner.get(e["args"]["correlation"], "?")
        if by_kernel:
            key = f"{key}/{e.get('name', '?')}"
        out[key] += float(e["dur"]) / 1e6
    ranked = sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])
    return ranked[:top] if top else ranked


# -- the pass ------------------------------------------------------------
def expected_syncs(aux, m, bound_reads) -> int:
    """A step's host reads by the solvers' structure, from its aux: CG's
    start and each iteration; FGMRES's start, each restart cycle's and
    each iteration's; the preconditioner's spectral bounds; the
    diagnostics.  Exact where no inner Krylov solve reads (Chebyshev
    smoothing, the coarse cycle applied directly)."""
    inv = int(aux["inv_iters"])
    return (int(aux["evo_iters"]) + 1) + (inv + 1 + math.ceil(inv / m)) + bound_reads + 1


def bound_reads(model) -> int:
    """Spectral bounds read a step: the fine block preconditioner's two,
    and the iterative coarse level's two."""
    if model.precond_kind == "diag":
        return 0
    return 2 + (2 if "sc_uu" in model.ops else 0)


def program_pass(session, replays):
    """The program's record of ``replays`` replays of ``session``'s
    segment (see the module's docstring), or None where the program has
    no registry."""
    T = registry()
    if T is None:
        return None
    model = session.model
    build = {k: v for k, v in T.snapshot()["spans"].items() if k.startswith("build.")}
    T.reset()
    off_s = on_s = 0.0
    auxs = []
    for _ in range(replays):
        t0 = time.perf_counter()
        session.replay()
        session._sync()
        off_s += time.perf_counter() - t0
        T.set_timing(True)
        try:
            t0 = time.perf_counter()
            _, a, _ = session.replay()
            session._sync()
            on_s += time.perf_counter() - t0
        finally:
            T.set_timing(False)
        auxs += a
    snap = T.snapshot()
    steps = replays * session.n_seg
    bounds = bound_reads(model)
    rec = {"replays": replays, "steps": steps, "off_s": off_s, "on_s": on_s,
           "overhead_pct": 100.0 * (on_s - off_s) / off_s, "build": build,
           "spans": snap["spans"], "counts": snap["counts"],
           "syncs_counted": sum(n for k, n in snap["counts"].items() if k.startswith("sync.")),
           "syncs_expected": sum(expected_syncs(a, model.inv_opts["m"], bounds) for a in auxs),
           "aux_iters": [[a["evo_iters"], a["inv_iters"]] for a in auxs]}
    if session.device.type != "cuda":
        return rec

    def work():
        for _ in range(replays):
            session.replay()

    T.set_timing(True)
    try:
        events, wall, tries = tr.traced(work)
    finally:
        T.set_timing(False)
    rec.update(traced_tries=tries, traced_wall_s=wall)
    if events is None:
        return rec
    spans = Spans(events)
    idle = idle_gaps_by_span(events, top=0, spans=spans)
    total_idle = sum(v for _, v in idle)
    rec.update(
        traced_launches_per_step=len(tr.launches_of(events)) / steps,
        idle_s=total_idle,
        idle_none_pct=100.0 * dict(idle).get("none", 0.0) / total_idle if total_idle else 0.0,
        idle_gaps_by_span=idle[:10],
        device_by_span=device_by_span(events, top=10, spans=spans),
        device_by_span_kernel=device_by_span(events, top=20, spans=spans, by_kernel=True))
    return rec


# -- the entry -----------------------------------------------------------
def run(args, out=sys.stdout, device="cuda", cfg=None, traffic=None, replays=None,
        kept=None) -> int:
    """A ``--trace 1`` run of ``pgbench.run`` with the program pass after
    the traced window; prints the merged result line (``args.out``, when
    given, also gets the whole ``rec["program"]``; ``kept``, a dict, gets
    the run's record as "rec")."""
    kept = {} if kept is None else kept
    traced_window = sessmod.Session.traced_window

    def with_program(self, seconds, trace_replays):
        rec = traced_window(self, seconds, trace_replays)
        rec["program"] = program_pass(self, replays or trace_replays)
        kept["rec"] = rec
        return rec

    sessmod.Session.traced_window = with_program
    buf = io.StringIO()
    try:
        args.trace = 1
        rc = runmod.run(args, device=device, cfg=cfg, traffic=traffic, out=buf)
    finally:
        sessmod.Session.traced_window = traced_window
    if rc != 0 or "rec" not in kept:
        out.write(buf.getvalue())
        return rc
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec = kept["rec"]
    merge(result, rec, {m: spec.reader(m) for m in PROGRAM_METRICS})
    if getattr(args, "out", None):
        with open(args.out, "w") as f:
            json.dump({"result": result, "program": rec.get("program")}, f)
    print(json.dumps(result), file=out, flush=True)
    return rc


def merge(result, rec, readers):
    """The program's readings added to a result line of ``pgbench.run``:
    each reader's number under ``metrics`` (units from ``UNITS``), and ``idle_gaps_by_span`` and ``device_by_span`` under
    ``breakdown`` where it has one; nothing else is changed."""
    for name, read in readers.items():
        v = read(rec)
        if v is not None:
            result["metrics"][name] = {"value": v, "unit": UNITS[name]}
    prog = rec.get("program") or {}
    if "breakdown" in result and "idle_gaps_by_span" in prog:
        result["breakdown"]["idle_gaps_by_span"] = prog["idle_gaps_by_span"]
        result["breakdown"]["device_by_span"] = prog["device_by_span"]
    if prog:
        result["program"] = {k: prog[k] for k in (
            "overhead_pct", "syncs_counted", "syncs_expected", "traced_launches_per_step",
            "idle_none_pct", "device_by_span_kernel") if k in prog}
    return result


UNITS = {"host_syncs_per_step": "reads", "sync_wait_ms_per_step": "ms",
         "host_us_per_launch": "us", "precond_setup_ms_per_step": "ms", "fgmres_iter_ms": "ms",
         "op_applications_per_step": "applications", "build_s": "s"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--replays", type=int, default=None,
                    help="replays of each part of the pass (default: the traffic's trace_replays)")
    ap.add_argument("--out", default=None, help="a JSON file for the whole program record")
    args = ap.parse_args(argv)
    args.control = None
    sys.exit(run(args, replays=args.replays))


if __name__ == "__main__":
    main()
