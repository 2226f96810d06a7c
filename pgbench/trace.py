"""Device traces of a fixed piece of work, read in memory.

The readers below are frozen copies of the port's, so that a change to
the port cannot change how the benchmark reads a trace:

* ``trace_summary`` and ``lost_events``: copied from
  ``nupgcm_tpu_torch/utils/timing.py`` at commit d7bfc34; they read the
  list of Chrome-trace events (``{"ph", "cat", "name", "ts", "dur",
  "args": {"correlation"}}``) instead of a file, and ``lost_events`` also
  counts the ``cu*`` launch calls as well as the ``cuda*`` ones.
* ``traced``: the pad-and-retry rule of ``busy_share`` in
  ``nupgcm_tpu_torch/tools/kernel_bench.py`` at commit d7bfc34 (a
  session can lose the device events of its first launches, so each
  trace opens with ``PAD_LAUNCHES`` spin kernels, left out of every
  reading, and counts only if every launch after the pad found its
  device event; up to ``TRIES`` traces).

Nothing is written to disk: the profiler's events are taken from its
results in memory.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_NAMES = ("Launch", "Memset", "Memcpy")  # host runtime calls that make device work
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
PAD_LAUNCHES = 64
PAD_NAME = "spin_kernel"
TRIES = 5        # traces of the same work before the readings give up


def trace_summary(events) -> dict:
    """Device time of a trace: ``busy_us`` (the union of all kernel,
    memcpy and memset intervals) and ``by_name`` {name: (calls, total
    us)}, largest first."""
    spans, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((t0, t0 + dur))
            rec = by_name[e.get("name", "?")]
            rec[0] += 1
            rec[1] += dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"busy_us": busy, "by_name": {k: (n, us) for k, (n, us) in ranked}}


def launches_of(events):
    """The host calls that made device work, in time order."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES
                   and any(k in e.get("name", "") for k in LAUNCH_NAMES)),
                  key=lambda e: e["ts"])


def lost_events(events) -> dict:
    """Host launches matched to their device events by correlation id:
    ``events`` (device events), ``launches``, ``lost`` (positions, in
    time order, of the launches whose device event the trace lacks),
    ``orphans`` (device events of no launch) and ``lag_us`` (the least
    time from a launch call's start to its device event's start)."""
    corr = lambda e: e.get("args", {}).get("correlation")
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    dev = {corr(e): e for e in device}
    launches = launches_of(events)
    own = {corr(e) for e in launches}
    lags = [float(dev[corr(e)]["ts"]) - float(e["ts"]) for e in launches if corr(e) in dev]
    return {"events": len(device), "launches": len(launches),
            "lost": [i for i, e in enumerate(launches) if corr(e) not in dev],
            "orphans": sum(1 for e in device if corr(e) not in own),
            "lag_us": min(lags) if lags else None}


def _category(e) -> str:
    """The Chrome-trace category of a profiler event (``activity_type``
    where the torch build has it, else from its device and name)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if e.is_user_annotation() or name.startswith("pgbench."):
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "cuda_driver" if name.startswith("cu") and not name.startswith("cuda") \
            else "cuda_runtime"
    return "cpu_op"


def kineto_events(prof) -> list:
    """The profiler's events as Chrome-trace event dicts (us)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        out.append({"ph": "X", "cat": _category(e), "name": e.name(),
                    "ts": e.start_ns() / 1e3, "dur": e.duration_ns() / 1e3,
                    "args": {"correlation": e.correlation_id()}})
    return out


def _pad():
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def without_pad(events):
    """The events after the pad: its spin kernels and their launches
    left out."""
    pad_corr = {e["args"]["correlation"] for e in events
                if e.get("cat") == "kernel" and PAD_NAME in e.get("name", "")}
    return [e for e in events if e["args"]["correlation"] not in pad_corr
            or e.get("cat") not in DEVICE_CATEGORIES + LAUNCH_CATEGORIES]


def traced(work):
    """Trace ``work()`` (which ends in a synchronise) after the pad, up to
    ``TRIES`` times, until every launch of the work found its device
    event.  Returns (events of the work, wall seconds of the work, the
    number of tries), or (None, wall, tries) when every trace lost some."""
    from torch.profiler import ProfilerActivity, profile

    wall = None
    for k in range(1, TRIES + 1):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        try:
            _pad()
            t0 = time.perf_counter()
            work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            prof.stop()
        events = kineto_events(prof)
        del prof
        lost = lost_events(events)["lost"]
        if not any(i >= PAD_LAUNCHES for i in lost):
            return without_pad(events), wall, k
    return None, wall, TRIES


def idle_gaps(events, top=10):
    """Device idle time between consecutive device events, summed by what
    the host was doing at the gap's middle: the innermost harness span
    and the innermost host operation running then."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") in DEVICE_CATEGORIES)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("pgbench.")), key=lambda s: s[0])
    ops = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                  for e in events if e.get("cat") in ("cpu_op",) + LAUNCH_CATEGORIES),
                 key=lambda s: s[0])

    def inner(items, starts, t, look=64):
        # intervals nest, so the innermost one holding t is the latest
        # started one that has not ended by t
        i = bisect.bisect_right(starts, t) - 1
        for a, b, name in items[max(0, i - look + 1):i + 1][::-1]:
            if b >= t:
                return name
        return "none"

    s_starts, o_starts = [s[0] for s in spans], [o[0] for o in ops]
    gaps, end = defaultdict(float), None
    for a, b in dev:
        if end is not None and a > end:
            mid = 0.5 * (a + end)
            host = f"{inner(spans, s_starts, mid, 8)}/{inner(ops, o_starts, mid)}"
            gaps[host] += (a - end) / 1e6
        end = b if end is None else max(end, b)
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]
