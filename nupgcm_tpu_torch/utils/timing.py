"""Timing / profiling: the span and counter registry, memory report,
device trace.

PyTorch counterpart of ``nupgcm_tpu.utils.timing`` (reference
src/nuPGCM.jl:57-72 ``ENABLE_TIMING``/``@ctime``).  The registry is
what the program records about itself:

* ``span(name, args=None)``: a nested, named stretch of host time.  With
  the switch off (``set_timing``, off by default) it is one flag test
  and a shared no-op context.  With it on, a running ``torch.profiler``
  gets a ``record_function("npg.<name>", args)`` range, on the
  same clock as the device's events, and the registry adds the call,
  its host seconds and its self seconds (less the spans it covers).  A
  span never synchronises.
* ``count(name, n=1)``: a counter; ``applied(op)`` counts and spans one
  application of the operator named ``op`` as ``op.<op>``.
* ``read(tensor, site, how)``: the step's one way to move a device value
  to the host; it returns what ``float(t)``, ``int(t)``, ``t.item()``,
  ``t.tolist()`` or ``t.cpu().numpy()`` returns, and with the switch on
  counts ``sync.<site>`` and times the blocking wait as the span
  ``sync.<site>``.
* ``build_span(name, into, sync)``: a part of a build, recorded as
  ``build.<name>`` whatever the switch (and into the dict ``into``),
  between two calls of ``sync`` where given.
* ``snapshot()`` and ``reset()``.

Beside it: a host + device memory report, and a ``torch.profiler``
trace of the device timeline with a reader that gives the device-busy
time and the kernels by device time.
"""

from __future__ import annotations

import functools
import gzip
import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

ENABLE_TIMING = {"on": False}


def set_timing(on: bool = True):
    ENABLE_TIMING["on"] = bool(on)


_SPANS = {}                   # name -> [calls, total s, self s]
_COUNTS = defaultdict(int)    # name -> count
_STACK = []                   # the open spans, innermost last
_profiling = torch._C._autograd._profiler_enabled


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """One open span: host seconds from ``__enter__`` to ``__exit__``,
    less those of the spans opened inside it (``child``)."""

    __slots__ = ("name", "args", "into", "sync", "rf", "t0", "child")

    def __init__(self, name, args=None, into=None, sync=None):
        self.name, self.args, self.into, self.sync = name, args, into, sync

    def __enter__(self):
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(
                "npg." + self.name, None if self.args is None else str(self.args))
            self.rf.__enter__()
        if self.sync is not None:
            self.sync()
        self.child = 0.0
        _STACK.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            self.sync()
        dt = time.perf_counter() - self.t0
        _STACK.pop()
        if _STACK:
            _STACK[-1].child += dt
        rec = _SPANS.get(self.name)
        if rec is None:
            rec = _SPANS[self.name] = [0, 0.0, 0.0]
        rec[0] += 1
        rec[1] += dt
        rec[2] += dt - self.child
        if self.into is not None:
            self.into[self.name[len("build."):]] = dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, args=None):
    """A context manager around a stretch of the program (see the
    module's docstring); ``args`` (str() taken) labels the profiler
    range."""
    if not ENABLE_TIMING["on"]:
        return _NULL
    return _Span(name, args)


def count(name: str, n: int = 1):
    if ENABLE_TIMING["on"]:
        _COUNTS[name] += n


def applied(op: str):
    """One application of the operator named ``op``: ``count`` and
    ``span`` of ``op.<op>``."""
    if not ENABLE_TIMING["on"]:
        return _NULL
    name = "op." + op
    _COUNTS[name] += 1
    return _Span(name)


_HOW = {"float": float, "int": int, "item": lambda t: t.item(),
        "list": lambda t: t.tolist(), "numpy": lambda t: t.cpu().numpy()}


def read(t, site: str, how: str = "item"):
    """``t`` on the host, as ``how`` ("float", "int", "item", "list",
    "numpy") converts it; with the switch on, counted and timed as
    ``sync.<site>``."""
    if not ENABLE_TIMING["on"]:
        return _HOW[how](t)
    name = "sync." + site
    _COUNTS[name] += 1
    with _Span(name):
        return _HOW[how](t)


def build_span(name: str, into: dict = None, sync=None):
    """A part of a build, ``build.<name>``, recorded whatever the switch;
    its seconds also go to ``into[name]`` (the last call's), and
    ``sync()`` (a device synchronise, so the seconds cover the device
    work) runs before the clock starts and before it stops."""
    return _Span("build." + name, into=into, sync=sync)


def build_step(name: str):
    """Decorator: the function's calls as ``build_span(name)``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with _Span("build." + name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def snapshot() -> dict:
    """{"spans": {name: {"n", "total_s", "self_s"}}, "counts": {name: n}}."""
    return {"spans": {k: {"n": n, "total_s": t, "self_s": s} for k, (n, t, s) in _SPANS.items()},
            "counts": dict(_COUNTS)}


def reset():
    _SPANS.clear()
    _COUNTS.clear()


def memory_status() -> str:
    """Host + device memory report (reference ``print_memory_status``,
    src/architectures.jl:19-20 / ext/nuPGCMCUDAExt.jl:33): host maxrss,
    and per CUDA device the bytes PyTorch has allocated, its peak, and
    the device's free and total memory."""
    import resource

    maxrss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    lines = [f"host maxrss: {maxrss_kb / 1048576:.2f} GB"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, total = torch.cuda.mem_get_info(i)
            lines.append(
                f"cuda:{i} ({torch.cuda.get_device_name(i)}): "
                f"{torch.cuda.memory_allocated(i) / 2**30:.2f} GB allocated "
                f"(peak {torch.cuda.max_memory_allocated(i) / 2**30:.2f} GB), "
                f"{free / 2**30:.2f} / {total / 2**30:.2f} GB free")
    return "\n".join(lines)


def print_memory_status():
    print(memory_status(), flush=True)


@contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host, plus CUDA where a
    device exists) and write a gzipped Chrome trace to
    ``logdir/trace.json.gz`` on exit; yields that path.  View it in
    Perfetto or chrome://tracing, or read it with ``trace_summary``.
    A session can lose device events from the start of its window
    (``lost_events`` finds them): a reader that needs every event
    checks the trace and traces again."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json.gz")
    prof = profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_summary(path: str) -> dict:
    """Device time of a Chrome trace written by ``device_trace``:
    ``busy_us`` (the union of all kernel, memcpy and memset intervals)
    and ``by_name`` {name: (calls, total us)}, largest first."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
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


LAUNCH_NAMES = ("Launch", "Memset", "Memcpy")  # host runtime calls that make device work


def lost_events(path: str) -> dict:
    """Host launches of a Chrome trace matched to their device events by
    correlation id: ``events`` (device events), ``launches`` (kernel
    launches, memsets and memcpys on the host), ``lost`` (positions, in
    time order, of the launches whose device event the trace lacks),
    ``orphans`` (device events of no launch in the trace) and
    ``lag_us`` (the least time from a launch call's start to its device
    event's start; None without a match)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    corr = lambda e: e.get("args", {}).get("correlation")
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    dev = {corr(e): e for e in device}
    launches = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                       and any(k in e.get("name", "") for k in LAUNCH_NAMES)),
                      key=lambda e: e["ts"])
    own = {corr(e) for e in launches}
    lags = [float(dev[corr(e)]["ts"]) - float(e["ts"]) for e in launches if corr(e) in dev]
    return {"events": len(device), "launches": len(launches),
            "lost": [i for i, e in enumerate(launches) if corr(e) not in dev],
            "orphans": sum(1 for e in device if corr(e) not in own),
            "lag_us": min(lags) if lags else None}
