"""Timing / profiling: named wall-clock timers, memory report, device trace.

PyTorch counterpart of ``nupgcm_tpu.utils.timing`` (reference
src/nuPGCM.jl:57-72 ``ENABLE_TIMING``/``@ctime``): per-phase wall-clock
timers with enable/disable, a host + device memory report, and a
``torch.profiler`` trace of the device timeline with a reader that
gives the device-busy time and the kernels by device time.
"""

from __future__ import annotations

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


def _synchronize(block_on) -> None:
    """Wait for the CUDA devices of a tensor or a sequence of tensors."""
    tensors = [block_on] if isinstance(block_on, torch.Tensor) else block_on
    for d in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(d)


class Timers:
    """Accumulating named wall-clock timers.  ``block_on=`` (a tensor or
    a sequence of tensors) synchronises their CUDA devices before the
    clock stops, so the time covers the device work."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)

    @contextmanager
    def __call__(self, name: str, block_on=None):
        if not ENABLE_TIMING["on"]:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            _synchronize(block_on)
        self.total[name] += time.perf_counter() - t0
        self.count[name] += 1

    def report(self) -> str:
        lines = ["timers:"]
        for name in sorted(self.total, key=lambda k: -self.total[k]):
            n = self.count[name]
            t = self.total[name]
            lines.append(f"  {name}: {t:.3f}s total, {n} calls, {t / n * 1e3:.2f} ms/call")
        return "\n".join(lines)

    def reset(self):
        self.total.clear()
        self.count.clear()


TIMERS = Timers()


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
    Perfetto or chrome://tracing, or read it with ``trace_summary``."""
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
