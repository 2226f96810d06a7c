"""Does a torch.profiler trace hold every device event late in a process?

Runs many short profiler sessions over K1 "full" on the slice model
(each session: ``--calls`` prepared launches) and matches every kernel
launch the host side recorded to the device event of the same
correlation id (``utils.timing.lost_events``).  A session can lose
device events from the start of its window (a few, or all of them):
now and then in a fresh process, and often late in a long one (NVIDIA
H100, torch 2.11).  The tool reports, per block of 100 sessions, how
many sessions lost events, where the first loss sat, the device events
of no launch in the session, and the least time from a launch call to
its kernel's start; then the device time per call of the complete
traces beside an independent reading: CUDA events around a CUDA-graph
replay of the same calls (no host gaps between them).  ``compare``
makes the same reading on any callable: ``chip_smoke.py`` runs it late
in its process (phase 11d).

Usage: python -m nupgcm_tpu_torch.tools.trace_check [--sessions 1500]
           [--calls 20] [--out FILE]
       Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from ..utils.timing import device_trace, lost_events, trace_summary
from ._common import bowl_model, card_name_limit, require_cuda
from .kernel_bench import graph_ms


def _session(fn, calls):
    with tempfile.TemporaryDirectory() as d:
        with device_trace(d) as path:
            for _ in range(calls):
                fn()
        rec = lost_events(path)
        rec["busy_us"] = trace_summary(path)["busy_us"]
    return rec


def _summary(rows, calls) -> dict:
    return {"lost": [len(r["lost"]) for r in rows],
            "first_lost": sorted({r["lost"][0] for r in rows if r["lost"]}),
            "orphans": [r["orphans"] for r in rows],
            "lag_us": [r["lag_us"] for r in rows],
            "device_ms": [r["busy_us"] / calls / 1e3 for r in rows if not r["lost"]]}


def compare(fn, calls=20, sessions=10) -> dict:
    """The CUDA-graph replay's ms per call, then ``sessions`` profiler
    traces of ``calls`` calls: the launches each lost, the first lost
    launch, the device events of no launch, the least launch-to-start
    lag, and device ms per call of the complete traces."""
    out = {"calls": calls, "graph_ms": graph_ms(fn, calls)}
    out.update(_summary([_session(fn, calls) for _ in range(sessions)], calls))
    return out


def _spans(res) -> str:
    ms = res["device_ms"]
    span = f"{min(ms):.4f}-{max(ms):.4f} ms a call" if ms else "no complete trace"
    lags = [v for v in res["lag_us"] if v is not None]
    lag = f"{min(lags):.1f}-{max(lags):.1f} us" if lags else "no match"
    return (f"lost events per session {res['lost']} (first lost launch {res['first_lost']}), "
            f"device events of no launch {res['orphans']}, least launch-to-start lag {lag}; "
            f"complete traces {span}")


def describe(res) -> str:
    """One line of ``compare``'s result."""
    return f"{_spans(res)}; CUDA-graph replay {res['graph_ms']:.4f} ms a call"


def run(sessions=1500, calls=20, h=0.08, nz=9, log=print) -> dict:
    """Blocks of 100 sessions, then one CUDA-graph replay (captured after
    the sessions, so that no graph precedes them)."""
    from ..ops import kernels as K
    from . import kernel_bench as kb

    model = bowl_model(h, nz, "cuda", torch.float32)
    case = kb.kernel_cases(model)[0]  # K1 "full", the P2-P1 inversion operator
    fn = kb.case_fns(model, K, case, torch.float32)[0]
    blocks, card = [], card_name_limit()
    for start in range(0, sessions, 100):
        res = _summary([_session(fn, calls) for _ in range(min(100, sessions - start))], calls)
        res["sessions"] = [start + 1, start + len(res["lost"])]
        blocks.append(res)
        log(f"[trace_check] sessions {start + 1}-{start + len(res['lost'])}: "
            f"{sum(1 for n in res['lost'] if n)} lost events; {_spans(res)} ({card})")
    out = {"card": card, "calls": calls, "blocks": blocks, "graph_ms": graph_ms(fn, calls),
           "sessions_with_losses": sum(1 for b in blocks for n in b["lost"] if n)}
    log(f"[trace_check] {out['sessions_with_losses']} of {sessions} sessions lost events; "
        f"CUDA-graph replay {out['graph_ms']:.4f} ms a call ({card})")
    return out


def main(argv=None):
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=1500)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = run(args.sessions, args.calls)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "blocks"}))


if __name__ == "__main__":
    main()
