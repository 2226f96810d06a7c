"""The benchmark of the PyTorch/CUDA port ``nupgcm_tpu_torch``: PGModel
steps on one H100, timed over replayed segments of steps.

Run from the root of a checkout::

    python3 -m pgbench.run --workload bowl870k-spinup --seed 7 --seconds 20 --trace 0

One run builds the cell's configuration, makes the start state from the
seed, warms the cell's segment once, then replays the segment from its
restored start state until ``--seconds`` have passed (``session.py``).
It prints, as its last line, one JSON object: ``correct``, ``attempted``
(steps in the window), ``failed`` (steps whose solve hit its cap or whose
state is not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, each from ``pgbench/metrics/``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference and its limit (``judge.py``),
which also end standard error.  It exits 2 without printing a result
where the card the cell asks for is missing, and 3 where a module of JAX
or the JAX package is loaded once the window has closed.

The cells (``BENCHMARK.json``):

* ``bowl870k-spinup``: the 0.87M-DoF mixing bowl, steps 1-5 from the
  seed's set_b state: the first solve starts from zero, so the Krylov
  iterations, the preconditioner and the kernels do most of the work;
* ``bowl870k-northstar-settled``: the same bowl at the Krylov tolerances
  that hold the reference's accuracy bar (1e-7/1e-8), advanced 30 steps
  until its solver counts level off, then 20 steps: a long integration's
  step, in which both solvers still iterate.

``configs/bowl_full_54k.json`` and ``traffic/closures.json`` (full
physics: convection, eddy closure, wind, adaptive dt, preconditioner
refreshes) run in the tests only: at the stated refresh cadence, from
the seed's start state, FGMRES reaches its cap in every step from the
first eddy rebuild to the first refresh, a fault of the program that
keeps the cell out for now.

Adding a cell, a configuration, a traffic mix or a metric takes files
only: a ``workloads`` entry in ``BENCHMARK.json`` naming a configuration
and a traffic mix; a configuration file under ``pgbench/configs/`` (whose
``system`` names a module under ``pgbench/systems/`` that builds it, and whose
``limits`` hold the correctness limits); a traffic file
``pgbench/traffic/<name>.json`` (initial buoyancy expression and seeded
draws, ``advance_steps``, ``segment_steps``, ``refresh_every``,
``trace_replays``, ``judge_advance``); a metric reader
``pgbench/metrics/<name>.py`` with ``read(record)``, returning None where
it finds nothing to read.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one host thread for the process's numerical libraries: the card's host
# is shared, and the step is host-bound where the mesh is small
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "nupgcm_tpu")


def loaded_forbidden() -> list:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _caches(root):
    """Build and kernel caches at fixed paths inside the checkout."""
    base = os.path.join(root, ".pgbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help="run the correctness control (the program with TF32 on) "
                         "instead of the program; not a benchmark run")
    return ap.parse_args(argv)


def run(args, device="cuda", cfg=None, traffic=None, fault=None, out=sys.stdout) -> int:
    """One run; returns the exit code.  ``cfg``, ``traffic`` and ``fault``
    (a function of the state before and after a step that returns the
    state the window keeps) replace the cell's own, for tests."""
    from . import judge, spec

    _caches(str(spec.ROOT))
    import torch

    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = cfg or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"pgbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from .session import Session, failed_steps

    sess = Session(cfg, traffic, args.seed, spec.system(cfg), device=device,
                   control=args.control, fault=fault)
    sess._sync()
    setup_s = time.perf_counter() - T_START
    if args.trace:
        rec = sess.traced_window(args.seconds, traffic.get("trace_replays", 1))
    else:
        rec = sess.window(args.seconds)
    rec["setup_s"] = setup_s
    rec["seconds_asked"] = args.seconds
    rec["segment_steps"] = sess.n_seg
    cuda = sess.device.type == "cuda"
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(sess.device) if cuda else None
    bad = loaded_forbidden()
    if bad:
        print(f"pgbench: JAX or the JAX package loaded in the benchmark process: {bad}",
              file=sys.stderr)
        return 3
    failed = failed_steps(rec["aux"], sess.model.inv_opts["itmax"], sess.model.evo_opts["itmax"])
    sess.judged_replay()
    sess.release()
    checks = judge.judge(sess, cfg, traffic)
    correct = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    metrics = {}
    for m in spec.metrics_for(bench, cell["name"], bool(args.trace)):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else sess.device.type,
           "kind": torch.cuda.get_device_name(sess.device) if cuda else sess.device.type,
           "count": 1, "memory_peak_bytes": rec["peak_bytes"]}
    result = {"correct": correct, "attempted": rec["steps"], "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        t = rec.get("trace") or {}
        if "busy_s" in t:
            dev.update(busy_s=t["busy_s"], window_s=t["wall_s"])
            result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None):
    sys.exit(run(parse(argv)))


if __name__ == "__main__":
    main()
