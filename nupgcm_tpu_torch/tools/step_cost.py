"""Where a step of the 0.87M-DoF bowl spends the host's time, at the
saddle-coarse inner budgets k = 0 and k = 8, for this tree or another.

On the mixing configuration of ``bowl3D(0.033, 0.5, nz=12)`` (the
aggregate coarse level on; ``tools/measure_l2.build``), after set_b,
invert and two warm steps, it reads for each k, every reading over the
same 3 steps, 3-5 from set_b, which run the coarse level (FGMRES 8, 6, 6
at k = 0 and 5, 4, 4 at k = 8 on an H100); a few steps later the flow
has settled and a step costs a fraction as much at either k:

  walls        ``--windows`` windows of those steps, each between two
               synchronises (seconds), with each step's FGMRES count
  busy         device-busy ms per step, from the 3 steps profiled in a
               trace that lost no launch (``kernel_bench.busy_share``)
  host costs   host µs per call, each from 1,000 calls timed before the
               synchronise (200 for the set-up): the coarse saddle
               operator's ``matvec`` and ``up_matvec`` (the calls the
               coarse level makes 136 and 64 times a step at k = 8),
               the coarse P1 vector velocity block's ``matvec`` (its
               viscous smoother's costs the same), the P2-P1 pressure
               coupling's (once an outer FGMRES iteration), and the
               inversion preconditioner's set-up (``_make_inv_precond``,
               once a solve)
  profile      a ``cProfile`` of 3 steps: the functions with the most
               own time, each with its calls per step, and the step's
               total

The host costs and the profile find the Python work that differs
between two trees; the walls show whether it reaches the step.  Run the
parent and the change in turns in one call on one card:

    python nupgcm_tpu_torch/tools/step_cost.py --root out/parent --out a.json
    python nupgcm_tpu_torch/tools/step_cost.py --root . --out b.json

It imports ``nupgcm_tpu_torch`` from ``--root``; a tree without the
assembled coarse operator (``PGModel._sc_op``) applies its element
``SaddleOperator`` (``_saddle_coarse_operator``), and one without the
held assembled operators (``PGModel._held``) applies K1 for the coarse
velocity block (``_coarse_operator`` of the tensor) and the P2-P1
coupling (``_inv_matrix(...).up_matvec``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pathlib
import pstats
import statistics
import sys
import time

import numpy as np
import torch

KS = (0, 8)
TOP = 25


def host_us(fn, n=1000):
    """Host µs per call: ``n`` calls timed before the synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def coarse_operator(model):
    """The coarse saddle operator a solve applies, in either tree."""
    op = getattr(model, "_sc_op", None)
    return op if op is not None else model._saddle_coarse_operator(model.ops)


def velocity_operator(model):
    """The coarse P1 vector velocity block a solve applies, in either tree."""
    held = getattr(model, "_held", None)
    return held["sc_uu"] if held is not None else model._coarse_operator(model.ops["sc_uu"])


def coupling(model):
    """The P2-P1 pressure coupling a solve applies, in either tree."""
    held = getattr(model, "_held", None)
    return held["A_up_e"].matvec if held is not None else model._inv_matrix(model.ops).up_matvec


def profile_steps(model, state, n=3):
    """(rows, s per step): ``cProfile`` of ``n`` steps from ``state``,
    the TOP functions by own time with calls and ms per step."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(n):
        state, _ = model.step(state)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = []
    for (file, line, fn), (_, ncalls, tottime, cumtime, _) in st.stats.items():
        rows.append(dict(fn=f"{pathlib.Path(file).name}:{line}:{fn}", calls=ncalls / n,
                         own_ms=1e3 * tottime / n, cum_ms=1e3 * cumtime / n))
    rows.sort(key=lambda r: -r["own_ms"])
    return rows[:TOP], st.total_tt / n


def run(windows=5, log=print):
    from nupgcm_tpu_torch.ops import kernels as K
    from nupgcm_tpu_torch.tools import kernel_bench as kb
    from nupgcm_tpu_torch.tools import measure_l2
    from nupgcm_tpu_torch.tools._common import card_name_limit, initial_b

    model, info = measure_l2.build(0.033, 12, "cuda", torch.float32)
    state = model.invert(model.set_b(model.rest_state(), initial_b))
    out = {"card": card_name_limit(), "tree": str(pathlib.Path(K.__file__).parents[2]),
           "build_s": info["build_s"], "n_dof": info["n_dof"]}
    nv = model.fe.spaces.p_space.ndof
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(4 * nv), dtype=torch.float32, device="cuda")
    xp = x[3 * nv:].clone()
    xu = x[:3 * nv].clone()
    xpf = torch.as_tensor(rng.standard_normal(model.fe.spaces.n_p), dtype=torch.float32,
                          device="cuda")
    for k in KS:
        model.retune(saddle_coarse_inner=k)
        st0 = state
        for _ in range(2):
            st0, _ = model.step(st0)
        walls, its = [], []
        for _ in range(windows):
            st = st0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                st, aux = model.step(st)
                its.append(int(aux["inv_iters"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        K.reset_counts()
        share, pwall, _, _ = kb.busy_share(model, st0, n=3)
        launches = {key: v / 3 for key, v in K.shape_launches.items() if v}
        cop, vel, up = coarse_operator(model), velocity_operator(model), coupling(model)
        costs = {"coarse_matvec_us": host_us(lambda: cop.matvec(x)),
                 "coarse_up_matvec_us": host_us(lambda: cop.up_matvec(xp)),
                 "coarse_uu_matvec_us": host_us(lambda: vel.matvec(xu)),
                 "coupling_matvec_us": host_us(lambda: up(xpf)),
                 "precond_setup_us": host_us(lambda: model._make_inv_precond(model.ops), 200)}
        rows, prof_s = profile_steps(model, st0)
        rec = dict(walls_s_3=walls, inv_iters=its[:3],
                   median_ms_per_step=1e3 * statistics.median(walls) / 3,
                   busy_ms_per_step=None if share is None else 1e3 * share * pwall / 3,
                   launches_per_step=launches, **costs, profiled_ms_per_step=1e3 * prof_s,
                   profile_top=rows)
        out[f"k{k}"] = rec
        log(f"[step_cost] k = {k}: 3-step windows {[round(w * 1e3, 1) for w in walls]} ms "
            f"(median {rec['median_ms_per_step']:.1f} ms a step; FGMRES {its[:3]}), busy "
            f"{rec['busy_ms_per_step']} ms a step; host us: coarse matvec "
            f"{costs['coarse_matvec_us']:.1f}, up_matvec {costs['coarse_up_matvec_us']:.1f}, "
            f"velocity block {costs['coarse_uu_matvec_us']:.1f}, P2-P1 coupling "
            f"{costs['coupling_matvec_us']:.1f}, preconditioner set-up "
            f"{costs['precond_setup_us']:.1f}; cProfile "
            f"{rec['profiled_ms_per_step']:.1f} ms a step ({out['card']})")
        for r in rows[:12]:
            log(f"    {r['own_ms']:8.2f} ms own {r['cum_ms']:8.2f} cum {r['calls']:8.1f} calls  "
                f"{r['fn']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="tree whose nupgcm_tpu_torch is measured")
    ap.add_argument("--windows", type=int, default=5, help="3-step windows at each k")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    if not torch.cuda.is_available():
        raise RuntimeError("step_cost needs a CUDA device")
    res = run(args.windows, log=lambda *a: print(*a, flush=True))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
