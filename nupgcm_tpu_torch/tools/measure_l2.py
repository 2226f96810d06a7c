"""The 0.87M-DoF bowl with the aggregate (L2) coarse level on one card.

PyTorch counterpart of the JAX package's ``tools/measure_l2.py``,
``measure_l2b.py`` and ``measure_l2c.py``, as one tool with three modes
on the mixing configuration of ``bowl3D(h, 0.5, nz)`` (``--h 0.033
--nz 12``: 36,096 vertices, 198,864 tets, 0.87M inversion DoF, the
aggregate level on):

  base   build; set_b; invert twice (the second timed); two blocks of
         ``--steps`` steps from the set_b state (the second timed)
  sweep  the saddle-coarse inner budget k in (8, 4, 2) by ``retune``,
         two blocks of ``--steps`` steps each from the set_b state
  k0     k = 0 (the two-level cycle applied directly), as ``sweep``

Every mode reports the JAX scripts' JSON keys (``compile_s`` is the
first block's wall seconds: nothing compiles here) plus ``n_dof``, the
build split (mesh, FEData, operators with the aggregate level apart:
its float64 assembly and inverse on the model's device, with the host
aggregation of the vertices within it as ``aggregation_s``; the
assembled operators' patterns within the operators as ``patterns_s``)
and the
peak device MiB; ``base`` and the rows also list each
timed step's CG and FGMRES counts and final residuals, and the timed
block's K1/K2 launches per step by mode and local size.  There is no retry
(the JAX scripts' works around their remote TPU), and JSON is written
only under ``--out``.

Usage: python -m nupgcm_tpu_torch.tools.measure_l2 [--mode base|sweep|k0]
           [--h 0.033] [--nz 12] [--steps 5] [--out FILE]
       ``main`` needs a CUDA device; ``run(..., device="cpu")`` works at
       small sizes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import generators
from ..ops import kernels
from ._common import initial_b, mixing_setup, require_cuda, synchronize

MODES = ("base", "sweep", "k0")
SWEEP_K = (8, 4, 2)


def log_err(*a):
    print(*a, file=sys.stderr, flush=True)


def _peak_mib(device):
    device = torch.device(device)
    return (torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda"
            else None)


def build(h=0.033, nz=12, device="cuda", dtype=torch.float32, **model_kw):
    """(model, info): the mixing configuration on bowl3D(h, 0.5, nz)
    and the seconds of its build's parts."""
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    mesh = generators.bowl3D(h, 0.5, nz=nz)
    t1 = time.perf_counter()
    model = mixing_setup(mesh, device, dtype, **model_kw)
    synchronize(device)
    t2 = time.perf_counter()
    fe, bs = model.fe, model.build_seconds
    info = {"h": h, "nz": nz, "n_vertices": mesh.n_vertices, "n_cells": mesh.n_cells,
            "n_dof": fe.n_inv, "preconditioner": model.preconditioner_branch,
            "n_agg": int(model.ops["sc2_inv"].shape[0] // 4) if "sc2_inv" in model.ops else 0,
            "mesh_s": t1 - t0,
            "fedata_s": t2 - t1 - bs["constants"] - bs["operators"],
            "operators_s": bs["constants"] + bs["operators"] - bs.get("aggregate_level", 0.0),
            "aggregate_s": bs.get("aggregate_level", 0.0),
            "aggregation_s": bs.get("aggregation", 0.0), "patterns_s": bs.get("patterns", 0.0),
            "build_s": t2 - t0,
            "build_peak_mib": _peak_mib(device)}
    return model, info


def _per_step(auxs):
    return [{"evo_iters": int(e), "evo_res": float(er), "inv_iters": int(i),
             "inv_res": float(ir)}
            for e, er, i, ir in zip(auxs["evo_iters"], auxs["evo_res"], auxs["inv_iters"],
                                    auxs["inv_res"])]


def _blocks(model, state, steps):
    """Two blocks of ``steps`` steps from ``state``: (first block's
    seconds, second block's seconds, second block's auxs, its K1/K2
    launches per step by mode and local size)."""
    t0 = time.perf_counter()
    model.multi_step(state, steps)
    synchronize(model.device)
    first = time.perf_counter() - t0
    before = dict(kernels.shape_launches)
    t0 = time.perf_counter()
    _, auxs = model.multi_step(state, steps)
    synchronize(model.device)
    wall = time.perf_counter() - t0
    launches = {k: (v - before.get(k, 0)) / steps for k, v in kernels.shape_launches.items()
                if v > before.get(k, 0)}
    return first, wall, auxs, launches


def _row(k, steps, first, wall, auxs, launches, device):
    return {"k": k, "steps_per_s": steps / wall,
            "inv_it": float(np.mean(auxs["inv_iters"])), "inv_res": float(auxs["inv_res"][-1]),
            "evo_it": float(np.mean(auxs["evo_iters"])), "b_max": float(auxs["b_max"][-1]),
            "compile_s": first, "steps": _per_step(auxs), "launches_per_step": launches,
            "peak_mib": _peak_mib(device)}


def run(mode="base", h=0.033, nz=12, steps=5, model=None, info=None, device="cuda",
        dtype=torch.float32, out=None, log=log_err, **model_kw):
    """One mode on ``model`` (with its build ``info``) or on a model
    built here.  ``base`` returns a dict, ``sweep`` and ``k0`` a list of
    rows; each carries ``build`` (the build split).  ``sweep`` and
    ``k0`` restore the model's inner budget."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if model is None:
        if mode == "k0":
            model_kw.setdefault("saddle_coarse_inner", 0)
        model, info = build(h, nz, device, dtype, **model_kw)
    device = model.device
    info = dict(info or {"n_dof": model.fe.n_inv})
    log(f"build {info.get('build_s', float('nan')):.1f}s {model.fe.summary()} "
        f"l2={model.saddle_coarse_l2} na={info.get('n_agg')} "
        f"k={model.saddle_coarse_inner} method={model.inner_method}")
    state = model.set_b(model.rest_state(), initial_b)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    if mode == "base":
        invs = []
        for _ in range(2):
            synchronize(device)
            t0 = time.perf_counter()
            _, stats = model.invert(state, return_stats=True)
            synchronize(device)
            invs.append((time.perf_counter() - t0, stats))
            log(f"invert {invs[-1][0]:.3f}s iters={stats.iterations} res={stats.residual:.2e}")
        first, wall, auxs, launches = _blocks(model, state, steps)
        res = {"n_dof": model.fe.n_inv, "inv_seconds": invs[1][0],
               "inv_iters": int(invs[1][1].iterations),
               "inv_res_invert": float(invs[1][1].residual),
               "steps_per_s": steps / wall, "evo_it": float(np.mean(auxs["evo_iters"])),
               "inv_it": float(np.mean(auxs["inv_iters"])), "inv_res": float(auxs["inv_res"][-1]),
               "b_max": float(auxs["b_max"][-1]), "k": model.saddle_coarse_inner,
               "first_block_s": first, "steps": _per_step(auxs), "launches_per_step": launches,
               "peak_mib": _peak_mib(device), "build": info}
        log(json.dumps({k: v for k, v in res.items() if k not in ("steps", "build")}))
    else:
        base_k = model.saddle_coarse_inner
        res = []
        try:
            for k in (SWEEP_K if mode == "sweep" else (0,)):
                model.retune(saddle_coarse_inner=k)
                row = dict(_row(k, steps, *_blocks(model, state, steps), device),
                           n_dof=model.fe.n_inv, build=info)
                res.append(row)
                log(json.dumps({k_: v for k_, v in row.items() if k_ not in ("steps", "build")}))
        finally:
            model.retune(saddle_coarse_inner=base_k)
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


def main(argv=None):
    require_cuda()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="base", choices=MODES)
    ap.add_argument("--h", type=float, default=0.033)
    ap.add_argument("--nz", type=int, default=12)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.mode, args.h, args.nz, args.steps, out=args.out)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
