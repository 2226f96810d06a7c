#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (nupgcm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failed check raises, and the script exits non-zero):

  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA element-matvec kernels from csrc/.
  3. kernels vs plain: every kernel case of the h = 0.08 bowl3D model
     (each mode at each local size the step runs: the P2-P1 operator,
     the P2 velocity block and viscous smoother, the P1-P1 coarse
     saddle, its coupling, velocity block and viscous smoother, K2 on
     the buoyancy and pressure spaces), through the model's own
     prepared launch, against its plain PyTorch version in f32 (bar
     2e-6 max|y|) and f64 (bar 1e-12 max|y|); the atomics sum in a
     different order on every run.  Then, in f32, every case is timed
     beside the CSR library call (tools/kernel_bench.py): wrapper time
     (CUDA events around 20 calls in a row, median of 10 batches),
     device time (profiler busy time over 20 calls), host µs per call
     (1,000 calls before the synchronise) and the bound.
  3c. edge cases: every phase-3 case with the cells in a shuffled order
     (the widest block dof lists) and with blocks of 12 or 20 cells (a
     ragged last block), against the plain versions at the phase-3
     bars; after phase 5 the same cases of the 2D bowl2D model (P2-P1
     triangles).
  4. slice: PGModel on bowl3D(0.08, 0.5, nz=9) in f32 (the bench.py
     mixing configuration): set_b, invert, 10 BDF2 steps.  Every state
     is finite, every solve stays under its iteration cap, every kernel
     of the path launched and no plain version ran.
  3b. probes vs plain: K3 stream_saddle and K1 pinned on the slice's
     element tensors in f32 and f64, K4 stream_probe in f32 on
     profile_stream's shapes.  Bars: K1 pinned as phase 3; K3 and K4
     2e-6 (f32) / 1e-12 (f64) of each lane's sum of |values|.
  5. golden: the bowl2D mixing run in f32 on the card, to the time of
     tests/data/bowl_mixing_2d.npz (t = 5.1: 51 BDF2 steps), FE-integral
     relative L2 below 1e-3 for b and u.
  6. tools: nupgcm_tpu_torch.tools' profile_matvec, profile_stream (at
     39 MB, inside the L2, and 299 MB), profile_step and sweep_inner
     (six budgets, 5 steps each) on the slice model.  Every result is
     finite, every solve stays under its cap, every probe launched and
     no plain version ran.
  7. trace: 5 steps under utils.timing.device_trace (Chrome trace in
     out/trace/); the device-busy share and the top kernels by device
     time.
  8. full physics (convection + eddy closures, wind, refresh_precond):
     8a. tools.northstar.build_model("full") on its generated
         bowl3D(0.1, 0.5, nz=7), in f32 and then in f64:
         run(max_steps=30, n_precond_refresh=10) (an eddy rebuild inside
         steps 10, 20 and 30, each followed by a refresh; both seen in
         the operators), every solve under its cap, and the state at
         step 30 against tests/data/bowl3d_full_30.npz (JAX, CPU, f64,
         the same run; FE-integral relative L2).  f64 is held to 1e-3
         for u and b, and a checkpoint at step 15 resumed to 30 to
         within 1e-4 of max|u| and max|b| of the straight run (the
         atomics sum in another order on every run, and the closures'
         sharp switches amplify such last-bit differences).  f32 prints
         its distance without a bar: the same amplification carries the
         packages' tolerance-level differences to several 1e-2 of
         max|b| in 30 steps even in f64, and f32 rounding adds to it.  A refresh
         after each rebuild, not after 25 steps: on the preconditioner
         of the build-time viscosity FGMRES reaches its cap of 500 in
         the steps after the step-20 rebuild, in f32 and f64 (python
         tests/test_torch_production.py counts f32).
     8b. tools.production.build_model(0.04) in f32 (reduced from the
         tool's h = 0.02 to fit this script's time limit): every kernel
         mode against its plain version on its tensors, the evolution
         matrix with the convective Kv (P1 buoyancy, nl = 4), bars of
         phase 3; then run(max_steps=26, n_precond_refresh=25), whose
         FGMRES stalls from the first step in both packages (reported).
     Both: every state finite, every solve under its cap (8b: CG only),
     every kernel of the path launched, no plain version ran.

Phases 3 and 8b time each kernel case beside one library call that
computes the same function: cuSPARSE through torch.sparse.mm on the
operator assembled to CSR here (never in the port).  Each kernel's
bound is the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its multiply-adds over 67 TFLOP/s
(H100 SXM f32 without tensor cores).  Phases 4 and 8 print the
launches per mode and local size (kernels.shape_launches).

Phases run in the order 1, 2, 4a (build the slice), 3, 3c, 3b, 4b
(step it), 6, 7, 5 (with the 2D edge cases), 8a, 8b.  The last three
lines are the card's name and power limit, a JSON object {"kernels": [...]}, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
REPLACES = {"saddle_matvec": "nupgcm_tpu/ops/window.py:769",
            "scalar_matvec": "nupgcm_tpu/ops/window.py:865",
            "saddle_matvec[pinned]": "tools/profile_matvec.py:203",
            "stream_saddle": "tools/profile_matvec.py:174",
            "stream_probe": "tools/profile_stream.py:75"}
SOURCES = {"saddle_matvec": "nupgcm_tpu_torch/csrc/element_matvec.cu",
           "scalar_matvec": "nupgcm_tpu_torch/csrc/element_matvec.cu",
           "saddle_matvec[pinned]": "nupgcm_tpu_torch/csrc/element_matvec.cu",
           "stream_saddle": "nupgcm_tpu_torch/csrc/stream_probe.cu",
           "stream_probe": "nupgcm_tpu_torch/csrc/stream_probe.cu"}
BARS = {"float32": 2e-6, "float64": 1e-12}
RESUME_BAR = 1e-4          # phase 8a (f64), relative to max|u| and max|b|
STEP_COUNTERS = ("saddle_full", "saddle_full_pp", "saddle_uu", "saddle_up", "scalar")
STREAM_SHAPES = ((3, 128, False), (1, 512, True))  # K4 cases of profile_stream


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def phase_kernels(model, K, card_name, tag="kernels", Kv_e=None):
    """Every kernel case of the model (its own prepared launch over its
    block tables) against its plain version in f32 and f64, then, in
    f32, timed beside the CSR library call (``tools/kernel_bench``):
    wrapper, device and host time, bound.  Returns per-(entry, mode)
    records: the first (largest) case's numbers, every case in "cases"."""
    import torch

    from nupgcm_tpu_torch.tools import kernel_bench as kb

    results = {}
    for case in kb.kernel_cases(model, Kv_e):
        name = case["entry"] + ("" if case["mode"] is None else f"[{case['mode']}]")
        err = check_case(model, K, case, name, tag)
        rec = kb.measure_case(model, K, case, log=lambda *a: print(*a, f"({card_name})",
                                                                   flush=True), tag=tag)
        check(rec["lib_rel_err"] <= BARS["float32"],
              f"{name} {case['label']}: the CSR yardstick disagrees with plain")
        top = results.setdefault(name, dict(rec, name=name, max_abs_err=0.0, cases=[],
                                            counter="scalar" if case["mode"] is None
                                            else f"saddle_{case['mode']}"))
        top["max_abs_err"] = max(top["max_abs_err"], err)
        top["cases"].append(rec)
    return results


def check_case(model, K, case, name, tag):
    """A case's kernel against its plain version in f32 and f64 at the
    BARS of max|y|; returns the f32 max|y - y_plain|."""
    import torch

    from nupgcm_tpu_torch.tools import kernel_bench as kb

    out = None
    for dtype in (torch.float32, torch.float64):
        kfn, pfn, _ = kb.case_fns(model, K, case, dtype)
        y, y0 = kfn(), pfn()
        torch.cuda.synchronize()
        check(torch.isfinite(y).all().item(), f"{name} {case['label']}: non-finite output")
        err = float((y - y0).abs().max())
        scale = float(y0.abs().max())
        bar = BARS[str(dtype)[6:]]
        print(f"[{tag}] {name:24s} {case['label']:34s} {str(dtype)[6:]}: "
              f"max|y-y_plain| = {err:.3e} = {err / scale:.2e} max|y| (bar {bar:.0e})",
              flush=True)
        check(err <= bar * scale, f"{name} {case['label']} {dtype}: kernel disagrees with plain")
        out = err if out is None else out
    return out


def phase_edges(model, K, tag):
    """Edge cases of the block tables against the plain versions: the
    cells in a shuffled order (the widest block lists) and blocks of 12
    (or 20) cells that leave a ragged last block, on every case of
    ``model``."""
    import torch

    from nupgcm_tpu_torch.ops import blocks
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    nc = model.const["cd_u"].shape[0]
    perm = torch.as_tensor(np.random.default_rng(3).permutation(nc), device=model.device)
    ragged = 12 if nc % 12 else 20
    check(nc % ragged != 0, f"{tag}: blocks of {ragged} cells divide the cell count")
    for case in kb.kernel_cases(model):
        name = case["entry"] + ("" if case["mode"] is None else f"[{case['mode']}]")
        for how in ("shuffled", "ragged"):
            c = dict(case, label=f"{case['label']}, {how}")
            if how == "shuffled":
                c["blocks"] = tuple(None if t is None else t[perm] for t in case["blocks"])
                c["cd"] = tuple(t[perm] for t in case["cd"])
            cd = c["cd"]
            if case["mode"] is None:
                c["tables"] = (blocks.build(cd[0], ragged) if how == "ragged"
                               else blocks.scalar_table(cd[0], 4))
            elif how == "ragged":
                c["tables"] = (blocks.build(cd[0], ragged),
                               None if case["mode"] == "uu" else blocks.build(cd[1], ragged))
            else:
                c["tables"] = blocks.saddle_tables(cd[0], cd[1], case["mode"], 4)
            check_case(model, K, c, name, tag)


def probe_check(name, dtype, out, ref, scale, scale_name, card_name, kfn, pfn, work):
    """Kernel output vs plain, bar BARS[dtype] of ``scale`` (per entry,
    or one number); for f32 prints both times and the bound of ``work``
    = (bytes, flops).  No single library call computes a probe's
    function: its library_ms is null."""
    import torch

    from nupgcm_tpu_torch.tools import kernel_bench as kb

    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
    err = float((out - ref).abs().max())
    rel = float(((out - ref).abs() / scale.clamp_min(1e-300)).max())
    bar = BARS[str(dtype)[6:]]
    print(f"[probes] {name:22s} {str(dtype)[6:]}: max|o-o_plain| = {err:.3e} = "
          f"{rel:.2e} {scale_name} (bar {bar:.0e})", flush=True)
    check(rel <= bar, f"{name} {dtype}: kernel disagrees with plain")
    rec = {"name": name, "entry": name, "max_abs_err": err}
    if dtype == torch.float32:
        rec["ms"], rec["plain_ms"] = kb.median_ms(kfn), kb.median_ms(pfn)
        rec["device_ms"], rec["host_us"] = kb.device_ms(kfn), kb.host_us(kfn)
        rec["bound_ms"], rec["bound_by"] = kb.bound(*work)
        rec["library_ms"] = rec["library_device_ms"] = None
        print(f"[probes] {name:22s} f32: {rec['ms']:.4f} ms kernel (device "
              f"{rec['device_ms']:.4f} ms, host {rec['host_us']:.1f} us), "
              f"{rec['plain_ms']:.4f} ms plain, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) ({card_name})", flush=True)
    return rec


def phase_probes(model, K, rng, card_name):
    """K3, K1 pinned and K4 vs their plain versions on the card."""
    import torch

    from nupgcm_tpu_torch.tools.kernel_bench import nbytes

    o, c, fe = model.ops, model.const, model.fe
    n = fe.spaces.u_space.ndof
    results = {}
    x_np = rng.standard_normal(fe.n_inv)
    lane_sum = "of the lane's sum of |values|"
    for dtype in (torch.float32, torch.float64):
        uu, up, pu = (o[k].to(dtype) for k in ("A_uu_e", "A_up_e", "A_pu_e"))
        # K3 from a zero carry: the output is 1e-30 times the lane sums
        carry = torch.zeros((1, K.LANES), dtype=torch.float32, device="cuda")
        k3 = (uu, up, pu, carry)
        rec = probe_check("stream_saddle", dtype, K.stream_saddle(*k3),
                          K.stream_saddle_plain(*k3),
                          K.stream_saddle_plain(uu.abs(), up.abs(), pu.abs(), carry),
                          lane_sum, card_name, lambda: K.stream_saddle(*k3),
                          lambda: K.stream_saddle_plain(*k3),
                          (nbytes(uu, up, pu, carry) + 4 * K.LANES,
                           uu.numel() + up.numel() + pu.numel()))
        if "ms" in rec:
            results["stream_saddle"] = dict(rec, counter="stream_saddle")
        # K1 pinned: the first 128 cells' tensors, every cell's dof tables
        pin = min(uu.shape[0], K.LANES)
        x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
        k1 = (uu[:pin], up[:pin], pu[:pin], c["cd_u"], c["cd_p"], x, n)
        launch = K.saddle_launch(*k1[:3], None, c["blk_fine"]["full"], "full", n, fe.spaces.n_p,
                                 pinned=True)
        kfn = lambda: launch(x)
        y0 = K.saddle_matvec_pinned_plain(*k1)
        per_cell = uu[0].numel() + up[0].numel() + pu[0].numel()
        rec = probe_check("saddle_matvec[pinned]", dtype, kfn(), y0, y0.abs().max(),
                          "max|y|", card_name, kfn, lambda: K.saddle_matvec_pinned_plain(*k1),
                          (nbytes(*k1[:6]) + nbytes(x), 2 * per_cell * c["cd_u"].shape[0]))
        if "ms" in rec:
            results["saddle_matvec[pinned]"] = dict(rec, counter="saddle_full_pinned")
    # K4 on profile_stream's shapes: 1140 x 8576 cells
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n_inputs, B, with_idx in STREAM_SHAPES:
        nb = 8576 // B
        rows = (900, 120, 120) if n_inputs == 3 else (1140,)
        parts = [torch.randn((nb, r * B // K.LANES, K.LANES), generator=gen, device="cuda")
                 for r in rows]
        idx = ([torch.randint(-9, 10, (nb, 1, 1280), generator=gen, device="cuda",
                              dtype=torch.int32) for _ in range(8)] if with_idx else None)
        w0 = torch.full((nb,), 7, dtype=torch.int32, device="cuda")
        out, chk = K.stream_probe(parts, w0, idx)
        ref, chk0 = K.stream_probe_plain(parts, w0, idx)
        scale, _ = K.stream_probe_plain([p.abs() for p in parts], w0.abs())
        name = f"stream_probe s{n_inputs}{'idx' if with_idx else ''}_B{B}"
        rec = probe_check(name, torch.float32, out, ref, scale, lane_sum, card_name,
                          lambda: K.stream_probe(parts, w0, idx),
                          lambda: K.stream_probe_plain(parts, w0, idx),
                          (nbytes(*parts, w0, *(idx or ())) + 4 * K.LANES,
                           sum(q.numel() for q in parts)))
        if with_idx:
            check(int(chk) == int(chk0), f"{name}: index checksum {int(chk)} != {int(chk0)}")
        if "stream_probe" not in results:  # the TPU layout, three parts
            results["stream_probe"] = dict(rec, name="stream_probe", entry="stream_probe",
                                           counter="stream_probe")
    return results


def phase_tools(model, K, card_name):
    """The measurement tools on the slice model; returns the launches."""
    import torch

    from nupgcm_tpu_torch.tools import (profile_matvec, profile_stream, profile_step,
                                        sweep_inner)

    tag = lambda *a: print("[tools]", *a, flush=True)
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    pm = profile_matvec.run(model=model, log=tag)
    streams = [profile_stream.run(1140, ncell, 50, "cuda", log=tag) for ncell in (8576, 65536)]
    ps = profile_step.run(model=model, log=tag)
    sw = sweep_inner.run(model=model, steps=5, log=tag)
    torch.cuda.synchronize()
    launches, plain = dict(K.launches), dict(K.plain_calls)
    print(f"[tools] {time.perf_counter() - t0:.2f} s; launches {launches}; plain calls "
          f"{plain} ({card_name})", flush=True)
    nums = [*pm["ms"].values(), *ps["ms"].values()]
    nums += [v for r in streams for cfg in r["configs"].values() for v in cfg.values()
             if v is not None]
    nums += [r[k] for r in sw for k in ("steps_per_s", "evo_it", "inv_it", "inv_res", "b_max")]
    check(bool(np.isfinite(nums).all()), "tools: a non-finite result")
    check(all(r["evo_it_max"] < model.evo_opts["itmax"]
              and r["inv_it_max"] < model.inv_opts["itmax"] for r in sw),
          "tools: a solve hit its iteration cap")
    for k in ("stream_saddle", "stream_probe", "saddle_full_pinned", "saddle_full",
              "saddle_uu"):
        check(launches[k] > 0, f"tools: {k} never launched")
    check(all(v == 0 for v in plain.values()), f"tools: a plain version ran on the card: {plain}")
    return launches


def phase_trace(model, state, card_name):
    """5 steps unprofiled, then 5 under device_trace: busy share and
    the top kernels by device time."""
    import torch

    from nupgcm_tpu_torch.utils import timing

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        state, _ = model.step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with timing.device_trace(str(ROOT / "out" / "trace")) as path:
        t0 = time.perf_counter()
        for _ in range(5):
            state, _ = model.step(state)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    summ = timing.trace_summary(path)
    busy = summ["busy_us"] / 1e6
    check(busy > 0, "trace: the profiler saw no device work")
    print(f"[trace] 5 steps: device busy {busy * 1e3:.3f} ms of {wall_prof * 1e3:.3f} ms "
          f"profiled wall ({100 * busy / wall_prof:.1f}%), of {wall * 1e3:.3f} ms unprofiled "
          f"wall ({100 * busy / wall:.1f}%); trace {pathlib.Path(path).relative_to(ROOT)} "
          f"({card_name})", flush=True)
    total = sum(us for _, us in summ["by_name"].values())
    for name, (calls, us) in list(summ["by_name"].items())[:10]:
        print(f"[trace] {us / 1e3:9.3f} ms {100 * us / total:5.1f}% {calls:6d} calls  "
              f"{name[:90]}", flush=True)
    return state


def run_checked(model, state, K, tag, card_name, inv_capped_ok=False, **run_kw):
    """``model.run(state, **run_kw)`` with the kernel counts set to 0
    just before and read just after.  Checks every step's CG solve
    against its cap (and FGMRES's, unless ``inv_capped_ok``), a finite
    final state, that every kernel of the path launched and that no
    plain version ran.  Returns the state."""
    import torch

    from nupgcm_tpu_torch.tools.production import run_logged

    refresh, spent = model.refresh_precond, []

    def timed_refresh(ops, st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = refresh(ops, st)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    model.refresh_precond = timed_refresh
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    try:
        state, auxs = run_logged(model, state, **run_kw)
        torch.cuda.synchronize()
    finally:
        del model.refresh_precond
    wall = time.perf_counter() - t0
    launches, plain = dict(K.launches), dict(K.plain_calls)
    n = len(auxs)
    steps_s = wall - sum(spent)
    print(f"[{tag}] {n} steps in {steps_s:.3f} s = {n / steps_s:.3f} steps/s, plus "
          f"{len(spent)} refresh_precond in {sum(spent):.3f} s ({card_name})", flush=True)
    print(f"[{tag}] evo_iters per step {[int(a['evo_iters']) for a in auxs]}", flush=True)
    print(f"[{tag}] inv_iters per step {[int(a['inv_iters']) for a in auxs]}", flush=True)
    print(f"[{tag}] inv_res per step {[float('%.3g' % a['inv_res']) for a in auxs]}",
          flush=True)
    print(f"[{tag}] launches {launches} = per step "
          f"{ {k: round(v / n, 2) for k, v in launches.items() if v} }; plain calls {plain}",
          flush=True)
    print(f"[{tag}] launches per step by mode and local size "
          f"{ {k: round(v / n, 2) for k, v in K.shape_launches.items() if v} }", flush=True)
    capped = [i + 1 for i, a in enumerate(auxs) if a["inv_iters"] >= model.inv_opts["itmax"]]
    print(f"[{tag}] FGMRES at its cap ({model.inv_opts['itmax']}) in steps {capped}", flush=True)
    for i, a in enumerate(auxs):
        check(a["evo_iters"] < model.evo_opts["itmax"], f"{tag} step {i + 1}: CG hit its cap")
        check(bool(np.isfinite(a["inv_res"])), f"{tag} step {i + 1}: FGMRES residual not finite")
    check(inv_capped_ok or not capped, f"{tag}: FGMRES hit its cap")
    for f in ("u", "p", "b", "u_prev", "b_prev"):
        check(bool(torch.isfinite(getattr(state, f)).all()), f"{tag}: non-finite {f}")
    path = [k for k in STEP_COUNTERS
            if not (k == "saddle_full_pp" and "sc_uu" not in model.ops)]
    check(all(launches[k] > 0 for k in path), f"{tag}: a kernel of the path never launched")
    check(all(v == 0 for v in plain.values()), f"{tag}: a plain version ran on the card")
    return state


def phase_northstar_full(K, card_name):
    """8a: the north-star full-physics configuration, 30 steps with a
    refresh after each eddy rebuild, in f32 and in f64."""
    import torch

    for dtype in (torch.float32, torch.float64):
        northstar_run(K, card_name, dtype)
        torch.cuda.empty_cache()


def northstar_run(K, card_name, dtype):
    """One 8a run against the JAX golden.  f64 is held to the golden's
    bar, and a checkpoint at 15 resumed to 30 to the straight run.  f32
    prints its distance to the golden without a bar: the two packages'
    solves agree to their tolerance, the closures' sharp switches carry
    that to several 1e-2 of max|b| in 30 steps even between the
    packages' f64 runs on the CPU (python tests/test_torch_production.py
    lockstep), and f32 rounding adds to it."""
    import torch

    from nupgcm_tpu_torch.io import checkpoint as ck
    from nupgcm_tpu_torch.tools import northstar

    tag = f"8a {str(dtype)[6:]}"
    f64 = dtype == torch.float64
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, mesh_src = northstar.build_model("full", device="cuda", dtype=dtype)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fe = model.fe
    print(f"[{tag}] northstar full, {mesh_src}: {fe.mesh.n_vertices} vertices, "
          f"{fe.mesh.n_cells} cells, {fe.n_inv} inversion DoF; preconditioner "
          f"{model.preconditioner_branch}, inner_method {model.inner_method}; build "
          f"{build_s:.2f} s ({card_name})", flush=True)
    check((fe.mesh.n_cells, fe.mesh.n_vertices) == (11928, 2335), f"{tag}: not the tool's mesh")

    # the eddy closure's operators depend on the history of b, so the
    # checkpoint at step 15 keeps the operators it was taken with
    ck_path = ROOT / "out" / "northstar_full_000015.npz"
    ck_path.parent.mkdir(exist_ok=True)
    at15 = {}

    def save(m, st, i):
        if i == 15 and f64:
            ck.save_state(m, st, str(ck_path))
            at15["ops"] = {k: v.clone() for k, v in m.ops.items()}

    # run calls the plot callback before its refresh: a rebuild inside
    # step i shows at i, the refresh after step i at i + 1
    changed = {"A_uu_e": [], "visc_e": []}
    prev = {k: model.ops[k].clone() for k in changed}

    def watch(m, st, i):
        for k in changed:
            if not torch.equal(m.ops[k], prev[k]):
                changed[k].append(i)
                prev[k] = m.ops[k].clone()

    state = run_checked(
        model, model.rest_state(), K, tag, card_name, n_info=0, max_steps=30,
        n_precond_refresh=10, n_save=1, save_callback=save, n_plot=1, plot_callback=watch)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] A_uu_e changed after steps {changed['A_uu_e']}, visc_e after "
          f"{changed['visc_e']}; peak device memory {peak / 2**20:.1f} MiB ({card_name})",
          flush=True)
    check(set(changed["A_uu_e"]) >= {10, 20, 30}, f"{tag}: an eddy rebuild was not seen")
    check(changed["visc_e"] == [11, 21], f"{tag}: the refreshes were not seen where expected")

    ref = np.load(ROOT / "tests" / "data" / "bowl3d_full_30.npz")
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref_b = bs.from_original_order(ref["b"])
    ref_u = np.stack([us.from_original_order(ref["u"].reshape(-1, 3)[:, k])
                      for k in range(3)], axis=1)
    eb = northstar.rel_l2(fe, state.b.double().cpu().numpy(), ref_b, fe.cd_b, fe.tab_b.phi)
    eu = northstar.rel_l2(fe, state.u.double().cpu().numpy(), ref_u, fe.cd_u, fe.tab_u.phi)
    t, t_ref = float(state.t), float(ref["t"])
    print(f"[{tag}] step {state.step}, t = {t:.7f} (golden {t_ref:.7f} after "
          f"{int(ref['steps'])} steps): FE rel-L2 b = {eb:.3e}, u = {eu:.3e}"
          f"{' (bar 1e-3)' if f64 else ' (no bar in f32)'}",
          flush=True)
    check(state.step == int(ref["steps"]) == 30, f"{tag}: the run stopped at another step")
    if not f64:
        return
    check(abs(t - t_ref) <= 1e-3 * t_ref, f"{tag}: the adaptive clock drifted from the golden")
    check(eb < 1e-3 and eu < 1e-3, f"{tag}: the state disagrees with the golden file")

    # resume from the checkpoint with its operators: a refresh after
    # step 20, as in the straight run (the one after 30 does not touch
    # the state at 30)
    model.ops = at15["ops"]
    st15 = ck.load_state(model, str(ck_path))
    check(st15.step == 15 and st15.u.dtype == dtype and st15.u.is_cuda,
          f"{tag}: the checkpoint holds another step, or loaded off the model's device")
    st_r = model.run(st15, n_info=0, max_steps=20, n_precond_refresh=5)
    st_r = model.run(st_r, n_info=0, max_steps=30)
    du = float((st_r.u - state.u).abs().max() / state.u.abs().max())
    db = float((st_r.b - state.b).abs().max() / state.b.abs().max())
    print(f"[{tag}] resume 15 -> 30: max|du| = {du:.3e} max|u|, max|db| = {db:.3e} max|b| "
          f"(bar {RESUME_BAR:.0e})", flush=True)
    check(st_r.step == 30 and du <= RESUME_BAR and db <= RESUME_BAR,
          f"{tag}: the resumed run disagrees with the straight run")


def phase_production(K, card_name):
    """8b: the production configuration at h = 0.04: kernels vs plain
    on its tensors, then 26 steps with a refresh after 25."""
    import torch

    from nupgcm_tpu_torch.fem import assembly as asm
    from nupgcm_tpu_torch.tools import production

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, mesh, _ = production.build_model(0.04, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated()
    fe = model.fe
    print(f"[8b] production h = 0.04 (reduced from 0.02): {mesh.n_vertices} vertices, "
          f"{mesh.n_cells} cells, {fe.n_inv} inversion DoF, {fe.spaces.n_b} P{fe.spaces.b_order} "
          f"buoyancy DoF; preconditioner {model.preconditioner_branch}, inner_method "
          f"{model.inner_method}, saddle_coarse_inner {model.saddle_coarse_inner}; build "
          f"{build_s:.2f} s, peak device memory {build_peak / 2**20:.1f} MiB ({card_name})",
          flush=True)
    check((mesh.n_cells, mesh.n_vertices) == (41520, 8346), "8b: not the h = 0.04 mesh")
    state = model.rest_state()
    c = model.const
    kv_q = model.forcings.conv_param.kappa_v(c["kv_q"], model._abz(state.b))
    Kv_e = asm.elem_stiffness(c["wq"], kv_q, c["Gb3"], (2,))
    check(float(kv_q.max()) > 10 * float(c["kv_q"].max()), "8b: no convective Kv")
    results = phase_kernels(model, K, card_name, tag="8b kernels", Kv_e=Kv_e)
    del Kv_e, kv_q
    torch.cuda.reset_peak_memory_stats()
    # FGMRES stalls on this configuration from the first step, in the
    # JAX package as in the port (tests/test_torch_production.py::
    # test_production_aggregate_branch_matches): its cap is reported,
    # not held
    state = run_checked(model, state, K, "8b", card_name, inv_capped_ok=True,
                                 n_info=0, max_steps=26, n_precond_refresh=25)
    print(f"[8b] peak device memory over the run {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB; |u|max {float(state.u.abs().max()):.3e}, t {float(state.t):.4e}, "
          f"dt {float(state.dt):.4e} ({card_name})", flush=True)
    check(state.step == 26, "8b: the run stopped early")
    return results


def emit_tail(kernels, name_limit, kind, count):
    """The run's last three lines: the card, the kernels, the verdict."""
    print(name_limit)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def main():
    import torch

    # 1. device
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.ops import build
    from nupgcm_tpu_torch.ops import kernels as K
    from nupgcm_tpu_torch.tools import kernel_bench
    from nupgcm_tpu_torch.tools._common import card_name_limit, initial_b, mixing_setup
    from nupgcm_tpu_torch.tools.northstar import rel_l2

    check(pathlib.Path(npg.__file__).resolve().is_relative_to(ROOT),
          f"nupgcm_tpu_torch imported from outside {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card_name_limit()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {name_limit}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load()
    print(f"[build] {', '.join(sorted(set(SOURCES.values())))} -> "
          f"{build.library_path().relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s)", flush=True)
    log = (build.build_log or "").splitlines()
    regs = [int(w.split()[0]) for line in log if "Used" in line
            for w in [line.split("Used", 1)[1]]]
    spills = [line.strip() for line in log if "spill" in line and " 0 bytes spill" not in line]
    print(f"[build] ptxas: {sum('Compiling entry' in line for line in log)} kernels, "
          f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
          f"{len(spills)} with spills {spills[:3]}", flush=True)

    # 4a. the slice model (its element tensors feed phase 3)
    t0 = time.perf_counter()
    mesh = npg.generators.bowl3D(0.08, 0.5, nz=9)
    model = mixing_setup(mesh, "cuda", torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fe = model.fe
    print(f"[slice] bowl3D(0.08, 0.5, nz=9): {mesh.n_vertices} vertices, "
          f"{mesh.n_cells} cells, {fe.n_inv} inversion DoF, {fe.spaces.n_b} buoyancy DoF; "
          f"preconditioner: {model.preconditioner_branch}, inner_method "
          f"{model.inner_method}, saddle_coarse_inner {model.saddle_coarse_inner}; "
          f"host+device build {build_s:.2f} s", flush=True)

    # 3. kernels vs plain on the slice's tensors, 3c. their edge cases
    results = phase_kernels(model, K, name_limit)
    phase_edges(model, K, "edges")

    # 3b. the measurement probes vs plain
    probes = phase_probes(model, K, np.random.default_rng(1), name_limit)

    # 4b. drive the main path through the kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t0 = time.perf_counter()
    state = model.invert(model.set_b(model.rest_state(), initial_b))
    torch.cuda.synchronize()
    t_inv = time.perf_counter() - t0
    check(bool(torch.isfinite(state.u).all() and torch.isfinite(state.p).all()),
          "invert: non-finite flow")
    print(f"[slice] set_b + invert: {t_inv:.3f} s", flush=True)
    t0 = time.perf_counter()
    stats = []
    for _ in range(10):
        state, aux = model.step(state)
        stats.append(aux)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    launches = dict(K.launches)
    plain = dict(K.plain_calls)
    for i, aux in enumerate(stats):
        print(f"[slice] step {i + 1}: evo_iters {aux['evo_iters']} (res {aux['evo_res']:.2e}), "
              f"inv_iters {aux['inv_iters']} (res {aux['inv_res']:.2e}), "
              f"|u|max {aux['u_max']:.3e}, |b|max {aux['b_max']:.3e}", flush=True)
        check(aux["evo_iters"] < model.evo_opts["itmax"], f"step {i + 1}: CG hit its cap")
        check(aux["inv_iters"] < model.inv_opts["itmax"], f"step {i + 1}: FGMRES hit its cap")
    for f in ("u", "p", "b"):
        check(bool(torch.isfinite(getattr(state, f)).all()), f"slice: non-finite {f}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] 10 steps in {t_steps:.3f} s = {10 / t_steps:.3f} steps/s; "
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches} = per step "
          f"{ {k: v / 10 for k, v in launches.items() if v} }; plain calls {plain} "
          f"({name_limit})", flush=True)
    print(f"[slice] launches per step by mode and local size "
          f"{ {k: v / 10 for k, v in K.shape_launches.items() if v} }", flush=True)
    check(all(launches[k] > 0 for k in STEP_COUNTERS),
          f"a kernel of the path never launched: {launches}")
    check(all(n == 0 for n in plain.values()), f"a plain version ran on the card: {plain}")

    for r in results.values():
        r["launches"] = launches[r["counter"]]

    # 6. the measurement tools, 7. the trace
    tool_launches = phase_tools(model, K, name_limit)
    for r in probes.values():
        r["launches"] = tool_launches[r["counter"]]
    state = phase_trace(model, state, name_limit)
    del model, state
    torch.cuda.empty_cache()

    # 5. f32 golden on the card
    t0 = time.perf_counter()
    ref = np.load(ROOT / "tests" / "data" / "bowl_mixing_2d.npz")
    golden = mixing_setup(npg.generators.bowl2D(0.1, 0.5), "cuda", torch.float32,
                          t_stop=2 * float(ref["t"]))
    n_steps = round(float(ref["t"]) / golden.ts.dt)
    st = golden.run(golden.rest_state(), n_info=0, max_steps=n_steps)
    fe = golden.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref_b = bs.from_original_order(ref["b"])
    ref_u = np.stack([us.from_original_order(ref["u"].reshape(-1, 3)[:, k])
                      for k in range(3)], axis=1)
    b = st.b.double().cpu().numpy()
    u = st.u.double().cpu().numpy()
    eb = rel_l2(fe, b, ref_b, fe.cd_b, fe.tab_b.phi)
    eu = rel_l2(fe, u, ref_u, fe.cd_u, fe.tab_u.phi)
    print(f"[golden] bowl2D h=0.1, {st.step} f32 BDF2 steps to t = {float(st.t):.7f} "
          f"(golden t = {float(ref['t']):.7f}) on the card in {time.perf_counter() - t0:.2f} s: "
          f"FE rel-L2 b = {eb:.3e}, u = {eu:.3e} (bar 1e-3)", flush=True)
    check(st.step == n_steps and abs(float(st.t) - float(ref["t"])) < 1e-5,
          "golden run stopped at another time")
    check(eb < 1e-3 and eu < 1e-3, "golden run disagrees with the golden file")
    for case in kernel_bench.kernel_cases(golden):  # 3c on P2-P1 triangles
        check_case(golden, K, case, case["entry"] + ("" if case["mode"] is None
                                                     else f"[{case['mode']}]"), "edges 2D")
    phase_edges(golden, K, "edges 2D")
    del golden, st
    torch.cuda.empty_cache()

    # 8. full physics
    phase_northstar_full(K, name_limit)
    torch.cuda.empty_cache()
    phase_production(K, name_limit)

    check("jax" not in sys.modules, "JAX was imported")
    kernels = [
        {"name": r["name"], "route": "cuda", "source": SOURCES[r["entry"]],
         "replaces": REPLACES[r["entry"]], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "device_ms": r["device_ms"], "library_device_ms": r["library_device_ms"]}
        for r in (*results.values(), *probes.values())]
    emit_tail(kernels, name_limit, kind, torch.cuda.device_count())


if __name__ == "__main__":
    main()
