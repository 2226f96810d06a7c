#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (nupgcm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failed check raises, and the script exits non-zero):

  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA kernels from csrc/ (the element matvec,
     the assembled block matvec, the streaming probes).
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
     device time (profiler busy time over 20 calls, and CUDA events
     around a CUDA-graph replay of 20 calls), host µs per call
     (1,000 calls before the synchronise) and the bound.
     The assembled block cases (vblock_matvec, ops/assembled.py): the
     iterative coarse level's P1-P1 saddle "full_pp" and its pressure
     coupling "up", its P1 vector velocity block and viscous smoother
     "uu" (3x3 blocks; the two-grid's element coarse level in 9c), and
     the P2-P1 pressure coupling "up" (P2 nodes x vertices) are held
     against their plain version at the same bars, with a second
     application bitwise equal to the first (the kernel has no
     atomics), and timed with a cold L2 beside K1 on the same
     operator's element tensors and the CSR call
     (kernel_bench.measure_assembled).
  3c. edge cases: every phase-3 case with the cells in a shuffled order
     (the widest block dof lists) and with blocks of 12 or 20 cells (a
     ragged last block), against the plain versions at the phase-3
     bars; the assembled cases on the shuffled cells (their pattern
     rebuilt from the shuffled dof tables); after phase 5 the same cases
     of the 2D bowl2D model (P2-P1 triangles: the assembled P2-P1
     coupling on [6,3]), and of bowl2D on the iterative coarse level
     (coarse_dense_max lowered: the assembled coarse cases on P1
     triangles, [3,3]).
  4. slice: PGModel on bowl3D(0.08, 0.5, nz=9) in f32 (the bench.py
     mixing configuration): set_b, invert, 10 BDF2 steps.  Every state
     is finite, every solve stays under its iteration cap, every kernel
     of the path launched and no plain version ran; the coarse level
     and the P2-P1 coupling went through the assembled block kernel
     ("full_pp", "up" and "uu") and K1 launched no P1-P1 "full_pp" or
     "up", no P1 vector "uu" and no P2-P1 "up" (check_path).
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
     out/trace/); the device-busy share, the launches whose device
     event the trace lacks (utils.timing.lost_events), and the top
     kernels by device time.
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
  9. the rest of the single-device package:
     9a. sphere at full width: sphere_mesh(8) written with write_msh to
         out/ and read back with read_msh; the sphere example's model
         (eps = 0.1, dt = 2e-3, f = z, no-slip wall, b = 0 at the
         surface, the equatorial b0) in f64 with the solves' absolute
         tolerances at 0 (with the default 1e-6 the steps' residuals
         start below them and no step iterates; f32 cannot resolve a
         1e-6 cut of them): set_b, invert, 10 BDF2 steps, each of
         which must iterate in both solves (112,724 inversion DoF, the
         iterative saddle coarse with the aggregate level); DoF,
         branch, iterations, steps/s, peak memory.
     9b. sphere golden: sphere_mesh(4) in tests/test_sphere.py's
         configuration, 10 f32 BDF2 steps against
         tests/data/sphere_n4_10.npz (JAX, CPU, f64, the same run;
         FE-integral relative L2, a squared-norm ratio, below 1e-9 for
         u and b).
     9c. the u-block two-grid (saddle_coarse=False, twogrid=True), f32:
         on the slice mesh bowl3D(0.08, 0.5, nz=9) the element coarse
         branch with inner CG (3 n_vertices > coarse_dense_max), invert
         + 5 steps, the P1 vector block on assembled blocks
         (vblock_uu[4,4]) launched and K1's (saddle_uu[4,0]) not; on
         bowl3D(0.25, 0.5, nz=4) the dense Cholesky branch, invert + 3
         steps.
     9d. channel and analysis: the channel_spinup example's model at its
         h = 0.06 (21,219 DoF), 50 f32 BDF2 steps; save_vtk to out/,
         overturning_streamfunction on Grid3.from_mesh(mesh, 32, 64,
         32) and cfl_map, every output finite; then tools.eigen's
         evolution_spectrum and preconditioned_inversion_spectrum (k =
         6) on the same mesh in f64, with their matvec counts.
     Each model (9a, both 9c branches, 9d): before its run, every kernel
     case of its path (each mode and local size, the two-grid's P1
     vector block and the channel's periodic dof tables included) on
     its own tensors against the plain version at the phase-3 bars.
     Each run: every state finite, every solve under its cap, every
     kernel of its path launched (counts set to 0 just before it, read
     just after; the invert of 9a and 9c read on its own), no plain
     version ran.

  10. domain decomposition (nupgcm_tpu_torch.parallel.dd) over a NCCL
     process group of world size 1 holding 4 local shards (NCCL's
     all_reduce on the path; NCCL allows one rank per card):
     10a. bowl3D(0.16, 0.5, nz=5) in f64 at tests/test_parallel.py's
          tight tolerances, from set_b + invert: one DDModel(model, 4)
          step against the single-device step on the card, max|du| and
          max|db| below 1e-12 of max|u| and max|b| (both printed, and
          the step must move b), FGMRES and CG counts within 1; the
          halo depth K of each space.
     10b. the slice bowl3D(0.08, 0.5, nz=9) (103,862 DoF) in f32 with
          the mixing configuration of phase 4 (iterative saddle coarse +
          aggregate level), S = 4: every shard's K1/K2 cases on its own
          extended tables against the plain versions at the phase-3
          bars; then set_b + invert (single device) and 10 DD steps
          with the counts set to 0 just before: every state finite,
          every solve under its cap, every K1/K2 counter launched, no
          plain call, FGMRES and CG counts within 1 of the
          single-device run's from the same state in every step;
          steps/s, the host share of the shifts and reductions, peak
          memory, and the final state's FE relative L2 distance to the
          single-device run (bar 1e-9; it reads ~1e-13).
     10c. the multi-process entry point, tools/multihost_dryrun: its
          run() over the one-rank NCCL group with 4 local shards
          against run() with no process group (norms, max|u|, max|b|
          within 1e-11 relative, FGMRES counts within 1); then, only on
          a machine with 4 or more cards, 4 spawned processes of
          ``python -m nupgcm_tpu_torch.tools.multihost_dryrun
          --local-shards 1`` (4 NCCL ranks of one shard, one card
          each): every rank's norms equal, and within 1e-11 relative of
          the one-rank run.  A one-card machine prints that the
          4-rank run was not made.

  11. the 0.87M-DoF bowl and the reference-interop checks:
     11a. tools/measure_l2's mode "base" on bowl3D(0.033, 0.5, nz=12)
          (36,096 vertices, 198,864 tets, 0.87M inversion DoF) in f32
          with the solver defaults (the aggregate level on): build
          (mesh, FEData, operators and the aggregate level apart, the
          host aggregation of its vertices within it),
          invert twice, two blocks of 5 steps from the set_b state, the
          second timed.  Vertices, tets, DoF, aggregates, build split,
          invert s and FGMRES count, every step's CG and FGMRES counts
          and residuals, steps/s, peak memory and launches per step by
          mode and local size.  No solve at its cap, finite residuals
          and max|b|, every kernel of the path launched (the assembled
          block kernel on the coarse level and the P2-P1 coupling, as
          phase 4b checks), no plain call.
     11b. retune(saddle_coarse_inner=0) on the same model (mode "k0"),
          5 steps, the same prints and checks; where 11a already ran at
          k = 0 (the default with the aggregate level and the Chebyshev
          smoother), its counts must be 11a's, each within 1.  Then the device-busy
          share of 3 profiled steps after set_b + invert, from a trace
          that lost no device event of the steps (kernel_bench.busy_share:
          a pad of spin kernels opens the trace; up to 5 tries, "not
          measured" otherwise), beside the wall of 3 unprofiled steps.
     11c. every K1/K2 and assembled block case of that model against its
          plain version at the phase-3 bars, timed as phase 3; every case
          reads a device time at or above its bound.
     11d. on the slice model: FEData.plan_inv assembles elem_inversion
          (computed afresh from the model's tables) into a COOMatrix on
          the card, and its SpMV matches K1 "full" on the unmasked
          saddle operator; FEData.plan_b assembles the evolution matrix
          against K2 (seeded x; max|dy| below 2e-6 of max|y|).  Then
          10 profiler traces of 20 K1 full calls
          (tools/trace_check.compare): the events each lost, beside a
          CUDA-graph replay timed by CUDA events; every profiler reading
          the acceptance rules let through (each complete trace, and
          kernel_bench.device_ms where it reads a time) must lie within
          0.85 to 1.1 times the replay's.
     11e. with TF32 switched on process-wide
          (torch.set_float32_matmul_precision("high"), allow_tf32), the
          phase-5 golden run again with the model's default
          matmul_precision="float32": phase 5's bar, and phase 5's
          states within 1e-5 of max|u| and max|b| (ten times the
          solves' rtol: two float32 runs differ by the atomics' order
          alone); then once with
          matmul_precision=None, its distance printed without a bar.
          The flags the model found are in force after each run, and the
          script's own are restored at the end.

  12. the coarse saddle matrices, assembled and inverted in float64 on
     the card (``PGModel._saddle_coarse_matrix`` / ``_aggregate_matrix``,
     ``_coarse_inverse``):
     12a. 8a's dense coarse level (9,340^2, the f64 model, run at the
          end of 8a);
     12b. 11a's aggregate level (12,048^2, run after 11c).
     Each matrix is built and inverted twice in the same process: the
     seconds of each, ||A X - I||_inf on the card, and the two builds'
     differences (the scatter's atomics add in another order each
     time).  Bars, from the backward stability of LU with partial
     pivoting (the residual and the forward error of a computed inverse
     are of order n u kappa, u = 2^-53, kappa = ||A||_inf ||X||_inf):
     ||A X - I||_inf <= n u ||A||_inf ||X||_inf; the second build's
     matrix within 1e-12 of max|A| of the first, and its inverse within
     n u kappa of max|X|; for 12a also the largest difference between the
     card's inverse and np.linalg.inv of the same matrix on the host,
     within n u kappa of max|X|.  On an NVIDIA H100 80GB HBM3 (700 W)
     the residuals read 2e-5 to 5e-5 of their bar, the host difference
     2e-7 of its, and the rebuilt matrices differed by 3e-17 to 8e-17 of
     max|A|: the bars leave room for other matrices' growth factors,
     while an inverse factorised in float32 (residual about u_f32 kappa)
     would exceed them some 5e4 times.

Every kernel case of phases 3, 3b, 8b and 11c reads two
device times: the profiler's busy time (kernel_bench.device_ms: the
median of three traces that held every call, or None when none did,
which happens late in a long process; readings that spread are printed
at the end) and a CUDA-graph replay of 20 calls timed by CUDA events
(kernel_bench.graph_ms, which needs no profiler and is always read).
Both must be at or above the bound, and the busy time at most 1.1
times the replay's.  One phase runs alone from a script that loads this file
with importlib and calls its function (for example phase_dd after
build.load()).

Phases 3 and 8b time each kernel case beside one library call that
computes the same function: cuSPARSE through torch.sparse.mm on the
operator assembled to CSR here (never in the port).  Each kernel's
bound is the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its multiply-adds over 67 TFLOP/s
(H100 SXM f32 without tensor cores), the CSR call's the same with
its matrix's values and indices in place of the element tensors; a
device time below its bound fails the run (it can only be a fault of
the measurement).  Phases 4
and 8 print the launches per mode and local size
(kernels.shape_launches).

Phases run in the order 1, 2, 4a (build the slice), 3, 3c, 3b, 4b
(step it), 6, 7, 5 (with the 2D edge cases), 8a with 12a, 8b, 9a-9d, 10a-10c,
11a-11c, 12b, 11d-11e.
The last three lines are the card's name and power limit, a JSON object
{"kernels": [...]} (each entry's "launches" come from the path named in
its "path": 4b's slice steps, 6's tools for the probes, or 10b's DD
steps for K1's "full_pp" and "up", which only DD runs now; an assembled
entry counts its own pattern's launches, e.g. vblock_up[10,4] for the
P2-P1 coupling against vblock_up[4,4] for the coarse level's; K1/K2
and assembled entries also carry "dd_launches", their launches in 10b's
DD steps, and "bowl_launches", in 11a's run), and {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import datetime
import json
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
REPLACES = {"saddle_matvec": "nupgcm_tpu/ops/window.py:769",
            "vblock_matvec": "nupgcm_tpu/ops/window.py:769",
            "scalar_matvec": "nupgcm_tpu/ops/window.py:865",
            "saddle_matvec[pinned]": "tools/profile_matvec.py:203",
            "stream_saddle": "tools/profile_matvec.py:174",
            "stream_probe": "tools/profile_stream.py:75"}
SOURCES = {"saddle_matvec": "nupgcm_tpu_torch/csrc/element_matvec.cu",
           "vblock_matvec": "nupgcm_tpu_torch/csrc/vertex_block_matvec.cu",
           "scalar_matvec": "nupgcm_tpu_torch/csrc/element_matvec.cu",
           "saddle_matvec[pinned]": "nupgcm_tpu_torch/csrc/element_matvec.cu",
           "stream_saddle": "nupgcm_tpu_torch/csrc/stream_probe.cu",
           "stream_probe": "nupgcm_tpu_torch/csrc/stream_probe.cu"}
BARS = {"float32": 2e-6, "float64": 1e-12}
RESUME_BAR = 1e-4          # phase 8a (f64), relative to max|u| and max|b|
# the single-device step: the iterative coarse level's saddle and coupling,
# the coarse P1 vector velocity blocks and the P2-P1 coupling through the
# assembled block kernel; DD keeps K1 for them on its shards
STEP_COUNTERS = ("saddle_full", "saddle_uu", "scalar", "vblock_full_pp", "vblock_up",
                 "vblock_uu")
INVERT_COUNTERS = tuple(k for k in STEP_COUNTERS if k != "scalar")
DD_COUNTERS = ("saddle_full", "saddle_full_pp", "saddle_uu", "saddle_up", "scalar")
# K1's shapes of the operators the single device applies from assembled
# blocks (with every "saddle_full_pp" shape): the P1-P1 and P2-P1 "up",
# the P1 vector "uu", in tets and triangles
ASSEMBLED_K1 = ("saddle_up[4,4]", "saddle_up[3,3]", "saddle_up[10,4]", "saddle_up[6,3]",
                "saddle_uu[4,0]", "saddle_uu[3,0]")
P2P1_COUPLING = ("vblock_up[10,4]", "vblock_up[6,3]")  # the assembled P2-P1 "up"
# 9b, FE rel-L2 (a squared-norm ratio, so about 3e-5 relative) of f32
# against the f64 golden; f32 reads about 1e-14 (u) and 1e-16 (b)
SPHERE_BAR = 1e-9
STREAM_SHAPES = ((3, 128, False), (1, 512, True))  # K4 cases of profile_stream
DD_SHARDS = 4
# 10a (f64), max|du|, max|db| relative to max|u|, max|b|: reads ~1e-15
DD_PARITY_BAR = 1e-12
# 10b (f32), FE rel-L2 (a squared-norm ratio) to the single-device run;
# the solves stop at the same iterations, and it reads 3e-14-6e-14
DD_DISTANCE_BAR = 1e-9
# 10c (f64), norms relative to the one-rank run: reads ~2e-16 without a
# process group (K1/K2's atomics alone)
DD_DRYRUN_BAR = 1e-11
DRYRUN_STEPS = 3
DRYRUN_KEYS = ("u2", "p2", "b2", "u_max", "b_max")  # of multihost_dryrun.run
BOWL = (0.033, 12)  # 11: bowl3D(h, 0.5, nz), 0.87M inversion DoF
BOWL_STEPS = 5
# 11d (f32), max|y_assembled - y_kernel| relative to max|y|
ASSEMBLED_BAR = 2e-6
# 11d, device_ms against a CUDA-graph replay of the same calls: within
# these times the replay's.  The replay also counts the gaps between
# kernels (device_ms read 0.937-0.974 of it on an NVIDIA H100 80GB
# HBM3); a trace that lost 3 of its 20 calls reads below 0.85
GRAPH_BARS = (0.85, 1.1)
# 11e (f32), the golden run under a TF32 process against phase 5's,
# max|du|, max|db| relative to max|u|, max|b|: ten times the solves'
# rtol, since two float32 runs that sum K1/K2's atomics in another
# order stop their solves at rtol 1e-6 apart (5.6e-7 to 7.5e-7 on an
# NVIDIA H100 80GB HBM3); TF32 products move the state by 4e-3 to 5e-3
PRECISION_BAR = 1e-5
# 12: a coarse matrix's second build, against the first, relative to max|A|
COARSE_REBUILD_BAR = 1e-12


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
    log = lambda *a: print(*a, f"({card_name})", flush=True)
    for case in kb.kernel_cases(model, Kv_e) + kb.assembled_cases(model):
        name = case_name(case)
        err = check_case(model, K, case, name, tag)
        measure = kb.measure_assembled if case["entry"] == "vblock_matvec" else kb.measure_case
        rec = measure(model, K, case, log=log, tag=tag)
        check(rec["lib_rel_err"] <= BARS["float32"],
              f"{name} {case['label']}: the CSR yardstick disagrees with plain")
        check_device(rec, f"{name} {case['label']}")
        check_bound(rec["library_device_ms"], rec["library_bound_ms"],
                    f"{name} {case['label']} library_device_ms")
        top = results.setdefault(name, dict(rec, name=name, max_abs_err=0.0, cases=[],
                                            counter=counter_of(case)))
        top["max_abs_err"] = max(top["max_abs_err"], err)
        top["cases"].append(rec)
    return results


def case_name(case):
    return case.get("name") or (case["entry"]
                                + ("" if case["mode"] is None else f"[{case['mode']}]"))


def counter_of(case):
    """The ``counts`` key of a kernel case: its ``kernels.launches`` key,
    or for an assembled case its pattern's ``shape_launches`` key (the
    P2-P1 coupling's "vblock_up[10,4]", the coarse level's
    "vblock_up[4,4]")."""
    if case["mode"] is None:
        return "scalar"
    if case["entry"] == "vblock_matvec":
        return "vblock_{}[{},{}]".format(case["mode"], *case["pattern"].sizes)
    return f"saddle_{case['mode']}"


def counts(K):
    """The launches since the last reset, by kernel and mode
    (``kernels.launches``) and by mode and local sizes
    (``kernels.shape_launches``), in one dict."""
    return {**K.launches, **K.shape_launches}


def check_device(rec, what):
    """A kernel case's two device times (``rec`` of kernel_bench): the
    CUDA-graph replay, always read, and the profiler's busy time, where
    a trace held every call, both at or above the bound; the busy time
    at most GRAPH_BARS[1] times the replay's, which also counts the
    gaps between kernels."""
    check_bound(rec["graph_ms"], rec["bound_ms"], f"{what} graph_ms", required=True)
    check_bound(rec["device_ms"], rec["bound_ms"], f"{what} device_ms")
    check(rec["device_ms"] is None or rec["device_ms"] <= GRAPH_BARS[1] * rec["graph_ms"],
          f"{what}: device_ms {rec['device_ms']} above {GRAPH_BARS[1]} times the CUDA-graph "
          f"replay's {rec['graph_ms']:.4f} ms")


def check_bound(device_ms, bound_ms, what, required=False):
    """No device time can fall below the bound: a reading that does is a
    fault of the measurement (kernel_bench.device_ms keeps no trace that
    missed calls, so none should reach here).  ``required``: a device
    time that was not measured (None) fails too."""
    if device_ms is None:
        check(not required, f"{what}: not measured")
        return
    if device_ms < bound_ms:
        raise RuntimeError(f"{what}: {device_ms:.4f} ms on the device, below the bound "
                           f"{bound_ms:.4f} ms")


def check_case(model, K, case, name, tag):
    """A case's kernel against its plain version in f32 and f64 at the
    BARS of max|y|, and for a vertex-block case (no atomics) a second
    application bitwise equal to the first; returns the f32
    max|y - y_plain|."""
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
        if case["entry"] == "vblock_matvec":
            y2 = kfn()
            torch.cuda.synchronize()
            check(torch.equal(y, y2), f"{name} {case['label']} {dtype}: a second application "
                  "differs from the first")
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
    for case in kb.assembled_cases(model):  # no cell blocks: the shuffled order alone
        c = dict(case, label=f"{case['label']}, shuffled", perm=perm)
        check_case(model, K, c, case_name(case), tag)
    for case in kb.kernel_cases(model):
        name = case_name(case)
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
        rec["graph_ms"] = kb.graph_ms(kfn)
        rec["bound_ms"], rec["bound_by"] = kb.bound(*work)
        rec["library_ms"] = rec["library_device_ms"] = None
        dev = "not measured" if rec["device_ms"] is None else f"{rec['device_ms']:.4f} ms"
        print(f"[probes] {name:22s} f32: {rec['ms']:.4f} ms kernel (device "
              f"{dev}, graph replay {rec['graph_ms']:.4f} ms, host {rec['host_us']:.1f} us), "
              f"{rec['plain_ms']:.4f} ms plain, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}) ({card_name})", flush=True)
        check_device(rec, name)
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
    summ, rec = timing.trace_summary(path), timing.lost_events(path)
    busy = summ["busy_us"] / 1e6
    check(busy > 0, "trace: the profiler saw no device work")
    print(f"[trace] 5 steps: device busy {busy * 1e3:.3f} ms of {wall_prof * 1e3:.3f} ms "
          f"profiled wall ({100 * busy / wall_prof:.1f}%), of {wall * 1e3:.3f} ms unprofiled "
          f"wall ({100 * busy / wall:.1f}%); {len(rec['lost'])} of {rec['launches']} launches "
          f"without a device event; trace {pathlib.Path(path).relative_to(ROOT)} "
          f"({card_name})", flush=True)
    total = sum(us for _, us in summ["by_name"].values())
    for name, (calls, us) in list(summ["by_name"].items())[:10]:
        print(f"[trace] {us / 1e3:9.3f} ms {100 * us / total:5.1f}% {calls:6d} calls  "
              f"{name[:90]}", flush=True)
    return state


def check_kernels(model, K, tag):
    """Every kernel case of ``model`` (each mode and local size its path
    launches, on its own tensors) against its plain version in f32 and
    f64 at BARS, without timing."""
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    for case in kb.kernel_cases(model) + kb.assembled_cases(model):
        check_case(model, K, case, case_name(case), tag)


def check_path(model, K, tag, counters=STEP_COUNTERS):
    """The counts since the last reset: every kernel of ``counters`` on
    the model's path launched (the iterative coarse level's where the
    model has it, the P1 vector blocks' where it has a coarse velocity
    level, the P2-P1 coupling's where the preconditioner is
    block-triangular) and no plain version ran; on the single-device
    path (``counters`` with the assembled block kernel) the P2-P1
    coupling launched from its assembled blocks, and K1 ran none of the
    operators the model applies from them (ASSEMBLED_K1).  Returns the
    launches (``counts``)."""
    launches, plain = counts(K), dict(K.plain_calls)
    ops = model.ops
    needed = {"saddle_full_pp": "sc_uu" in ops, "vblock_full_pp": "sc_uu" in ops,
              "vblock_uu": "sc_uu" in ops or "coarse_e" in ops,
              "vblock_up": "sc_uu" in ops or model.triangular}
    missing = [k for k in counters if not launches[k] and needed.get(k, True)]
    check(not missing, f"{tag}: {missing} never launched")
    check(all(v == 0 for v in plain.values()), f"{tag}: a plain version ran on the card: {plain}")
    if "vblock_up" in counters:
        check(not model.triangular or any(launches.get(k) for k in P2P1_COUPLING),
              f"{tag}: the P2-P1 coupling never launched from its assembled blocks")
        k1 = {k: v for k, v in K.shape_launches.items()
              if v and (k.startswith("saddle_full_pp") or k in ASSEMBLED_K1)}
        check(not k1, f"{tag}: K1 ran an operator the model applies from assembled blocks: "
              f"{k1}")
    return launches


def run_checked(model, state, K, tag, card_name, inv_capped_ok=False, **run_kw):
    """``model.run(state, **run_kw)`` with the kernel counts set to 0
    just before and read just after.  Checks every step's CG solve
    against its cap (and FGMRES's, unless ``inv_capped_ok``), a finite
    final state, that every kernel of the path launched and that no
    plain version ran.  Returns the state and the steps' aux records."""
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
    check_path(model, K, tag)
    return state, auxs


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
          f"{build_s:.2f} s ({build_parts(model)}) ({card_name})", flush=True)
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

    state, _ = run_checked(
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
    phase_coarse(model, "12a", card_name, host=True)


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
          f"{build_s:.2f} s ({build_parts(model)}), peak device memory "
          f"{build_peak / 2**20:.1f} MiB ({card_name})",
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
    state, _ = run_checked(model, state, K, "8b", card_name, inv_capped_ok=True,
                           n_info=0, max_steps=26, n_precond_refresh=25)
    print(f"[8b] peak device memory over the run {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB; |u|max {float(state.u.abs().max()):.3e}, t {float(state.t):.4e}, "
          f"dt {float(state.dt):.4e} ({card_name})", flush=True)
    check(state.step == 26, "8b: the run stopped early")
    return results


def phase_sphere(K, card_name):
    """9a: the sphere example's model on sphere_mesh(8), through
    write_msh and read_msh, in f64 with the solves' absolute tolerances
    at 0; 9b: sphere_mesh(4) against the JAX golden in f32."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.examples import sphere
    from nupgcm_tpu_torch.tools.northstar import rel_l2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = npg.generators.sphere_mesh(8)
    path = ROOT / "out" / "sphere_8.msh"
    path.parent.mkdir(exist_ok=True)
    npg.write_msh(gen, str(path))
    mesh = npg.read_msh(str(path))
    check(mesh.n_cells == gen.n_cells and np.allclose(mesh.coords, gen.coords, atol=1e-12)
          and sorted(mesh.tagged) == sorted(gen.tagged), "9a: the .msh round trip changed the mesh")
    # At this width the steps' starting residuals lie below the example's
    # absolute tolerances (1e-6): with them no step takes an iteration
    # and b stays put.  With atol = 0 every solve cuts its residual by
    # rtol (1e-6), which f32 cannot resolve (the per-step change of b is
    # near its rounding), so 9a runs in f64.
    model = sphere.build_model(mesh, eps=0.1, dt=2e-3, device="cuda", dtype=torch.float64)
    model.retune(evo_atol=0.0, inv_atol=0.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fe = model.fe
    print(f"[9a] sphere_mesh(8) via write_msh/read_msh ({path.relative_to(ROOT)}): "
          f"{mesh.n_vertices} vertices, {mesh.n_cells} cells, {fe.n_inv} inversion DoF; "
          f"preconditioner {model.preconditioner_branch}, inner_method {model.inner_method}; "
          f"f64, atol 0; build {build_s:.2f} s (mesh and its .msh round trip included; "
          f"{build_parts(model)}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card_name})", flush=True)
    check(fe.n_inv == 112724, f"9a: {fe.n_inv} inversion DoF, not 112,724")
    check(model.preconditioner_branch == "iterative saddle coarse + L2 aggregate level",
          "9a: not the iterative saddle coarse + aggregate branch")
    check_kernels(model, K, "9a kernels")
    torch.cuda.synchronize()
    K.reset_counts()
    t0 = time.perf_counter()
    state = model.set_b(model.rest_state(), sphere.b0)
    u, p, stats = model._invert_pure(model.ops, state.b, torch.zeros_like(model.ops["s"]))
    state = npg.State(u=u, p=p, b=state.b, u_prev=state.u_prev, b_prev=state.b_prev,
                      t=state.t, dt=state.dt, step=state.step)
    torch.cuda.synchronize()
    inv_s = time.perf_counter() - t0
    launches = check_path(model, K, "9a invert", INVERT_COUNTERS)
    check(bool(torch.isfinite(state.u).all()), "9a: invert gave a non-finite flow")
    check(stats.converged, "9a: the invert's FGMRES did not converge")
    print(f"[9a] set_b + invert {inv_s:.3f} s: FGMRES {stats.iterations} iterations "
          f"(residual {stats.residual:.2e}), |u|max {float(state.u.abs().max()):.3e}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    b_inv = state.b.clone()
    state, auxs = run_checked(model, state, K, "9a", card_name, n_info=0, max_steps=10)
    check(state.step == 10, "9a: the run stopped early")
    check(all(a["evo_iters"] > 0 and a["inv_iters"] > 0 for a in auxs),
          "9a: a step's solve took no iteration")
    print(f"[9a] max|b_10 - b_0| = {float((state.b - b_inv).abs().max()):.3e}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card_name})",
          flush=True)
    del model, state
    torch.cuda.empty_cache()

    # 9b. the golden of tests/test_sphere.py's configuration
    ref = np.load(ROOT / "tests" / "data" / "sphere_n4_10.npz")
    model = sphere.build_model(npg.generators.sphere_mesh(4), eps=0.2, dt=1e-3,
                               device="cuda", dtype=torch.float32)
    state, _ = run_checked(model, model.set_b(model.rest_state(), sphere.blob), K, "9b",
                           card_name, n_info=0, max_steps=10)
    fe = model.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref_u = np.stack([us.from_original_order(ref["u"][:, c]) for c in range(3)], axis=1)
    eu = rel_l2(fe, state.u.double().cpu().numpy(), ref_u, fe.cd_u, fe.tab_u.phi)
    eb = rel_l2(fe, state.b.double().cpu().numpy(), bs.from_original_order(ref["b"]),
                fe.cd_b, fe.tab_b.phi)
    print(f"[9b] sphere_mesh(4), {fe.n_inv} DoF, {state.step} f32 steps to t = "
          f"{float(state.t):.6f} (golden {float(ref['t']):.6f}): FE rel-L2 u = {eu:.3e}, "
          f"b = {eb:.3e} (bar {SPHERE_BAR:.0e}) ({card_name})", flush=True)
    check(state.step == int(ref["steps"]) == 10, "9b: the run stopped at another step")
    check(eu < SPHERE_BAR and eb < SPHERE_BAR, "9b: the state disagrees with the golden file")


def phase_twogrid(K, card_name):
    """9c: the u-block two-grid on both coarse branches."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup

    for (h, nz), n_steps, branch in (((0.08, 9), 5, "element coarse + CG"),
                                     ((0.25, 4), 3, "dense coarse")):
        tag = f"9c {branch.split()[0]}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = mixing_setup(npg.generators.bowl3D(h, 0.5, nz=nz), "cuda", torch.float32,
                             saddle_coarse=False, twogrid=True)
        torch.cuda.synchronize()
        fe = model.fe
        print(f"[{tag}] bowl3D({h}, 0.5, nz={nz}): {fe.mesh.n_vertices} vertices, "
              f"{fe.n_inv} inversion DoF; preconditioner {model.preconditioner_branch}, "
              f"inner_iters {model.inner_iters}; build {time.perf_counter() - t0:.2f} s "
              f"({card_name})", flush=True)
        check(model.preconditioner_branch == f"u-block two-grid, {branch}",
              f"{tag}: took {model.preconditioner_branch}")
        check_kernels(model, K, f"{tag} kernels")
        torch.cuda.synchronize()
        K.reset_counts()
        state = model.invert(model.set_b(model.rest_state(), initial_b))
        torch.cuda.synchronize()
        check_path(model, K, f"{tag} invert", INVERT_COUNTERS)
        check(bool(torch.isfinite(state.u).all()), f"{tag}: invert gave a non-finite flow")
        state, _ = run_checked(model, state, K, tag, card_name, n_info=0, max_steps=n_steps)
        check(state.step == n_steps, f"{tag}: the run stopped early")
        p1_uu = K.shape_launches.get("vblock_uu[4,4]", 0)
        print(f"[{tag}] P1 vector-block launches (vblock_uu[4,4]) {p1_uu}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
        check((p1_uu > 0) == (branch != "dense coarse"),
              f"{tag}: the P1 vector block launched {p1_uu} times")
        del model, state
        torch.cuda.empty_cache()


def phase_channel(K, card_name):
    """9d: the channel_spinup example's model, its VTU and streamfunction,
    cfl_map, then the eigen tools on the same mesh in f64."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.examples import channel_spinup
    from nupgcm_tpu_torch.io.vtk import save_vtk
    from nupgcm_tpu_torch.postprocess import Grid3, cfl_map, overturning_streamfunction
    from nupgcm_tpu_torch.tools import eigen

    mesh = npg.generators.channel3D(0.06)
    model = channel_spinup.build_model(mesh, 50, device="cuda", dtype=torch.float32)
    fe = model.fe
    print(f"[9d] channel3D(0.06): {mesh.n_vertices} vertices, {mesh.n_cells} cells, "
          f"{len(mesh.periodic_pairs)} periodic pairs, {fe.n_inv} inversion DoF; "
          f"preconditioner {model.preconditioner_branch} ({card_name})", flush=True)
    check(fe.n_inv == 21219, f"9d: {fe.n_inv} inversion DoF, not 21,219")
    check_kernels(model, K, "9d kernels")
    state, _ = run_checked(model, model.set_b(model.rest_state(), channel_spinup.b0), K, "9d",
                           card_name, n_info=0, max_steps=50)
    check(state.step == 50, "9d: the run stopped early")
    t0 = time.perf_counter()
    vtu = ROOT / "out" / "channel_final.vtu"
    vtu.parent.mkdir(exist_ok=True)
    save_vtk(model, state, str(vtu))
    text = vtu.read_text()
    check("nan" not in text and "inf" not in text, "9d: the VTU holds a non-finite value")
    psi, v_int, b_bar, _ = overturning_streamfunction(model, state,
                                                      Grid3.from_mesh(mesh, 32, 64, 32))
    cfl = cfl_map(model, state)
    inside = ~np.isnan(psi)
    check(inside.any() and np.isfinite(psi[inside]).all() and np.isfinite(cfl).all(),
          "9d: a non-finite streamfunction or CFL map")
    print(f"[9d] save_vtk ({vtu.stat().st_size / 2**20:.1f} MiB), overturning psi in "
          f"[{np.nanmin(psi):.3e}, {np.nanmax(psi):.3e}], cfl dt >= {cfl.min():.3e}: "
          f"{time.perf_counter() - t0:.2f} s on the host", flush=True)
    del model, state
    torch.cuda.empty_cache()

    model = channel_spinup.build_model(mesh, 50, device="cuda", dtype=torch.float64)
    for name in ("evolution_spectrum", "preconditioned_inversion_spectrum"):
        torch.cuda.synchronize()
        K.reset_counts()
        eigen.matvec_count = 0
        t0 = time.perf_counter()
        vals = getattr(eigen, name)(model, k=6)
        torch.cuda.synchronize()
        launches, plain = dict(K.launches), dict(K.plain_calls)
        print(f"[9d] {name} (f64): {eigen.matvec_count} matvecs in "
              f"{time.perf_counter() - t0:.2f} s; |lambda| {np.abs(vals).min():.4e} .. "
              f"{np.abs(vals).max():.4e}; launches { {k: v for k, v in launches.items() if v} }"
              f" ({card_name})", flush=True)
        check(len(vals) == 6 and np.isfinite(vals).all(), f"9d: {name} is not finite")
        check(launches["scalar"] > 0 and (name == "evolution_spectrum"
                                          or launches["saddle_full"] > 0),
              f"9d: {name} ran no kernel")
        check(all(v == 0 for v in plain.values()), f"9d: a plain version ran in {name}")


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def dd_cases(op, dtype):
    """(label, kernel fn, plain fn) of a DD shard operator in ``dtype``:
    its K1 mode (and "up" where it has a coupling block) or its K2
    application, the kernel over block tables of its own extended (or
    global coarse) dof tables."""
    import torch

    from nupgcm_tpu_torch.ops import kernels as K
    from nupgcm_tpu_torch.ops.element import ElementOperator, SaddleOperator

    conv = lambda t: None if t is None else t.to(dtype).contiguous()
    rng = np.random.default_rng(11)
    rand = lambda n: torch.as_tensor(rng.standard_normal(n), dtype=dtype, device="cuda")
    if isinstance(op, ElementOperator):
        o = op if op.Ae.dtype == dtype else ElementOperator(Ae=conv(op.Ae), cd=op.cd, n=op.n)
        x = rand(o.n)
        return [("scalar", lambda: o.matvec(x), lambda: K.scalar_matvec_plain(o.Ae, o.cd, x))]
    ref = op.uu
    o = op if ref.dtype == dtype else SaddleOperator(
        uu=conv(op.uu), up=conv(op.up), pu=conv(op.pu), pp=conv(op.pp), cd_u=op.cd_u,
        cd_p=op.cd_p, n_u_nodes=op.n_u_nodes, n_p=op.n_p)
    n3 = 3 * o.n_u_nodes
    x = rand(n3 + o.n_p)
    out = [(o.mode, lambda: o.matvec(x),
            lambda: K.saddle_matvec_plain(o.uu, o.up, o.pu, o.pp, o.cd_u, o.cd_p, x, o.mode,
                                          o.n_u_nodes))]
    if o.up is not None:
        xp = rand(o.n_p)
        out.append(("up", lambda: o.up_matvec(xp),
                    lambda: K.saddle_matvec_plain(None, o.up, None, None, o.cd_u, o.cd_p, xp,
                                                  "up", o.n_u_nodes)))
    return out


def check_dd_kernels(dd, tag):
    """Every shard's K1/K2 cases (each operator of the DD step, on the
    shard's own tables) against the plain version in f32 and f64 at
    BARS of max|y|; one line per operator and case, the worst shard."""
    import torch

    for name, ops in dd.shard_operators().items():
        worst = {}
        for dtype in (torch.float32, torch.float64):
            for j, op in enumerate(ops):
                for label, kfn, pfn in dd_cases(op, dtype):
                    y, y0 = kfn(), pfn()
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(y).all()), f"{tag} {name} shard {j}: non-finite")
                    rel = float((y - y0).abs().max() / y0.abs().max().clamp_min(1e-300))
                    key = (label, str(dtype)[6:])
                    worst[key] = max(worst.get(key, 0.0), rel)
                    check(rel <= BARS[str(dtype)[6:]],
                          f"{tag} {name} {label} shard {j} {dtype}: kernel disagrees with plain")
        print(f"[{tag}] {name:12s} " + ", ".join(
            f"{lab} {dt}: {v:.2e} max|y| (bar {BARS[dt]:.0e})" for (lab, dt), v in worst.items())
              + f" ({len(ops)} shards)", flush=True)


def phase_dd(K, card_name, slice_counts=None):
    """10: DDModel over a NCCL group of world size 1 with 4 local
    shards, then the multi-process entry point.  Returns 10b's
    launches."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        from nupgcm_tpu_torch.parallel.comm import ShardGroup

        group = ShardGroup(DD_SHARDS, dist.group.WORLD)
        check((group.world, group.L, group.backend) == (1, DD_SHARDS, "nccl"),
              "10: not one NCCL rank holding every shard")
        phase_dd_parity(group, card_name)
        launches = phase_dd_slice(K, group, card_name, slice_counts)
        one_rank = phase_dd_dryrun(card_name)
    finally:
        dist.destroy_process_group()
    phase_dd_ranks(one_rank, card_name)
    return launches


def phase_dd_parity(group, card_name):
    """10a: one f64 DD step against the single-device step."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.parallel.dd import DDModel
    from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup

    t0 = time.perf_counter()
    model = mixing_setup(npg.generators.bowl3D(0.16, 0.5, nz=5), "cuda", torch.float64,
                         t_stop=1.0, dt=1e-3, inv_atol=1e-10, inv_rtol=1e-10, evo_atol=1e-12,
                         evo_rtol=1e-12, inv_itmax=400)
    s0 = model.invert(model.set_b(model.rest_state(), initial_b))
    s1, aux1 = model.step(s0)
    dd = DDModel(model, DD_SHARDS, group)
    sv, aux2 = dd.step(dd.to_dd(s0))
    s2 = dd.from_dd(sv)
    u_max, b_max = float(s1.u.abs().max()), float(s1.b.abs().max())
    moved = float((s1.b - s0.b).abs().max())
    du = float((s1.u - s2.u).abs().max()) / u_max
    db = float((s1.b - s2.b).abs().max()) / b_max
    print(f"[10a] bowl3D(0.16, 0.5, nz=5), {model.fe.n_inv} DoF, f64, {DD_SHARDS} shards on one "
          f"NCCL rank, from set_b + invert: halo K (u, p, b) = ({dd.part_u.K}, {dd.part_p.K}, "
          f"{dd.part_b.K}); FGMRES {aux1['inv_iters']} (one device) / {aux2['inv_iters']} (DD), "
          f"CG {aux1['evo_iters']} / {aux2['evo_iters']}; max|u| {u_max:.3e}, max|b| "
          f"{b_max:.3e}, max|b1 - b0| {moved:.3e}; max|du| {du:.3e} max|u|, max|db| {db:.3e} "
          f"max|b| (bar {DD_PARITY_BAR:.0e}); {time.perf_counter() - t0:.2f} s ({card_name})",
          flush=True)
    check(u_max > 0 and moved > 1e-6 * b_max, "10a: the step left the state where it was")
    check(du < DD_PARITY_BAR and db < DD_PARITY_BAR, "10a: the DD step disagrees with one device")
    check(abs(aux1["inv_iters"] - aux2["inv_iters"]) <= 1, "10a: FGMRES counts differ by > 1")
    check(abs(aux1["evo_iters"] - aux2["evo_iters"]) <= 1, "10a: CG counts differ by > 1")


def phase_dd_slice(K, group, card_name, slice_counts):
    """10b: the slice over 4 shards: kernels vs plain on every shard's
    tables, then 10 DD steps against 10 single-device steps."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.parallel.dd import DDModel
    from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup
    from nupgcm_tpu_torch.tools.northstar import rel_l2

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = mixing_setup(npg.generators.bowl3D(0.08, 0.5, nz=9), "cuda", torch.float32)
    fe = model.fe
    check(fe.n_inv == 103862, f"10b: {fe.n_inv} inversion DoF, not 103,862")
    state0 = model.invert(model.set_b(model.rest_state(), initial_b))
    torch.cuda.synchronize()
    st, sd = state0, []
    for _ in range(10):
        st, aux = model.step(st)
        sd.append(aux)
    t0 = time.perf_counter()
    dd = DDModel(model, DD_SHARDS, group)
    torch.cuda.synchronize()
    print(f"[10b] slice, {fe.n_inv} DoF, f32, {model.preconditioner_branch}: DDModel over "
          f"{DD_SHARDS} shards built in {time.perf_counter() - t0:.2f} s; halo K (u, p, b) = "
          f"({dd.part_u.K}, {dd.part_p.K}, {dd.part_b.K}), chunks ({dd.part_u.chunk}, "
          f"{dd.part_p.chunk}, {dd.part_b.chunk}), {dd.nc_max} cells a shard at most",
          flush=True)
    check_dd_kernels(dd, "10b kernels")

    sv = dd.to_dd(state0)
    torch.cuda.synchronize()
    K.reset_counts()
    group.reset_stats()
    t0 = time.perf_counter()
    auxs = []
    for _ in range(10):
        sv, aux = dd.step(sv)
        auxs.append(aux)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(K.launches), dict(K.plain_calls)
    seconds, calls = dict(group.seconds), dict(group.calls)
    for i, (a, b) in enumerate(zip(auxs, sd)):
        check(a["evo_iters"] < model.evo_opts["itmax"], f"10b step {i + 1}: CG hit its cap")
        check(a["inv_iters"] < model.inv_opts["itmax"], f"10b step {i + 1}: FGMRES hit its cap")
        check(abs(int(a["evo_iters"]) - int(b["evo_iters"])) <= 1
              and abs(int(a["inv_iters"]) - int(b["inv_iters"])) <= 1,
              f"10b step {i + 1}: solver counts differ from one device's by > 1")
    for k in ("u", "p", "b", "u_prev", "b_prev"):
        check(bool(torch.isfinite(sv[k]).all()), f"10b: non-finite {k}")
    check_path(model, K, "10b", DD_COUNTERS)
    fmt = lambda rs, k: [int(a[k]) for a in rs]
    print(f"[10b] 10 DD steps in {wall:.3f} s = {10 / wall:.3f} steps/s; FGMRES per step "
          f"{fmt(auxs, 'inv_iters')} (one device from the same state {fmt(sd, 'inv_iters')}"
          f"{'' if slice_counts is None else f', phase 4b {slice_counts[1]}'}), CG "
          f"{fmt(auxs, 'evo_iters')} (one device {fmt(sd, 'evo_iters')}"
          f"{'' if slice_counts is None else f', phase 4b {slice_counts[0]}'}) ({card_name})",
          flush=True)
    print(f"[10b] host time in shifts {seconds['shift']:.3f} s ({calls['shift']} calls) and "
          f"reductions {seconds['reduce']:.3f} s ({calls['reduce']} calls): "
          f"{100 * (seconds['shift'] + seconds['reduce']) / wall:.1f}% of the steps' wall; "
          f"launches {launches} = per step { {k: v / 10 for k, v in launches.items() if v} }; "
          f"plain calls {plain}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({card_name})", flush=True)
    s_dd = dd.from_dd(sv)
    eu = rel_l2(fe, s_dd.u.double().cpu().numpy(), st.u.double().cpu().numpy(), fe.cd_u,
                fe.tab_u.phi)
    eb = rel_l2(fe, s_dd.b.double().cpu().numpy(), st.b.double().cpu().numpy(), fe.cd_b,
                fe.tab_b.phi)
    print(f"[10b] step 10 against the single-device run: FE rel-L2 u {eu:.3e}, b {eb:.3e} "
          f"(bar {DD_DISTANCE_BAR:.0e})", flush=True)
    check(eu < DD_DISTANCE_BAR and eb < DD_DISTANCE_BAR, "10b: DD drifted from one device")
    del model, dd, sv, st, state0
    torch.cuda.empty_cache()
    return launches


def phase_dd_dryrun(card_name):
    """10c, first half: the multi-process entry point's run() over the
    one-rank NCCL group (4 local shards) against run() with no process
    group.  Returns the NCCL run's output."""
    import torch.distributed as dist

    from nupgcm_tpu_torch.tools import multihost_dryrun

    t0 = time.perf_counter()
    nccl = multihost_dryrun.run(DRYRUN_STEPS, DD_SHARDS, "cuda", dist.group.WORLD)
    alone = multihost_dryrun.run(DRYRUN_STEPS, DD_SHARDS, "cuda")
    rel = dryrun_rel(nccl, alone)
    print(f"[10c] multihost_dryrun.run, {DRYRUN_STEPS} f64 steps over {DD_SHARDS} shards: "
          f"one NCCL rank {dryrun_fmt(nccl)}; no process group: relative differences {rel} "
          f"(bar {DD_DRYRUN_BAR:.0e}), FGMRES {alone['inv_iters']}; "
          f"{time.perf_counter() - t0:.2f} s ({card_name})", flush=True)
    check(nccl["n_processes"] == 1, "10c: the run was not on the one-rank group")
    check(all(v < DD_DRYRUN_BAR for v in rel.values()), "10c: the NCCL run disagrees")
    check(abs(nccl["inv_iters"] - alone["inv_iters"]) <= 1, "10c: FGMRES counts differ by > 1")
    return nccl


def dryrun_rel(a, b):
    return {k: abs(a[k] - b[k]) / abs(b[k]) for k in DRYRUN_KEYS}


def dryrun_fmt(out):
    return (f"{ {k: out[k] for k in DRYRUN_KEYS} }, FGMRES {out['inv_iters']}, halo K "
            f"{out['halo_K']}")


def phase_dd_ranks(one_rank, card_name):
    """10c, second half, on a machine with 4 or more cards: 4 processes
    of the multi-process entry point, one NCCL rank of one shard on each
    card, against the one-rank run."""
    import torch

    n = torch.cuda.device_count()
    if n < DD_SHARDS:
        print(f"[10c] 4 NCCL ranks not run: {n} card(s), and NCCL allows one rank a card",
              flush=True)
        return
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nupgcm_tpu_torch.tools.multihost_dryrun", "--device", "cuda",
         "--nproc", str(DD_SHARDS), "--pid", str(r), "--port", str(port),
         "--local-shards", "1", "--steps", str(DRYRUN_STEPS)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(DD_SHARDS)]
    try:
        results = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, results)):
        check(p.returncode == 0, f"10c rank {r} failed (rc {p.returncode}):\n{err[-3000:]}")
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in results]
    rel = dryrun_rel(got[0], one_rank)
    print(f"[10c] 4 NCCL ranks x 1 shard (4 cards): {dryrun_fmt(got[0])}; relative to one rank "
          f"{rel} (bar {DD_DRYRUN_BAR:.0e}); {time.perf_counter() - t0:.1f} s ({card_name})",
          flush=True)
    check([g["process_id"] for g in got] == list(range(DD_SHARDS)), "10c: ranks out of order")
    check(all(g[k] == got[0][k] for g in got for k in DRYRUN_KEYS), "10c: the ranks' norms differ")
    check(all(v < DD_DRYRUN_BAR for v in rel.values()), "10c: 4 ranks disagree with one")


def golden_run(card_name, tag="golden", hold=True, **model_kw):
    """The bowl2D mixing run in f32 to the time of
    tests/data/bowl_mixing_2d.npz, held to its 1e-3 bar (printed
    without it where ``hold`` is False).  Returns the model and its
    final state."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.tools._common import mixing_setup
    from nupgcm_tpu_torch.tools.northstar import rel_l2

    t0 = time.perf_counter()
    ref = np.load(ROOT / "tests" / "data" / "bowl_mixing_2d.npz")
    golden = mixing_setup(npg.generators.bowl2D(0.1, 0.5), "cuda", torch.float32,
                          t_stop=2 * float(ref["t"]), **model_kw)
    n_steps = round(float(ref["t"]) / golden.ts.dt)
    st = golden.run(golden.rest_state(), n_info=0, max_steps=n_steps)
    fe = golden.fe
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    ref_b = bs.from_original_order(ref["b"])
    ref_u = np.stack([us.from_original_order(ref["u"].reshape(-1, 3)[:, k])
                      for k in range(3)], axis=1)
    eb = rel_l2(fe, st.b.double().cpu().numpy(), ref_b, fe.cd_b, fe.tab_b.phi)
    eu = rel_l2(fe, st.u.double().cpu().numpy(), ref_u, fe.cd_u, fe.tab_u.phi)
    print(f"[{tag}] bowl2D h=0.1, {st.step} f32 BDF2 steps to t = {float(st.t):.7f} "
          f"(golden t = {float(ref['t']):.7f}), matmul_precision "
          f"{golden.matmul_precision!r}, on the card in {time.perf_counter() - t0:.2f} s: "
          f"FE rel-L2 b = {eb:.3e}, u = {eu:.3e} ({'bar 1e-3' if hold else 'no bar'}) "
          f"({card_name})", flush=True)
    check(st.step == n_steps and abs(float(st.t) - float(ref["t"])) < 1e-5,
          f"{tag}: golden run stopped at another time")
    check(not hold or (eb < 1e-3 and eu < 1e-3), f"{tag}: golden run disagrees with the golden file")
    return golden, st


def phase_bowl(K, card_name):
    """11a-11c: the 0.87M-DoF bowl with the aggregate level: measure_l2's
    modes "base" and "k0", the device-busy share of 3 steps, then every
    K1/K2 case against plain.  Returns 11a's launches."""
    import torch

    from nupgcm_tpu_torch.tools import kernel_bench as kb
    from nupgcm_tpu_torch.tools import measure_l2
    from nupgcm_tpu_torch.tools._common import initial_b

    torch.cuda.synchronize()
    model, info = measure_l2.build(*BOWL, "cuda", torch.float32)
    print(f"[11a] bowl3D({BOWL[0]}, 0.5, nz={BOWL[1]}): {info['n_vertices']} vertices, "
          f"{info['n_cells']} tets, {info['n_dof']} inversion DoF, {info['n_agg']} aggregates; "
          f"preconditioner {info['preconditioner']}, inner_method {model.inner_method}, "
          f"saddle_coarse_inner {model.saddle_coarse_inner}; build {info['build_s']:.2f} s = "
          f"mesh {info['mesh_s']:.2f} + Spaces/FEData {info['fedata_s']:.2f} + operators "
          f"{info['operators_s']:.2f} (of them the assembled operators' patterns "
          f"{info['patterns_s']:.3f}) + aggregate level {info['aggregate_s']:.2f} (of it the "
          f"host aggregation {info['aggregation_s']:.2f}); peak "
          f"{info['build_peak_mib']:.1f} MiB ({card_name})", flush=True)
    check(info["preconditioner"] == "iterative saddle coarse + L2 aggregate level",
          "11a: not the aggregate branch")
    log = lambda *a: print("[11 measure_l2]", *a, flush=True)
    torch.cuda.synchronize()
    K.reset_counts()
    base = measure_l2.run("base", model=model, info=info, steps=BOWL_STEPS, log=log)
    launches = check_path(model, K, "11a")
    check(base["inv_iters"] < model.inv_opts["itmax"], "11a: the invert hit its cap")
    bowl_report("11a", model, base, card_name)
    K.reset_counts()
    k0 = measure_l2.run("k0", model=model, info=info, steps=BOWL_STEPS, log=log)[0]
    check_path(model, K, "11b")
    bowl_report("11b", model, k0, card_name)
    if base["k"] == 0:  # the same solves; K1/K2's atomics may move a count by one
        check(all(abs(a[k] - b[k]) <= 1 for a, b in zip(k0["steps"], base["steps"])
                  for k in ("evo_iters", "inv_iters")),
              "11b: k = 0 by retune counts otherwise than 11a's default k = 0")
    state = model.invert(model.set_b(model.rest_state(), initial_b))
    torch.cuda.synchronize()
    t0, st = time.perf_counter(), state
    for _ in range(3):  # the same 3 steps as the profiled ones
        st, _ = model.step(st)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    share, wall, _, lost = kb.busy_share(model, state, n=3)
    busy = ("not measured" if share is None else
            f"{1e3 * share * wall:.3f} ms = {100 * share:.1f}% of the profiled wall {wall:.3f} s "
            f"and {100 * share * wall / plain_wall:.1f}% of the unprofiled {plain_wall:.3f} s")
    print(f"[11a] device busy over 3 steps after set_b + invert: {busy}; launches lost per "
          f"trace, of the steps and of the pad: {lost} ({card_name})", flush=True)
    phase_kernels(model, K, card_name, tag="11c kernels")
    phase_coarse(model, "12b", card_name)
    del model
    torch.cuda.empty_cache()
    return launches


def bowl_report(tag, model, rec, card_name):
    """Print and check one measure_l2 record of phase 11."""
    steps = rec["steps"]
    print(f"[{tag}] k = {rec['k']}: "
          + (f"invert {rec['inv_seconds']:.3f} s, FGMRES {rec['inv_iters']} "
             f"(residual {rec['inv_res_invert']:.2e}); " if "inv_seconds" in rec else "")
          + f"{len(steps)} timed steps at {rec['steps_per_s']:.3f} steps/s (first block "
          f"{rec.get('first_block_s', rec.get('compile_s')):.3f} s); peak "
          f"{rec['peak_mib']:.1f} MiB; max|b| {rec['b_max']:.4e} ({card_name})", flush=True)
    for i, st in enumerate(steps):
        print(f"[{tag}] step {i + 1}: CG {st['evo_iters']} (res {st['evo_res']:.2e}), FGMRES "
              f"{st['inv_iters']} (res {st['inv_res']:.2e})", flush=True)
    print(f"[{tag}] launches per step by mode and local size "
          f"{ {k: round(v, 2) for k, v in rec['launches_per_step'].items()} }", flush=True)
    for i, st in enumerate(steps):
        check(st["evo_iters"] < model.evo_opts["itmax"], f"{tag} step {i + 1}: CG hit its cap")
        check(st["inv_iters"] < model.inv_opts["itmax"], f"{tag} step {i + 1}: FGMRES hit its cap")
        check(bool(np.isfinite([st["evo_res"], st["inv_res"]]).all()),
              f"{tag} step {i + 1}: a residual is not finite")
    check(len(steps) == BOWL_STEPS and bool(np.isfinite(rec["b_max"])), f"{tag}: max|b| not finite")


def phase_assembled(K, card_name):
    """11d: assembled operators (FEData's matrix plans, ops/sparse's
    COOMatrix on the card) against K1 "full" and K2 on the slice."""
    import torch

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.fem import assembly as asm
    from nupgcm_tpu_torch.ops.sparse import coo_from_plan
    from nupgcm_tpu_torch.tools import kernel_bench as kb
    from nupgcm_tpu_torch.tools import trace_check
    from nupgcm_tpu_torch.tools._common import mixing_setup

    model = mixing_setup(npg.generators.bowl3D(0.08, 0.5, nz=9), "cuda", torch.float32)
    fe, c, o, pr = model.fe, model.const, model.ops, model.params
    theta = 2.0 / 3.0 * float(model.ts.dt) * pr.a2e2 / pr.mu_rho
    gu3 = asm.physical_grads(c["invJT"], c["dphi_u"], c["embed"])
    elems = {
        "inv": lambda: asm.elem_inversion(c["wq"], c["nu_q"], c["f_q"], c["phi_u"], gu3,
                                          c["phi_p"], pr.a2e2, model.variable_nu),
        "b": lambda: asm.elem_mass(c["wq"], c["phi_b"], c["phi_b"]) + theta * (
            asm.elem_stiffness(c["wq"], c["kh_q"], c["Gb3"], (0, 1))
            + asm.elem_stiffness(c["wq"], c["kv_q"], c["Gb3"], (2,)))}
    kernels = {"inv": (model._inv_matrix(o), "saddle_full", fe.n_inv),
               "b": (model._evo_matrix(o, theta), "scalar", fe.spaces.n_b)}
    rng = np.random.default_rng(8)
    for name, plan_of in (("inv", lambda: fe.plan_inv), ("b", lambda: fe.plan_b)):
        t0 = time.perf_counter()
        plan = plan_of()
        plan_s = time.perf_counter() - t0
        A = coo_from_plan(plan, plan.assemble(elems[name]()))
        op, counter, n = kernels[name]
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device="cuda")
        if name == "inv":
            x_inv = x
        K.reset_counts()
        y_k = op.matvec(x)
        y_a = A.matvec(x)
        torch.cuda.synchronize()
        check(A.vals.is_cuda and K.launches[counter] == 1 and not any(K.plain_calls.values()),
              f"11d {name}: the kernel did not launch, or the COO matrix is off the card")
        rel = float((y_a - y_k).abs().max() / y_a.abs().max())
        t_a, t_k = kb.median_ms(lambda: A.matvec(x)), kb.median_ms(lambda: op.matvec(x))
        print(f"[11d] plan_{name}: {plan.nnz} nonzeros from {plan.slot.size} element entries "
              f"(host plan {plan_s:.2f} s); COO SpMV on the card against {counter} "
              f"(K1/K2): max|dy| = {rel:.2e} max|y| (bar {ASSEMBLED_BAR:.0e}); COO {t_a:.4f} "
              f"ms, kernel {t_k:.4f} ms ({card_name})", flush=True)
        check(rel < ASSEMBLED_BAR, f"11d {name}: the assembled operator disagrees with the kernel")
        del A
    # the profiler late in this long process: traces of K1 full, and
    # every reading that the acceptance rules let through (the complete
    # traces by correlation id, device_ms by its event count) held
    # against the CUDA-graph replay, a reading that needs no profiler
    # (busy time cannot exceed it, nor fall far below it)
    k1 = lambda: kernels["inv"][0].matvec(x_inv)
    tc = trace_check.compare(k1, calls=20, sessions=10)
    dev = kb.device_ms(k1)
    print(f"[11d] profiler sessions of 20 K1 full calls late in the process: "
          f"{trace_check.describe(tc)}; device_ms {dev} ({card_name})", flush=True)
    lo, hi = (f * tc["graph_ms"] for f in GRAPH_BARS)
    for ms in tc["device_ms"] + ([] if dev is None else [dev]):
        check(lo <= ms <= hi, f"11d: a profiler reading of {ms:.4f} ms outside {lo:.4f}-"
              f"{hi:.4f} ms, {GRAPH_BARS} times the CUDA-graph replay's {tc['graph_ms']:.4f} ms")
    del model
    torch.cuda.empty_cache()


def phase_precision(ref_state, card_name):
    """11e: the phase-5 golden under a process that turned TF32 on."""
    import torch

    from nupgcm_tpu_torch.utils import precision

    saved = precision._read()
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    tf32 = precision._read()
    try:
        check(tf32 == (True, True, "high"), f"11e: TF32 did not switch on: {tf32}")
        dist = {}
        for policy in ("float32", None):
            tag = f"11e {policy}"
            # matmul_precision=None runs in TF32: no bar, its distance is the finding
            _, st = golden_run(card_name, tag, hold=policy is not None, matmul_precision=policy)
            check(precision._read() == tf32, f"{tag}: the model left the process's flags changed")
            dist[policy] = [float((a.double().cpu() - b).abs().max() / b.abs().max())
                            for a, b in ((st.u, ref_state[0]), (st.b, ref_state[1]))]
            print(f"[{tag}] against phase 5's state: max|du| = {dist[policy][0]:.3e} max|u|, "
                  f"max|db| = {dist[policy][1]:.3e} max|b|"
                  f"{f' (bar {PRECISION_BAR:.0e})' if policy else ' (TF32 products; no bar)'}",
                  flush=True)
        check(max(dist["float32"]) < PRECISION_BAR,
              "11e: under a TF32 process the model's float32 run left phase 5's states")
    finally:
        precision._write(*saved)
    check(precision._read() == saved, "11e: the script's flags were not restored")
    print(f"[11e] flags restored to {saved} (matmul TF32, cudnn TF32, float32 matmul "
          f"precision)", flush=True)


def build_parts(model) -> str:
    """A model's ``build_seconds`` as "constants c + operators o s",
    with the coarse level's float64 assembly and inverse within the
    operators (and the host aggregation of the vertices within that)."""
    bs = model.build_seconds
    parts = [f"{k.replace('_', ' ')} {bs[k]:.3f}" for k in
             ("saddle_coarse", "aggregate_level", "aggregation") if k in bs]
    return (f"constants {bs['constants']:.3f} + operators {bs['operators']:.3f} s"
            + (f", within them {', '.join(parts)} s" if parts else ""))


def phase_coarse(model, tag, card_name, host=False):
    """12: the model's coarse saddle matrix (its dense coarse level, or
    its aggregate level) built and inverted twice in float64 on the
    card, at the build-time viscosity.  ||A X - I||_inf against n u
    ||A||_inf ||X||_inf, the two builds' differences, and with ``host``
    the card's inverse against np.linalg.inv of the same matrix."""
    import torch

    dense = model.saddle_coarse_dense
    what = "dense coarse level" if dense else "aggregate level"
    build = model._saddle_coarse_matrix if dense else lambda: model._aggregate_matrix(model.ops)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A = build()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        X = model._coarse_inverse(A)
        torch.cuda.synchronize()
        runs.append((A, X, t1 - t0, time.perf_counter() - t1))
    (A, X, ta, ti), (A2, X2, ta2, ti2) = runs
    n = A.shape[0]
    u = torch.finfo(torch.float64).eps / 2
    norm_a, norm_x = float(A.abs().sum(1).max()), float(X.abs().sum(1).max())
    nuk = n * u * norm_a * norm_x
    R = A @ X
    R.diagonal().sub_(1.0)
    res = float(R.abs().sum(1).max())
    del R
    d_a = float((A - A2).abs().max() / A.abs().max())
    d_x = float((X - X2).abs().max() / X.abs().max())
    print(f"[{tag}] {what} {n}^2, float64 on the card: assembly {ta:.3f} / {ta2:.3f} s, "
          f"inverse {ti:.3f} / {ti2:.3f} s (two builds); ||A||_inf {norm_a:.4e}, ||X||_inf "
          f"{norm_x:.4e}, kappa_inf {norm_a * norm_x:.4e}, n u kappa {nuk:.3e}; ||A X - I||_inf "
          f"{res:.3e} = {res / nuk:.3e} of n u kappa (bar 1); second build: max|dA| {d_a:.3e} "
          f"max|A| (bar {COARSE_REBUILD_BAR:.0e}), max|dX| {d_x:.3e} max|X| = "
          f"{d_x / nuk:.3e} of n u kappa (bar 1) ({card_name})", flush=True)
    check(res <= nuk, f"{tag}: ||A X - I|| above n u kappa")
    check(d_a <= COARSE_REBUILD_BAR and d_x <= nuk, f"{tag}: the two builds disagree")
    del A2, X2, runs
    if host:
        Ah = A.cpu().numpy()
        t0 = time.perf_counter()
        Xh = np.linalg.inv(Ah)
        th = time.perf_counter() - t0
        d_h = float(np.abs(X.cpu().numpy() - Xh).max() / np.abs(Xh).max())
        print(f"[{tag}] np.linalg.inv of the same matrix on the host in {th:.3f} s: max|X - "
              f"X_host| {d_h:.3e} max|X_host| = {d_h / nuk:.3e} of n u kappa (bar 1) "
              f"({card_name})", flush=True)
        check(d_h <= nuk, f"{tag}: the card's inverse disagrees with the host's")
    del A, X
    torch.cuda.empty_cache()


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
    from nupgcm_tpu_torch.tools import kernel_bench as kb
    from nupgcm_tpu_torch.tools._common import card_name_limit, initial_b, mixing_setup

    check(pathlib.Path(npg.__file__).resolve().is_relative_to(ROOT),
          f"nupgcm_tpu_torch imported from outside {ROOT}")
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
    launches = counts(K)
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
          f"peak device memory {peak / 2**20:.1f} MiB; launches {dict(K.launches)} = per "
          f"step { {k: v / 10 for k, v in K.launches.items() if v} }; plain calls {plain} "
          f"({name_limit})", flush=True)
    print(f"[slice] launches per step by mode and local size "
          f"{ {k: v / 10 for k, v in K.shape_launches.items() if v} }", flush=True)
    check(all(launches[k] > 0 for k in STEP_COUNTERS),
          f"a kernel of the path never launched: {launches}")
    check(all(n == 0 for n in plain.values()), f"a plain version ran on the card: {plain}")
    check_path(model, K, "slice")  # and K1 ran none of the assembled operators

    for r in results.values():
        r["launches"], r["path"] = launches.get(r["counter"], 0), "4b slice steps"

    # 6. the measurement tools, 7. the trace
    tool_launches = phase_tools(model, K, name_limit)
    for r in probes.values():
        r["launches"], r["path"] = tool_launches[r["counter"]], "6 tools"
    state = phase_trace(model, state, name_limit)
    del model, state
    torch.cuda.empty_cache()

    # 5. f32 golden on the card
    golden, st = golden_run(name_limit)
    golden_state = (st.u.double().cpu(), st.b.double().cpu())  # for 11e
    check_kernels(golden, K, "edges 2D")  # 3c on P2-P1 triangles
    phase_edges(golden, K, "edges 2D")
    del golden, st
    # 3c on P1 triangles: bowl2D on the iterative coarse level
    tri = mixing_setup(npg.generators.bowl2D(0.1, 0.5), "cuda", torch.float32,
                       coarse_dense_max=16)
    check(bool(kb.assembled_cases(tri)), "edges 2D: bowl2D took no iterative coarse level")
    check_kernels(tri, K, "edges 2D coarse")
    phase_edges(tri, K, "edges 2D coarse")
    del tri
    torch.cuda.empty_cache()

    # 8. full physics
    phase_northstar_full(K, name_limit)
    torch.cuda.empty_cache()
    phase_production(K, name_limit)
    torch.cuda.empty_cache()

    # 9. the rest of the single-device package
    phase_sphere(K, name_limit)
    phase_twogrid(K, name_limit)
    phase_channel(K, name_limit)

    # 10. domain decomposition
    dd_launches = phase_dd(K, name_limit, slice_counts=(
        [int(a["evo_iters"]) for a in stats], [int(a["inv_iters"]) for a in stats]))

    # 11. the 0.87M-DoF bowl, assembled operators, the precision policy
    bowl_launches = phase_bowl(K, name_limit)
    phase_assembled(K, name_limit)
    phase_precision(golden_state, name_limit)

    check("jax" not in sys.modules, "JAX was imported")
    for r in results.values():  # K1 "full_pp" and "up": DD's path alone now
        if not r["launches"]:
            r["launches"], r["path"] = dd_launches.get(r["counter"], 0), "10b DD steps"
    kernels = [
        {"name": r["name"], "route": "cuda", "source": SOURCES[r["entry"]],
         "replaces": REPLACES[r["entry"]], "launches": r["launches"], "path": r["path"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
         "device_ms": r["device_ms"], "graph_ms": r["graph_ms"],
         "library_device_ms": r["library_device_ms"]}
        for r in (*results.values(), *probes.values())]
    for entry, r in zip(kernels, results.values()):  # K1/K2 first: their DD, 11a launches
        entry["dd_launches"] = dd_launches.get(r["counter"], 0)
        entry["bowl_launches"] = bowl_launches.get(r["counter"], 0)
    check(all(e["launches"] > 0 for e in kernels), f"a kernel never launched on its path: "
          f"{[(e['name'], e['path']) for e in kernels if not e['launches']]}")
    from nupgcm_tpu_torch.tools import kernel_bench as kb
    print(f"[trace] device_ms readings whose {kb.DEVICE_READS} traces spread beyond "
          f"{kb.SPREAD_BAR}x, (median, readings) ms: {kb.SPREADS} ({name_limit})", flush=True)
    emit_tail(kernels, name_limit, kind, torch.cuda.device_count())


if __name__ == "__main__":
    main()
