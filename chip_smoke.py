#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (nupgcm_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root

Phases (any failed check raises, and the script exits non-zero):

  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA element-matvec kernels from csrc/.
  3. kernels vs plain: every kernel mode on the element tensors of the
     h = 0.08 bowl3D model, against its plain PyTorch version, in f32
     (bar 2e-6 max|y|) and f64 (bar 1e-12 max|y|); the atomics sum in
     a different order on every run.  Times per application (CUDA
     events, median of 30 after warm-up).
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

Phases run in the order 1, 2, 4a (build the slice), 3, 3b, 4b (step
it), 6, 7, 5.  The last three lines are the card's name and power
limit, a JSON object {"kernels": [...]}, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
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
STEP_COUNTERS = ("saddle_full", "saddle_full_pp", "saddle_uu", "saddle_up", "scalar")
STREAM_SHAPES = ((3, 128, False), (1, 512, True))  # K4 cases of profile_stream


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=30, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events]))


def kernel_cases(model, K):
    """(entry, kernel fn, plain fn, mode, label, args, len(x), n_u_nodes)
    for every kernel mode at the slice's shapes."""
    c, o, sp = model.const, model.ops, model.fe.spaces
    nu, nv = sp.u_space.ndof, sp.p_space.ndof
    theta = 2.0 / 3.0 * float(model.ts.dt) * model.params.a2e2 / model.params.mu_rho
    evo = o["M_e"] + theta * (o["Kh_e"] + o["Kv_e"])
    fine = (c["cd_u"], c["cd_p"])
    vert = (c["cd_p"], c["cd_p"])
    none = (c["cd_p"], c["cd_none"])
    S = ("saddle_matvec", K.saddle_matvec, K.saddle_matvec_plain)
    return [
        (*S, "full", "P2-P1 inversion operator",
         (o["A_uu_e"], o["A_up_e"], o["A_pu_e"], None, *fine), 3 * nu + sp.n_p, nu),
        (*S, "up", "P2-P1 pressure coupling",
         (None, o["A_up_e"], None, None, *fine), sp.n_p, nu),
        (*S, "uu", "P2 viscous smoother",
         (o["visc_e"], None, None, None, c["cd_u"], c["cd_none"]), 3 * nu, nu),
        (*S, "uu", "P1 coarse viscous smoother",
         (o["sc_visc_e"], None, None, None, *none), 3 * nv, nv),
        (*S, "full_pp", "P1-P1 stabilized coarse saddle",
         (o["sc_uu"], o["sc_up"], o["sc_pu"], o["sc_pp"], *vert), 4 * nv, nv),
        ("scalar_matvec", K.scalar_matvec, K.scalar_matvec_plain, None,
         "P2 buoyancy evolution matrix", (evo, c["cd_b"]), sp.n_b, None),
        ("scalar_matvec", K.scalar_matvec, K.scalar_matvec_plain, None,
         "P1 pressure mass", (o["Mp_e"], c["cd_p"]), sp.n_p, None),
    ]


def phase_kernels(model, K, rng, card_name):
    """Kernel vs plain on the card; returns per-(entry, mode) results."""
    import torch

    results = {}
    for entry, kfn, pfn, mode, label, args, n_x, n_nodes in kernel_cases(model, K):
        tail = () if mode is None else (mode, n_nodes)
        x_np = rng.standard_normal(n_x)
        for dtype, bar in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
            a = [t if t is None or not t.is_floating_point() else t.to(dtype) for t in args]
            x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
            y = kfn(*a, x, *tail)
            y0 = pfn(*a, x, *tail)
            torch.cuda.synchronize()
            check(torch.isfinite(y).all().item(), f"{entry} {mode} {label}: non-finite output")
            err = float((y - y0).abs().max())
            scale = float(y0.abs().max())
            name = entry if mode is None else f"{entry}[{mode}]"
            print(f"[kernels] {name:24s} {label:32s} {str(dtype)[6:]}: "
                  f"max|y-y_plain| = {err:.3e} = {err / scale:.2e} max|y| (bar {bar:.0e})",
                  flush=True)
            check(err <= bar * scale, f"{name} {label} {dtype}: kernel disagrees with plain")
            if dtype == torch.float32:
                rec = results.setdefault(name, {
                    "name": name, "max_abs_err": 0.0, "entry": entry,
                    "counter": "scalar" if mode is None else f"saddle_{mode}"})
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                ms = median_ms(lambda: kfn(*a, x, *tail))
                plain_ms = median_ms(lambda: pfn(*a, x, *tail))
                print(f"[kernels] {name:24s} {label:32s} f32: {ms:.4f} ms kernel, "
                      f"{plain_ms:.4f} ms plain ({card_name})", flush=True)
                if "ms" not in rec:  # the first case of a mode is its largest
                    rec.update(ms=ms, plain_ms=plain_ms)
    return results


def probe_check(name, dtype, out, ref, scale, scale_name, card_name, kfn, pfn):
    """Kernel output vs plain, bar BARS[dtype] of ``scale`` (per entry,
    or one number); prints both times for f32."""
    import torch

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
        rec["ms"], rec["plain_ms"] = median_ms(kfn), median_ms(pfn)
        print(f"[probes] {name:22s} f32: {rec['ms']:.4f} ms kernel, "
              f"{rec['plain_ms']:.4f} ms plain ({card_name})", flush=True)
    return rec


def phase_probes(model, K, rng, card_name):
    """K3, K1 pinned and K4 vs their plain versions on the card."""
    import torch

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
                          lambda: K.stream_saddle_plain(*k3))
        if "ms" in rec:
            results["stream_saddle"] = dict(rec, counter="stream_saddle")
        # K1 pinned: the first 128 cells' tensors, every cell's dof tables
        pin = min(uu.shape[0], K.LANES)
        x = torch.as_tensor(x_np, dtype=dtype, device="cuda")
        k1 = (uu[:pin], up[:pin], pu[:pin], c["cd_u"], c["cd_p"], x, n)
        kfn = lambda: K.saddle_matvec(*k1[:3], None, *k1[3:6], "full", n, pinned=True)
        y0 = K.saddle_matvec_pinned_plain(*k1)
        rec = probe_check("saddle_matvec[pinned]", dtype, kfn(), y0, y0.abs().max(),
                          "max|y|", card_name, kfn, lambda: K.saddle_matvec_pinned_plain(*k1))
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
                          lambda: K.stream_probe_plain(parts, w0, idx))
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


def emit_tail(kernels, name_limit, kind, count):
    """The run's last three lines: the card, the kernels, the verdict."""
    print(name_limit)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


def fe_rel_l2(fe, vals, ref, cell_dofs, phi):
    """FE-integral relative L2 (squared-norm ratio), the reference's
    acceptance metric (tests/_helpers.py::integral_rel_l2)."""
    wq = np.asarray(fe.geom.wq, np.float64)

    def norm2(v):
        fq = np.einsum("qi,ci->cq", np.asarray(phi, np.float64), v[cell_dofs])
        return float(np.einsum("cq,cq->", wq, fq ** 2))

    if vals.ndim == 2:
        return (sum(norm2(vals[:, k] - ref[:, k]) for k in range(3))
                / sum(norm2(ref[:, k]) for k in range(3)))
    return norm2(vals - ref) / norm2(ref)


def main():
    import torch

    # 1. device
    check(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.ops import build
    from nupgcm_tpu_torch.ops import kernels as K
    from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup

    check(pathlib.Path(npg.__file__).resolve().is_relative_to(ROOT),
          f"nupgcm_tpu_torch imported from outside {ROOT}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_limit = card()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {name_limit}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load()
    print(f"[build] {', '.join(sorted(set(SOURCES.values())))} -> "
          f"{build.library_path().relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s)", flush=True)
    for line in (build.build_log or "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

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

    # 3. kernels vs plain on the slice's tensors
    results = phase_kernels(model, K, np.random.default_rng(0), name_limit)

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
          f"peak device memory {peak / 2**20:.1f} MiB; launches {launches}; "
          f"plain calls {plain} ({name_limit})", flush=True)
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
    eb = fe_rel_l2(fe, b, ref_b, fe.cd_b, fe.tab_b.phi)
    eu = fe_rel_l2(fe, u, ref_u, fe.cd_u, fe.tab_u.phi)
    print(f"[golden] bowl2D h=0.1, {st.step} f32 BDF2 steps to t = {float(st.t):.7f} "
          f"(golden t = {float(ref['t']):.7f}) on the card in {time.perf_counter() - t0:.2f} s: "
          f"FE rel-L2 b = {eb:.3e}, u = {eu:.3e} (bar 1e-3)", flush=True)
    check(st.step == n_steps and abs(float(st.t) - float(ref["t"])) < 1e-5,
          "golden run stopped at another time")
    check(eb < 1e-3 and eu < 1e-3, "golden run disagrees with the golden file")

    check("jax" not in sys.modules, "JAX was imported")
    kernels = [
        {"name": r["name"], "route": "cuda", "source": SOURCES[r["entry"]],
         "replaces": REPLACES[r["entry"]], "launches": r["launches"],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for r in (*results.values(), *probes.values())]
    emit_tail(kernels, name_limit, kind, torch.cuda.device_count())


if __name__ == "__main__":
    main()
