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
  5. golden: the bowl2D mixing run in f32 on the card, to the time of
     tests/data/bowl_mixing_2d.npz (t = 5.1: 51 BDF2 steps), FE-integral
     relative L2 below 1e-3 for b and u.

The line before the last is a JSON object {"kernels": [...]}; the last
line is {"ok": true, "device": {...}}.
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
            "scalar_matvec": "nupgcm_tpu/ops/window.py:865"}
SOURCE = "nupgcm_tpu_torch/csrc/element_matvec.cu"


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mixing_setup(npg, mesh, device, dtype, t_stop=None, **model_kw):
    """The bench.py bowl-mixing configuration (dt = 1e-4 mu/(alpha eps)^2)."""
    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=50 * dt if t_stop is None else t_stop, dt=dt)
    return npg.PGModel(fe, params, forc, ts, dtype=dtype, device=device, **model_kw)


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
    print(f"[build] {SOURCE} -> {build.library_path().relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s)", flush=True)
    for line in (build.build_log or "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 4a. the slice model (its element tensors feed phase 3)
    t0 = time.perf_counter()
    mesh = npg.generators.bowl3D(0.08, 0.5, nz=9)
    model = mixing_setup(npg, mesh, "cuda", torch.float32)
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

    # 4b. drive the main path through the kernels
    bic = lambda x: 0.1 * np.exp(-(x[2] + 0.5 * (1 - x[0] ** 2 - x[1] ** 2)) / 0.05)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t0 = time.perf_counter()
    state = model.invert(model.set_b(model.rest_state(), bic))
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
    check(all(n > 0 for n in launches.values()), f"a kernel of the path never launched: {launches}")
    check(all(n == 0 for n in plain.values()), f"a plain version ran on the card: {plain}")
    del model, state
    torch.cuda.empty_cache()

    # 5. f32 golden on the card
    t0 = time.perf_counter()
    ref = np.load(ROOT / "tests" / "data" / "bowl_mixing_2d.npz")
    golden = mixing_setup(npg, npg.generators.bowl2D(0.1, 0.5), "cuda", torch.float32,
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
    print(json.dumps({"kernels": [
        {"name": r["name"], "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[r["entry"]],
         "launches": launches[r["counter"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for r in results.values()]}))
    print(name_limit)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
