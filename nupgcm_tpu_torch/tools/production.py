"""Production-configuration run: wind- and buoyancy-forced
channel+basin at reference scale, on a CUDA device.

Mirrors the reference's dimensional production script
(reference scratch/run.jl:26-163): Earth-scale parameters mapped to
(eps, alpha, mu_rho), the channel_basin_no_flat_round_end geometry at
alpha = 1/8, channel-only zonal wind stress, hemisphere surface
buoyancy, bottom-enhanced kappa, convection + eddy parameterizations,
P1 buoyancy, adaptive-CFL BDF1.  The same configuration as
``nupgcm_tpu.tools.production``.

Usage::

    python -m nupgcm_tpu_torch.tools.production [--h 0.02] [--steps 50]
        [--out artifacts] [--refine R]

Writes ``production_channel_basin.json`` (config, mesh-quality stats,
run stats, the card's name and power limit) into the output directory.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def dimensional_parameters():
    """Earth scales -> nondimensional numbers (scratch/run.jl:28-52)."""
    Omega = 2 * np.pi / 86400.0          # s^-1
    a = 6.371e6                          # m
    beta = 2 * Omega / a                 # m^-1 s^-1
    L = 2 * np.pi * a * 60 / 360         # m
    f0 = beta * L                        # s^-1
    H0 = 4e3                             # m
    kappa0 = 1e-5                        # m^2 s^-1
    Ke = 1000.0                          # m^2 s^-1
    N0 = 1e-3                            # s^-1
    alpha_T = 2e-4                       # 1/degC
    g = 9.81                             # m s^-2
    rho0 = 1035.0                        # kg m^-3
    nu0 = Ke * f0 ** 2 / N0 ** 2         # m^2 s^-1
    tau0 = rho0 * N0 ** 2 * H0 ** 3 / L  # N m^-2
    b0 = g * alpha_T * 30 / (N0 ** 2 * H0)
    eps = float(np.sqrt(nu0 / f0 / H0 ** 2))
    mu = nu0 / kappa0
    rho = (N0 * H0 / f0 / L) ** 2
    t0 = 1 / f0 / rho                    # s
    return dict(eps=eps, mu_rho=float(mu * rho), b0=float(b0),
                tau0=float(tau0), t0=float(t0), kappa0=float(kappa0))


def build_model(h: float, refine=None, **model_kw):
    """(model, mesh, dims); ``model_kw`` goes to ``PGModel`` (e.g.
    ``device``, ``dtype``)."""
    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.mesh.generators import channel_basin_no_flat_round_end

    dims = dimensional_parameters()
    alpha = 0.125
    L, W = 2.0, 1.0
    L_channel = L / 4.0
    L_flat = 5.0 * L_channel / 8.0
    y_ch_top = -L / 2 + L_channel
    y_rise = -L / 2 + L_flat
    yc = L / 2 - W / 2
    Hd = alpha * W

    def depth(x, y):
        """Water depth (the run.jl H(x) profile, scratch/run.jl:57-97)."""
        x, y = np.asarray(x), np.asarray(y)
        t = np.clip((y_ch_top - y) / (y_ch_top - y_rise), 0.0, 1.0)
        d_ch = np.where(y <= y_ch_top, Hd * t * (2.0 - t), 0.0)
        s = x / W
        d_par = np.where((y >= -L / 2 + L_channel / 2) & (y <= yc),
                         4.0 * Hd * s * (1.0 - s), 0.0)
        r = np.hypot(x - W / 2, np.maximum(y - yc, 0.0))
        d_round = np.where(y > yc,
                           Hd * np.maximum(1.0 - (2.0 * r / W) ** 2, 0.0), 0.0)
        return np.maximum(np.maximum(d_ch, d_par), d_round)

    params = npg.Parameters(
        eps=dims["eps"], alpha=alpha, mu_rho=dims["mu_rho"], N2=0.0,
        f=lambda x: x[1],
        H=lambda x: depth(x[0], x[1]),
    )
    # bottom-enhanced mixing (run.jl:104-113)
    kI, kB = 1.0, 1e2
    d_bl = 500.0 / 4000.0 * alpha

    def kappa(x):
        return kI + (kB - kI) * np.exp(-(x[2] + depth(x[0], x[1])) / d_bl)

    tau0 = dims["tau0"]

    def tau_x(x):
        y = np.asarray(x[1])
        return np.where(
            y > -0.5, 0.0,
            -0.2 / tau0 * (y + 1.0) * (y + 0.5) / 0.25 ** 2)

    b0 = dims["b0"]

    def b_surface(x):
        y = np.asarray(x[1])
        return np.where(y > 0, 0.0, -b0 * y ** 2)

    forc = npg.Forcings(
        nu=1.0, kappa_h=kappa, kappa_v=kappa, tau_x=tau_x, tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(b_surface),
        conv_param=npg.ConvectionParameterization(
            kappa_c=0.2 / dims["kappa0"], N2_min=1e-3),
        eddy_param=npg.EddyParameterization(
            f=lambda x: x[1], N2_min=float(np.sqrt(1e-3))),
    )
    mesh = channel_basin_no_flat_round_end(h, alpha=alpha,
                                           refinement_factor=refine)
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"],
        b_diri_vals=[b_surface, b_surface],
        b_order=1,  # production runs P1 buoyancy (scratch/run.jl:152)
    )
    fe = npg.FEData(mesh, spaces)
    dt = 1.0 * 86400.0 / dims["t0"]      # 1 day (run.jl:158)
    t_stop = dims["mu_rho"] / dims["eps"] ** 2 / kI
    ts = npg.BDF1(t_start=0.0, t_stop=t_stop, dt=dt, adaptive=True,
                  CFL_factor=0.8)
    model = npg.PGModel(fe, params, forc, ts, inv_itmax=1000, **model_kw)
    return model, mesh, dims


def run_logged(model, state, **run_kw):
    """``model.run(state, **run_kw)``, also returning every step's aux
    dict (solver iterations and residuals) in order."""
    step, auxs = model.step, []

    def logged(st):
        st, aux = step(st)
        auxs.append(aux)
        return st, aux

    model.step = logged
    try:
        return model.run(state, **run_kw), auxs
    finally:
        del model.step


def main():
    from nupgcm_tpu_torch.mesh.quality import quality_report
    from nupgcm_tpu_torch.tools._common import card_name_limit, require_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=0.02)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--refine", type=float, default=None)
    ap.add_argument("--out", default="artifacts")
    args = ap.parse_args()
    require_cuda()
    os.makedirs(args.out, exist_ok=True)

    card = card_name_limit()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model, mesh, dims = build_model(args.h, refine=args.refine)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    q = quality_report(mesh)
    print(f"{mesh.summary()}\n{model.fe.summary()}\nbuild {build_s:.1f}s\n"
          f"{q['text']}", flush=True)
    stats = {"h": args.h, "alpha": 0.125, "n_dof": model.fe.n_inv,
             "n_cells": mesh.n_cells, "card": card,
             "dtype": str(model.dtype), "inner_method": model.inner_method,
             "preconditioner": model.preconditioner_branch,
             "dims": dims, "build_seconds": build_s,
             "build_peak_bytes": torch.cuda.max_memory_allocated(),
             "quality": {k: q[k] for k in ("angles", "volumes")},
             "steps": args.steps}

    state = model.rest_state()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    # eddy runs: refresh the preconditioner from the evolving nu field
    # every 25 steps
    state, aux_log = run_logged(model, state, n_info=10, max_steps=args.steps,
                                n_precond_refresh=25)
    torch.cuda.synchronize()
    wall = time.time() - t0
    u = state.u.double().cpu().numpy()
    stats.update({
        "wall_seconds": wall,
        "steps_per_s": args.steps / wall,
        "run_peak_bytes": torch.cuda.max_memory_allocated(),
        "evo_iters": [int(a["evo_iters"]) for a in aux_log],
        "inv_iters": [int(a["inv_iters"]) for a in aux_log],
        "inv_res": [float(a["inv_res"]) for a in aux_log],
        "inv_itmax": model.inv_opts["itmax"],
        "u_max": float(np.abs(u).max()),
        "finite": bool(np.isfinite(u).all()),
        "t_final": float(state.t),
        "dt_final": float(state.dt),
    })
    with open(os.path.join(args.out, "production_channel_basin.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps({k: v for k, v in stats.items() if k != "quality"}), flush=True)


if __name__ == "__main__":
    main()
