"""Mixing-driven circulation in a bowl-shaped basin.

Port of the reference's canonical example (reference
examples/bowl_mixing.jl): set Parameters and Forcings, build a mesh,
define Spaces with Dirichlet BCs, assemble the inversion + evolution
systems, and run.  The final plots need matplotlib; where it is not
installed (as on the card's machine) they are skipped.

Run:  python -m nupgcm_tpu_torch.examples.bowl_mixing [--h 0.12]
          [--device cuda] [--dtype float32]
"""

import argparse
import importlib.util
import os

import numpy as np

from . import device_args, dtype_of


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--h", type=float, default=0.12, help="mesh resolution")
    device_args(ap)
    ap.add_argument("--out", default="out/bowl_mixing")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch import plotting
    from nupgcm_tpu_torch.io.checkpoint import save_state
    from nupgcm_tpu_torch.io.vtk import save_vtk

    os.makedirs(args.out, exist_ok=True)

    # ---- parameters (reference examples/bowl_mixing.jl:35-43) --------
    eps = 2e-1   # Ekman number
    alpha = 0.5  # aspect ratio
    mu = 1.0     # Prandtl x Burger
    N2 = 1 / alpha
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=N2,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )

    # ---- forcings: bottom-enhanced mixing, no wind -------------------
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha)
    )
    forcings = npg.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0, tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(0.0),
    )

    # ---- mesh + spaces ----------------------------------------------
    mesh = npg.generators.bowl3D(args.h, alpha)
    print(mesh.summary())
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"],
        b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    print(fe.summary())

    # ---- model -------------------------------------------------------
    dt = 1e-3
    ts = npg.BDF2(t_start=0, t_stop=args.steps * dt, dt=dt)
    model = npg.PGModel(fe, params, forcings, ts, device=args.device, dtype=dtype_of(args))

    # diagnose the flow for an initial buoyancy, then integrate
    state = model.rest_state()
    state = model.invert(state)

    def save(model, st, i):
        save_state(model, st, f"{args.out}/state_{i:08d}.npz")
        save_vtk(model, st, f"{args.out}/state_{i:08d}.vtu")

    state = model.run(state, n_info=10, n_save=50, save_callback=save)

    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib is not installed: no plots")
    else:
        plotting.plot_slice(model, state, "b", ofile=f"{args.out}/b_final.png",
                            quiver=True)  # returns a reusable SliceCache
        plotting.plot_profiles(model, state, x=0.5, y=0.0, ofile=f"{args.out}/profiles.png")
    save(model, state, args.steps)
    print(f"done -> {args.out}")
    return model, state


if __name__ == "__main__":
    main()
