"""Rotating-ball circulation on the sphere mesh.

The reference generates a sphere geometry (reference
meshes/mesh_sphere.jl:1-17) but ships no script that runs it; this
example closes that gap end-to-end: a stratified, rotating solid ball
(f = z, the projection of the rotation axis) with a warm equatorial
buoyancy anomaly spun up to thermal-wind balance.

Run:  python -m nupgcm_tpu_torch.examples.sphere [--n 6] [--steps 100]
          [--device cuda] [--dtype float32]
"""

import argparse
import json
import os

import numpy as np

from . import device_args, dtype_of


def b0(x):
    """Warm equatorial band: drives an axisymmetric thermal-wind jet."""
    return 0.1 * np.exp(-(x[2] ** 2) / 0.1) * np.exp(
        -(1.0 - x[0] ** 2 - x[1] ** 2 - x[2] ** 2) / 0.5)


def blob(x):
    """Off-axis buoyant blob (tests/test_sphere.py's start)."""
    return 0.1 * np.exp(-((x[0] - 0.3) ** 2 + x[1] ** 2 + x[2] ** 2) / 0.1)


def build_model(mesh, eps=0.1, dt=2e-3, **model_kw):
    """The example's model on ``mesh`` (a ``sphere_mesh``);
    ``model_kw`` goes to ``PGModel`` (``device``, ``dtype``)."""
    import nupgcm_tpu_torch as npg

    params = npg.Parameters(
        eps=eps, alpha=1.0, mu_rho=1.0, N2=1.0,
        f=lambda x: x[2], H=lambda x: 1.0,
    )
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2,
                        tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["boundary"], u_diri_vals=[(0, 0, 0)],
        u_diri_masks=[(True, True, True)],
        b_diri_tags=["surface"], b_diri_vals=[0.0],
    )
    fe = npg.FEData(mesh, spaces)
    ts = npg.BDF2(t_start=0, t_stop=1e9, dt=dt)
    return npg.PGModel(fe, params, forc, ts, **model_kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=6,
                    help="cells per cube half-axis (resolution ~ 1/n)")
    ap.add_argument("--eps", type=float, default=0.1, help="Ekman number")
    device_args(ap)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--block", type=int, default=10)
    ap.add_argument("--out", default="out/sphere")
    args = ap.parse_args(argv)

    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch.io.checkpoint import save_state

    os.makedirs(args.out, exist_ok=True)
    mesh = npg.generators.sphere_mesh(args.n)
    print(mesh.summary())
    model = build_model(mesh, args.eps, device=args.device, dtype=dtype_of(args))
    fe = model.fe
    print(fe.summary())
    state = model.set_b(model.rest_state(), b0)

    def save_cb(m, st, i):
        save_state(m, st, os.path.join(args.out, f"state_{i:08d}.npz"))

    state = model.run(state, n_info=max(1, args.steps // 10),
                      max_steps=args.steps, steps_per_block=args.block,
                      n_save=max(1, args.steps // 2), save_callback=save_cb)

    u = state.u.double().cpu().numpy()
    b = state.b.double().cpu().numpy()
    xy = np.asarray(fe.spaces.u_space.dof_coords)[:, :2]
    rho = np.linalg.norm(xy, axis=1)
    az = np.stack([-xy[:, 1], xy[:, 0]], axis=1) / np.maximum(
        rho, 1e-12)[:, None]
    u_az = (u[:, :2] * az).sum(axis=1)
    summary = {
        "n_dof": fe.n_inv,
        "steps": int(state.step),
        "u_max": float(np.abs(u).max()),
        "u_az_max": float(np.abs(u_az).max()),
        "b_range": [float(b.min()), float(b.max())],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
