"""North-star validation run: bowl3D mixing, 1000 BDF2 steps, on a
CUDA device.

The configuration of ``nupgcm_tpu.tools.northstar``: a bowl3D mixing
trajectory that (a) would match the reference golden state after the
50-step prefix (the reference's own acceptance bar, FE-integral
rel-L2 < 1e-3, reference test/bowl_mixing_tests.jl:101-103) and (b)
continues stably to 1000 steps with checkpoint/resume equivalence,
recording throughput and a self-golden final state.  ``--physics full``
adds wind, convection and eddy closures (adaptive-CFL BDF1), with
``refresh_precond`` after every block.

The reference mesh and golden are not shipped with the repository.
The run reads the reference's ``meshes/bowl3D_1.000000e-01_5.000000e-01.msh``
with ``read_msh`` when the ``NUPGCM_REF_MESH`` environment variable
names that file and it is present; otherwise it takes the generated
``bowl3D(0.1, 0.5, nz=7)`` (the JAX tool's own fallback).  When
``NUPGCM_REF_GOLDEN`` also names a file that is present (the reference's
``test/data/bowl_mixing_3D.jld2``), the mixing run holds its 50-step
prefix against it through the Gridap dof maps (``io/gridap.py``) and
records ``prefix50_rel_l2_u``, ``prefix50_rel_l2_b`` and
``prefix50_pass_1e3``, as the JAX tool does; otherwise it skips that
check.  Reading the golden needs h5py.

Usage::

    python -m nupgcm_tpu_torch.tools.northstar [--out artifacts] [--steps 1000]
        [--block 50] [--physics mixing|full]

Writes ``northstar_bowl3d{,_full}.json`` (stats) and
``northstar_bowl3d{,_full}_final.npz`` (final state, mesh-canonical dof
order) into the output directory.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


REF_MESH = os.environ.get("NUPGCM_REF_MESH")
REF_GOLDEN = os.environ.get("NUPGCM_REF_GOLDEN")


def reference_mesh():
    """The reference's bowl3D h = 0.1 mesh (``REF_MESH``) when that file
    is present, else its generated stand-in."""
    from nupgcm_tpu_torch import generators, read_msh

    if REF_MESH and os.path.exists(REF_MESH):
        return read_msh(REF_MESH), "reference bowl3D h=0.1"
    return generators.bowl3D(0.1, 0.5, nz=7), "generated bowl3D h=0.1"


def build_model(physics: str = "mixing", **model_kw):
    """(model, mesh description); ``model_kw`` goes to ``PGModel``
    (e.g. ``device``, ``dtype``)."""
    import nupgcm_tpu_torch as npg

    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2),
    )
    kap = lambda x: 1e-2 + np.exp(
        -(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    if physics == "full":
        # eddy + convection + wind on the same bowl (the reference's
        # full parameterization stack, src/inputs.jl:63-137, with the
        # mixing suite's kappa profile): self-validated stability run
        forc = npg.Forcings(
            nu=1.0, kappa_h=kap, kappa_v=kap,
            tau_x=lambda x: -0.1 * np.cos(np.pi / 2 * x[1]), tau_y=0.0,
            b_surface_bc=npg.SurfaceDirichletBC(0.0),
            conv_param=npg.ConvectionParameterization(
                kappa_c=10.0, N2_min=1e-3),
            eddy_param=npg.EddyParameterization(
                f=lambda x: 1.0 + 0.5 * x[1], N2_min=float(np.sqrt(1e-3))),
        )
    else:
        forc = npg.Forcings(nu=1.0, kappa_h=kap, kappa_v=kap, tau_x=0.0,
                            tau_y=0.0,
                            b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh, mesh_src = reference_mesh()
    spaces = npg.Spaces(
        mesh,
        u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True),
                      (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0],
    )
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    if physics == "full":
        # full parameterizations run under adaptive-CFL BDF1, exactly
        # how the reference runs its full-physics production configs
        # (scratch/run.jl:158-163) -- the wind-driven flow grows well
        # past the mixing suite's fixed-dt stability margin
        ts = npg.BDF1(t_start=0, t_stop=1e9, dt=dt, adaptive=True,
                      CFL_factor=0.5)
    else:
        ts = npg.BDF2(t_start=0, t_stop=2000 * dt, dt=dt)
    # f32's tightest reachable Krylov tolerances (~1e-7/1e-8): the
    # default 1e-6 leaves the 3D trajectory ~1e-2 from the reference
    # golden after 50 steps; these hold the 1e-3 bar
    kw = {}
    if physics == "full":
        # the eddy rebuild shifts nu far from the frozen Chebyshev
        # spectral bounds (up to f^2/N2_min ~ 70x contrast in
        # destratified boundary layers); the bound-free inner-GMRES
        # smoother stays stable under that drift
        kw["inner_method"] = "inner_gmres"
    model = npg.PGModel(fe, params, forc, ts,
                        inv_atol=1e-7, inv_rtol=1e-7,
                        evo_atol=1e-8, evo_rtol=1e-8, **kw, **model_kw)
    return model, mesh_src


def rel_l2(fe, vals, ref, cd, phi):
    """FE-integral relative L2 (squared-norm ratio) of host arrays over
    the cell dof table ``cd`` with basis values ``phi``."""
    wq = np.asarray(fe.geom.wq, np.float64)
    phi = np.asarray(phi, np.float64)
    cd = np.asarray(cd)

    def norm2(v):
        fq = np.einsum("qi,ci->cq", phi, np.asarray(v, np.float64)[cd])
        return float(np.einsum("cq,cq->", wq, fq ** 2))

    vals, ref = np.asarray(vals), np.asarray(ref)
    if vals.ndim == 2:
        return (sum(norm2(vals[:, c] - ref[:, c]) for c in range(3))
                / sum(norm2(ref[:, c]) for c in range(3)))
    return norm2(vals - ref) / norm2(ref)


def prefix_check(model, state, mesh_path: str, golden_path: str) -> dict:
    """The state against a reference golden in Gridap free-dof order
    on the mesh of ``mesh_path``: FE-integral relative L2 of u and b
    and whether both pass the reference's 1e-3 bar
    (test/bowl_mixing_tests.jl:101-103)."""
    from nupgcm_tpu_torch.io import gridap as gi

    fe = model.fe
    maps = gi.gridap_maps(mesh_path, fe.spaces)
    ref = gi.state_from_reference(model, golden_path, maps)
    host = lambda t: t.double().cpu().numpy()
    eu = rel_l2(fe, host(state.u), host(ref.u), fe.cd_u, fe.tab_u.phi)
    eb = rel_l2(fe, host(state.b), host(ref.b), fe.cd_b, fe.tab_b.phi)
    return {"prefix50_rel_l2_u": eu, "prefix50_rel_l2_b": eb,
            "prefix50_pass_1e3": bool(eu < 1e-3 and eb < 1e-3)}


def canonical(fe, state) -> dict:
    """u and b of ``state`` in mesh-canonical dof order (host f64)."""
    us, bs = fe.spaces.u_space, fe.spaces.b_space
    u = state.u.double().cpu().numpy()
    return {"u": np.stack([us.to_original_order(u[:, c]) for c in range(3)], axis=1),
            "b": bs.to_original_order(state.b.double().cpu().numpy())}


def main():
    from nupgcm_tpu_torch.io import checkpoint as ck
    from nupgcm_tpu_torch.tools._common import card_name_limit, require_cuda

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--block", type=int, default=50)
    ap.add_argument("--physics", default="mixing",
                    choices=("mixing", "full"),
                    help="'full' adds wind + convection + eddy "
                         "parameterizations (no golden prefix exists "
                         "for that config; self-validated)")
    args = ap.parse_args()
    require_cuda()
    tag = "" if args.physics == "mixing" else "_full"
    os.makedirs(args.out, exist_ok=True)

    card = card_name_limit()
    print(f"device: {card}", flush=True)
    model, mesh_src = build_model(args.physics)
    fe = model.fe
    print(f"{mesh_src}: {fe.summary()}", flush=True)
    full = args.physics == "full"
    stats = {"mesh": mesh_src, "n_dof": fe.n_inv, "card": card,
             "dtype": str(model.dtype), "physics": args.physics,
             "steps": args.steps}

    state = model.rest_state()
    # ---- 50-step prefix vs the reference golden ------------------------
    t0 = time.time()
    state = model.run(state, n_info=0, max_steps=50,
                      n_precond_refresh=25 if full else None)
    torch.cuda.synchronize()
    print(f"50-step prefix: {time.time() - t0:.1f}s", flush=True)
    if (not full and REF_GOLDEN and os.path.exists(REF_GOLDEN) and REF_MESH
            and os.path.exists(REF_MESH)):
        stats.update(prefix_check(model, state, REF_MESH, REF_GOLDEN))
        print(f"prefix vs reference golden: rel-L2 u={stats['prefix50_rel_l2_u']:.3e} "
              f"b={stats['prefix50_rel_l2_b']:.3e} "
              f"({'PASS' if stats['prefix50_pass_1e3'] else 'FAIL'})", flush=True)
    else:
        print("reference golden unavailable; prefix check skipped", flush=True)

    # ---- march to --steps with periodic checkpoints --------------------
    # the eddy closure's operators depend on the history of b (rebuilt
    # every 10 steps, refreshed after every block), so each checkpoint
    # also keeps the operators it was taken with for the resume check
    traj, ops_at = [], {}

    def save_cb(m, st, i):
        ck.save_state(m, st, os.path.join(args.out, f"northstar{tag}_{i:06d}.npz"))
        ops_at[i] = {k: v.clone() for k, v in m.ops.items()}

    t0 = time.time()
    i = 50
    while i < args.steps:
        n = min(args.block, args.steps - i)
        state, auxs = model.multi_step(state, n)
        i += n
        if full:
            # keep the preconditioner tracking the evolving eddy nu
            model.ops = model.refresh_precond(model.ops, state)
        u_max = float(auxs["u_max"][-1])
        b_max = float(auxs["b_max"][-1])
        assert np.isfinite(u_max) and np.isfinite(b_max) and \
            max(u_max, b_max) < 1e3, f"blow-up at step {i}"
        traj.append({"step": i, "u_max": u_max,
                     "b_free_min": float(auxs["b_free_min"][-1]),
                     "b_free_max": float(auxs["b_free_max"][-1]),
                     "evo_it": int(np.asarray(auxs["evo_iters"]).mean()),
                     "inv_it": int(np.asarray(auxs["inv_iters"]).mean())})
        if i % 250 == 0:
            save_cb(model, state, i)
            print(f"step {i}: |u|max={u_max:.3e} "
                  f"b in [{traj[-1]['b_free_min']:.3e}, "
                  f"{traj[-1]['b_free_max']:.3e}] "
                  f"inv_it={traj[-1]['inv_it']}", flush=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    stats["steps_per_s"] = (args.steps - 50) / wall
    stats["wall_seconds_50_to_end"] = wall
    stats["trajectory"] = traj
    print(f"{args.steps} steps done: {stats['steps_per_s']:.2f} steps/s", flush=True)

    # ---- resume equivalence over the final segment ---------------------
    # resume from the last checkpoint STRICTLY BEFORE the end so the
    # equivalence check re-runs a real segment (steps=1000 -> ck 750),
    # with that checkpoint's operators and the same refresh cadence
    last_ck = ((args.steps - 1) // 250) * 250
    ckf = os.path.join(args.out, f"northstar{tag}_{last_ck:06d}.npz")
    if os.path.exists(ckf) and last_ck in ops_at:
        model.ops = ops_at[last_ck]
        st_r = model.run(ck.load_state(model, ckf), n_info=0, max_steps=args.steps,
                         n_precond_refresh=args.block if full else None)
        du = float((st_r.u - state.u).abs().max())
        db = float((st_r.b - state.b).abs().max())
        stats["resume_max_du"] = du
        stats["resume_max_db"] = db
        print(f"resume from {last_ck}: max|du|={du:.3e} max|db|={db:.3e}", flush=True)

    # ---- self-golden final state (canonical order) ---------------------
    np.savez_compressed(
        os.path.join(args.out, f"northstar_bowl3d{tag}_final.npz"),
        **canonical(fe, state), t=float(state.t), steps=int(state.step))
    with open(os.path.join(args.out, f"northstar_bowl3d{tag}.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps({k: v for k, v in stats.items() if k != "trajectory"}), flush=True)


if __name__ == "__main__":
    main()
