"""Spatial convergence study of the evolution (diffusion) solver.

Capability parity with the reference's informal convergence checks
(reference scratch/convergence.jl, scratch/timestep_convergence.jl):
measure the error of the analytic decaying mode against mesh size and
time step, confirming the expected orders.  ``--quick`` shrinks the
study to a few seconds (the default sizes are the JAX example's).

Run: python -m nupgcm_tpu_torch.examples.convergence [--device cuda]
         [--dtype float64]
"""

import argparse

import numpy as np

from . import device_args, dtype_of


# (spatial nz list, temporal-study nz, temporal step counts, reference steps)
SIZES = {"full": ((4, 8, 16), 24, (8, 16, 32), 512), "quick": ((4, 8), 4, (2, 4), 16)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    device_args(ap, dtype="float64")
    ap.add_argument("--quick", action="store_true", help="the small study of the tests")
    args = ap.parse_args(argv)
    nzs, nz_fine, counts, ref_steps = SIZES["quick" if args.quick else "full"]

    import nupgcm_tpu_torch as npg

    kw = dict(device=args.device, dtype=dtype_of(args))
    params = npg.Parameters(eps=1.0, alpha=1.0, mu_rho=1.0, N2=0.0,
                            f=lambda x: 1.0 + 0 * x[0], H=lambda x: 1.0)
    forc = npg.Forcings(nu=1.0, kappa_h=0.0, kappa_v=1.0, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    lam = np.pi ** 2

    print("# spatial convergence (BDF2, dt fixed small)")
    dt, nsteps = 1e-4, 20
    errs = []
    for nz in nzs:
        mesh = npg.generators.rect_mesh(3, nz)
        spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                            u_diri_masks=[(True, True, True)],
                            b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
        fe = npg.FEData(mesh, spaces)
        ts = npg.BDF2(t_start=0, t_stop=nsteps * dt, dt=dt)
        # tight solver tolerances so discretization error dominates
        model = npg.PGModel(fe, params, forc, ts, evo_atol=1e-13, evo_rtol=1e-12,
                            inv_atol=1e-12, inv_rtol=1e-10, **kw)
        st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
        st = model.run(st, n_info=0)
        zc = spaces.b_space.dof_coords[:, 2]
        exact = np.exp(-lam * float(st.t)) * np.sin(np.pi * zc)
        err = np.abs(st.b.double().cpu().numpy() - exact).max()
        errs.append(err)
        print(f"  nz={nz:3d}  err={err:.3e}")
    space_orders = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
    print(f"  observed spatial orders: {space_orders}")

    print("# temporal convergence (fixed fine mesh)")
    mesh = npg.generators.rect_mesh(3, nz_fine)
    spaces = npg.Spaces(mesh, u_diri_tags=["boundary"],
                        u_diri_masks=[(True, True, True)],
                        b_diri_tags=["top", "bottom"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    t_end = 0.04

    def solve(TS, n):
        ts = TS(t_start=0, t_stop=t_end, dt=t_end / n)
        model = npg.PGModel(fe, params, forc, ts, evo_atol=1e-13, evo_rtol=1e-12,
                            inv_atol=1e-12, inv_rtol=1e-10, **kw)
        st = model.set_b(model.rest_state(), lambda x: np.sin(np.pi * x[2]))
        # exact step count: the while t < t_stop loop can overshoot by
        # one step under float accumulation, misaligning end times
        return model.run(st, n_info=0, max_steps=n).b.double().cpu().numpy()

    # same-mesh fine-dt reference isolates the temporal error
    b_ref = solve(npg.BDF2, ref_steps)
    time_orders = {}
    for TS in (npg.BDF1, npg.BDF2):
        errs = [np.abs(solve(TS, n) - b_ref).max() for n in counts]
        orders = np.log2(np.array(errs[:-1]) / np.array(errs[1:]))
        time_orders[TS.__name__] = orders
        print(f"  {TS.__name__}: errs={['%.2e' % e for e in errs]} orders={orders}")
    return space_orders, time_orders


if __name__ == "__main__":
    main()
