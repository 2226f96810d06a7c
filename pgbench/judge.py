"""Whether the window's steps are correct: the numbers the plain
reference reads of them, each beside its limit.

The reference (``reference/<system>.py``) judges each kept step from the
program's state before it: the residual of the evolution and of the
inversion that the step solved, in float64, from the raw mesh and the
configuration alone, and, where the time step adapts, the step's dt.
Judged are every step of one replay of the window drawn from the seed,
of the replay after the window (which also captures the operator
applications), a seeded sample of the set-up's steps, the start state
and the mesh.  Each number is the largest over those steps:

  mesh         the largest relative gap between the mesh's figures
               (counts, volume, tagged measures: ``mesh_figures``) and
               those the configuration stores, made by the JAX package's
               generator (only where the configuration stores them)
  start_b      max |b - b0| / max |b0| of the start state against the
               reference's own interpolation of the seed's initial field
  evo_tol      ||r|| / (atol + rtol ||r0||) of the buoyancy step on its
               free nodes: the residual of the program's b against the
               stopping rule of its CG (r0: the residual of the old b,
               where CG starts), whose tolerances the configuration sets
  inv_tol      the same ratio for the flow inversion (FGMRES, from the
               old flow) on its free rows
  evo_res_max  max |r| / max |rhs| of the buoyancy step on its free nodes
               (a single node gone wrong shows here first)
  evo_op       ||y - A x|| / ||A x|| of the window's own applications of
               the evolution operator M + theta K (K2) in a judged replay:
               the start residual's application in each step's CG, x and
               y as the kernel took and gave them in the replay after
               the window, A the reference's
  inv_op       the same for the inversion operator (K1 ``full``): the
               start residual's application in each step's FGMRES
  p_mean       |volume mean of p| / volume mean of |p|
  dt           |dt / dt_reference - 1| (adaptive time steps only)

The limits are the configuration's ``limits``; a number without a limit
is not correct.
"""

from __future__ import annotations

import importlib

import torch


def judge(sess, cfg: dict, traffic: dict) -> dict:
    ref_mod = importlib.import_module(f"pgbench.reference.{cfg['system']}")
    dev = sess.device
    R = ref_mod.Reference(sess.raw["coords"], sess.raw["cells"], sess.raw["tagged"], cfg, dev)
    R.maps(sess.nodes["u"], sess.nodes["p"], sess.nodes["b"])
    vals = {}
    want = cfg["mesh"].get("figures")
    if want is not None:
        vals["mesh"] = ref_mod.figures_gap(
            ref_mod.mesh_figures(sess.raw["coords"], sess.raw["cells"], sess.raw["tagged"]), want)

    def worst(name, v):
        vals[name] = max(vals.get(name, 0.0), float(v))

    b0 = R.initial_b(traffic["initial_b"]["expr"], sess.ic)
    worst("start_b", (R.b(sess.start_b) - b0).abs().max() / b0.abs().max())
    steps = sess.judged["setup"] + sess.judged["drawn"] + sess.judged["after"]
    n_u = 3 * len(sess.nodes["u"])
    adaptive = cfg["timestepper"]["adaptive"]
    sv = cfg["solver"]
    tol = lambda r0, key: sv.get(f"{key}_atol", 1e-6) + sv.get(f"{key}_rtol", 1e-6) * r0
    for before, after, nu, applied in steps:
        dt, dt_old = float(after["dt"]), float(before["dt"])
        evo_x = [R.b(applied["evo"][0])] if "evo" in applied else []
        e2, e0, emax, ax = R.evolution(R.b(after["b"]), R.b(before["b"]),
                                            R.b(before["b_prev"]), R.u(before["u"]),
                                            R.u(before["u_prev"]), dt, dt_old, before["step"],
                                            xs=evo_x)
        if evo_x:
            worst("evo_op", _rel(R.b(applied["evo"][1]) - ax[0], ax[0]))
        nu_q = R.nu_at(None if nu is None else R.b(nu))
        i2, i0, _, pm = R.inversion(
            R.u(after["u"]), R.p(after["p"]), R.b(after["b"]), nu_q,
            R.u(before["u"]), R.p(before["p"]))
        if "inv" in applied:
            x, y = applied["inv"]
            Au, Ap, _, _ = R.inv_apply(R.u(x[:n_u]), R.p(x[n_u:]),
                                       torch.zeros(R.n2, dtype=torch.float64, device=R.dev), nu_q)
            ref = torch.cat([Au.reshape(-1), Ap])
            worst("inv_op", _rel(torch.cat([R.u(y[:n_u]).reshape(-1), R.p(y[n_u:])]) - ref, ref))
        worst("evo_tol", e2 / tol(e0, "evo"))
        worst("evo_res_max", emax)
        worst("inv_tol", i2 / tol(i0, "inv"))
        worst("p_mean", pm)
        if adaptive:
            worst("dt", abs(dt / R.cfl_dt(R.u(before["u"]), dt_old) - 1.0))
    del R
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = cfg.get("limits", {})
    # every number is reported: a check that found nothing to read fails
    for k in ("evo_op", "inv_op"):
        vals.setdefault(k, float("inf"))
    return {k: {"value": v, "limit": limits.get(k)} for k, v in vals.items()}


def _rel(d, ref):
    return float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(ref).clamp(min=1e-300))
