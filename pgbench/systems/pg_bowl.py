"""The system under test for the ``pg_bowl`` configurations: the port's
``PGModel`` (``nupgcm_tpu_torch``) on a generated bowl mesh, built from a
configuration file's numbers and coefficient expressions.

It hands the harness the model, the raw mesh (for the plain reference)
and the program's node coordinates of each space (to read its output
vectors); nothing else of the program reaches the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..expr import callable_of

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build(cfg: dict, device, matmul_precision="float32"):
    """(model, mesh): the configuration's ``PGModel`` on ``device``.
    ``matmul_precision=None`` leaves the process's TF32 setting in force
    (the control)."""
    import nupgcm_tpu_torch as npg
    from nupgcm_tpu_torch import generators

    m, P, co = cfg["mesh"], cfg["params"], cfg["coefficients"]
    if m["generator"] != "bowl3D":
        raise ValueError(f"pg_bowl builds bowl3D meshes, not {m['generator']!r}")
    mesh = generators.bowl3D(m["h"], m["alpha"], nz=m["nz"])
    fn = lambda key: callable_of(co[key], P)
    params = npg.Parameters(eps=P["eps"], alpha=P["alpha"], mu_rho=P["mu_rho"], N2=P["N2"],
                            f=fn("f"), H=fn("H"))
    extra = {}
    if cfg.get("convection"):
        c = cfg["convection"]
        extra["conv_param"] = npg.ConvectionParameterization(kappa_c=c["kappa_c"],
                                                              N2_min=c["N2_min"])
    if cfg.get("eddy"):
        e = cfg["eddy"]
        extra["eddy_param"] = npg.EddyParameterization(
            f=callable_of(e["f"], P), N2_min=e["N2_min"], smoothing=e["smoothing"],
            nu_min=e["nu_min"])
    forc = npg.Forcings(nu=fn("nu"), kappa_h=fn("kappa_h"), kappa_v=fn("kappa_v"),
                        tau_x=fn("tau_x"), tau_y=fn("tau_y"),
                        b_surface_bc=npg.SurfaceDirichletBC(0.0), **extra)
    bc = cfg["boundary"]
    tags = list(bc["u_dirichlet"])
    spaces = npg.Spaces(
        mesh, u_diri_tags=tags, u_diri_vals=[(0, 0, 0)] * len(tags),
        u_diri_masks=[tuple(c in bc["u_dirichlet"][t] for c in range(3)) for t in tags],
        b_diri_tags=list(bc["b_dirichlet"]), b_diri_vals=[0.0] * len(bc["b_dirichlet"]))
    fe = npg.FEData(mesh, spaces)
    t = cfg["timestepper"]
    scheme = {"BDF1": npg.BDF1, "BDF2": npg.BDF2}[t["scheme"]]
    ts = scheme(t_start=0, t_stop=1e9, dt=t["dt"], adaptive=t["adaptive"],
                CFL_factor=t["CFL_factor"])
    model = npg.PGModel(fe, params, forc, ts, dtype=DTYPES[cfg["dtype"]], device=device,
                        matmul_precision=matmul_precision, **cfg["solver"])
    return model, mesh


def start_state(model, expr: str, params: dict):
    """The model's rest state with the buoyancy ``expr`` (its Dirichlet
    nodes keep their boundary values), as ``set_b`` sets it."""
    P = dict(model_params(model), **params)
    return model.set_b(model.rest_state(), callable_of(expr, P))


def model_params(model) -> dict:
    p = model.params
    return {"eps": p.eps, "alpha": p.alpha, "mu_rho": p.mu_rho, "N2": p.N2}


def raw_mesh(mesh) -> dict:
    """What the reference reads of the mesh: coordinates, tetrahedra and
    the tagged boundary simplices."""
    return {"coords": np.array(mesh.coords), "cells": np.array(mesh.cells),
            "tagged": {k: {d: np.array(v) for d, v in g.items()} for k, g in mesh.tagged.items()}}


def node_coords(model) -> dict:
    """The program's node coordinates of each space, in its node order:
    how its output vectors are labelled."""
    sp = model.fe.spaces
    return {"u": np.array(sp.u_space.dof_coords), "p": np.array(sp.p_space.dof_coords),
            "b": np.array(sp.b_space.dof_coords)}
