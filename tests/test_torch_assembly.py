"""Element tensors and scatter plans of the PyTorch port
(nupgcm_tpu_torch/fem/assembly.py) against the JAX package's, in f64.

Inputs are the real quadrature and gradient tables of a small bowl3D
mesh plus random coefficient and state fields from
numpy.random.default_rng; the two packages get the same numpy arrays.
Bar: 1e-12 relative to the largest entry (einsum contraction order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import nupgcm_tpu as npj
from nupgcm_tpu.fem import assembly as aj
from nupgcm_tpu_torch.fem import assembly as at


@pytest.fixture(scope="module")
def tables():
    mesh = npj.generators.bowl3D(0.35, 0.5, nz=3)
    spaces = npj.Spaces(mesh, u_diri_tags=[], u_diri_vals=[],
                        b_diri_tags=[], b_diri_vals=[])
    fe = npj.FEData(mesh, spaces)
    rng = np.random.default_rng(0)
    nc, nq = fe.geom.wq.shape
    nlu, nlb = fe.cd_u.shape[1], fe.cd_b.shape[1]
    G3 = np.array(aj.physical_grads(fe.geom.invJT, fe.tab_b.dphi, fe.embed))
    surf = fe.surface
    nf, nqf = surf.geom.wq.shape
    return dict(
        fe=fe, wq=fe.geom.wq, phi_u=fe.tab_u.phi, phi_p=fe.tab_p.phi,
        phi_b=fe.tab_b.phi, G3=G3, Gu3=np.array(aj.physical_grads(
            fe.geom.invJT, fe.tab_u.dphi, fe.embed)),
        k_q=rng.uniform(0.5, 2.0, (nc, nq)), f_q=rng.uniform(0.5, 1.5, (nc, nq)),
        u_e=rng.standard_normal((nc, nlu, 3)), up_e=rng.standard_normal((nc, nlu, 3)),
        b_e=rng.standard_normal((nc, nlb)), bp_e=rng.standard_normal((nc, nlb)),
        wq_f=surf.geom.wq, phi_uf=surf.phi_u, phi_bf=surf.phi_b,
        tx_q=rng.standard_normal((nf, nqf)), ty_q=rng.standard_normal((nf, nqf)),
    )


def _call(mod, name, args):
    if mod is aj:
        conv = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    else:
        conv = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    out = getattr(mod, name)(*[conv(a) for a in args])
    return out if isinstance(out, tuple) else (out,)


CASES = {  # case -> (function, arguments)
    "physical_grads": ("physical_grads", lambda t: (
        t["fe"].geom.invJT, t["fe"].tab_b.dphi, t["fe"].embed)),
    "elem_mass": ("elem_mass", lambda t: (t["wq"], t["phi_b"], t["phi_b"])),
    "elem_weighted_mass": ("elem_weighted_mass", lambda t: (
        t["wq"], t["k_q"], t["phi_u"], t["phi_b"])),
    "elem_stiffness_h": ("elem_stiffness", lambda t: (t["wq"], t["k_q"], t["G3"], (0, 1))),
    "elem_stiffness_v": ("elem_stiffness", lambda t: (t["wq"], t["k_q"], t["G3"], (2,))),
    "elem_rhs_diff": ("elem_rhs_diff", lambda t: (t["wq"], t["k_q"], t["G3"], 2.0)),
    "elem_inversion_blocks": ("elem_inversion_blocks", lambda t: (
        t["wq"], t["k_q"], t["f_q"], t["phi_u"], t["Gu3"], t["phi_p"], 0.01, False)),
    "elem_inversion_blocks_variable_nu": ("elem_inversion_blocks", lambda t: (
        t["wq"], t["k_q"], t["f_q"], t["phi_u"], t["Gu3"], t["phi_p"], 0.01, True)),
    "elem_buoyancy_to_velocity": ("elem_buoyancy_to_velocity", lambda t: (
        t["wq"], t["phi_u"], t["phi_b"], 2.0)),
    "elem_wind_rhs": ("elem_wind_rhs", lambda t: (
        t["wq_f"], t["tx_q"], t["ty_q"], t["phi_uf"], 0.5)),
    "elem_flux_rhs": ("elem_flux_rhs", lambda t: (t["wq_f"], t["tx_q"], t["phi_bf"], 0.5)),
    "elem_advection_bdf1": ("elem_advection_bdf1", lambda t: (
        t["wq"], t["phi_b"], t["G3"], t["phi_u"], t["u_e"], t["b_e"], 2.0, 0.1)),
    "elem_advection_bdf2": ("elem_advection_bdf2", lambda t: (
        t["wq"], t["phi_b"], t["G3"], t["phi_u"], t["u_e"], t["up_e"], t["b_e"],
        t["bp_e"], 2.0, 0.1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_element_tensors_match(tables, case):
    name, argfn = CASES[case]
    args = argfn(tables)
    outs_j = _call(aj, name, args)
    outs_t = _call(at, name, args)
    assert len(outs_j) == len(outs_t)
    for oj, ot in zip(outs_j, outs_t):
        oj, ot = np.asarray(oj), ot.numpy()
        assert oj.shape == ot.shape
        assert np.abs(oj - ot).max() <= 1e-12 * np.abs(oj).max()


@pytest.mark.parametrize("plan", ["vec_plan_b", "vec_plan_p", "vec_plan_u_nodes"])
def test_vector_plan_assembles_match(tables, plan):
    """VectorPlan.assemble / assemble_rows (segment sum vs index_add_)."""
    fe = tables["fe"]
    pj = getattr(fe, plan)
    cd = {"vec_plan_b": fe.cd_b, "vec_plan_p": fe.cd_p, "vec_plan_u_nodes": fe.cd_u}[plan]
    pt = at.build_vector_plan(cd, pj.ndof)
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(cd.shape)
    yj = np.asarray(pj.assemble(jnp.asarray(vals)))
    yt = pt.assemble(torch.from_numpy(vals)).numpy()
    assert np.abs(yj - yt).max() <= 1e-12 * np.abs(yj).max()
    rows = rng.standard_normal((cd.size, 3))
    rj = np.asarray(pj.assemble_rows(jnp.asarray(rows)))
    rt = pt.assemble_rows(torch.from_numpy(rows)).numpy()
    assert rj.shape == rt.shape
    assert np.abs(rj - rt).max() <= 1e-12 * np.abs(rj).max()
