"""The port's domain decomposition (nupgcm_tpu_torch.parallel.dd) on the
CPU, one process holding every shard (no torch.distributed call).

Ports of tests/test_parallel.py's DDModel tests at their configurations
and bars, the sharded step against the single-device step (the port's
PGModel, itself held to nupgcm_tpu's): the step, adaptive dt with
convection, both saddle-coarse branches, bowl3D's halo bound, the
periodic channel. Beyond them: iteration counts that do not change with
S = 1/2/8, the Dirichlet lift with a nonzero boundary value, and the
refusals. The closures, refresh, block-table path and run loop are in
test_torch_dd_closures.py; the parity with nupgcm_tpu's DDModel and the
checkpoint exchange in test_torch_dd_jax.py.
"""

import numpy as np
import pytest
import torch

import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.parallel.dd import DDModel
from torch_dd_cases import (ALPHA, NO_COARSE, TIGHT, bdf2, bic, bowl, bowl015, maxdiff,
                            pair)
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")
MESH_008 = lambda npg: npg.generators.bowl2D(0.08, ALPHA)  # noqa: E731


def test_dd_sharded_state_step_matches_single_device():
    """The full step with sharded state: owned chunks, halo shifts in
    every matvec, summed Krylov reductions; single-device parity to
    machine precision."""
    m1, m2 = pair(MESH_008, bdf2(), NO_COARSE)
    s1 = m1.run(m1.rest_state(), n_info=0, max_steps=3)
    dd = DDModel(m2, 8)
    assert max(dd.part_u.K, dd.part_p.K, dd.part_b.K) <= 2
    s2 = dd.run(m2.rest_state(), n_info=0, max_steps=3)
    for f in ("u", "b", "p"):
        assert maxdiff(s1, s2, f) < 1e-12, f


def test_dd_adaptive_and_convection():
    """Adaptive-CFL BDF2 and the convective Kv rebuilt in-step from each
    shard's cells: the same dt, and the state within 1e-9."""
    conv = npt.ConvectionParameterization(kappa_c=1.0, N2_min=1e-2)
    m1, m2 = pair(lambda npg: npg.generators.bowl2D(0.1, ALPHA),
                   bdf2(5e-2, adaptive=True, CFL_factor=0.4), NO_COARSE,
                   kappa_h=1e-2, kappa_v=1e-2, conv_param=conv)
    s1 = m1.run(m1.set_b(m1.rest_state(), bic), n_info=0, max_steps=3)
    s2 = DDModel(m2, 8).run(m2.set_b(m2.rest_state(), bic), n_info=0, max_steps=3)
    assert abs(float(s1.dt) - float(s2.dt)) < 1e-14
    assert maxdiff(s1, s2, "b") < 1e-9
    assert maxdiff(s1, s2, "u") < 1e-9


@pytest.mark.parametrize("dense", [True, False], ids=["dense_coarse", "iterative_coarse"])
def test_dd_saddle_coarse_iteration_parity(dense):
    """The replicated saddle-coarse correction (dense inverse, or the
    inner cycle over each shard's own coarse cells plus one sum, with
    the aggregate level): the single-device FGMRES count within 1 and
    the state to machine precision."""
    kw = dict(TIGHT, coarse_dense_max=12288 if dense else 1)
    m1, m2 = pair(lambda npg: npg.generators.bowl2D(0.08, ALPHA), bdf2(), kw)
    assert m1.saddle_coarse and m1.saddle_coarse_dense == dense
    st = m1.rest_state()
    for _ in range(2):
        st, aux1 = m1.step(st)
    dd = DDModel(m2, 8)
    assert dd.has_saddle_coarse and ("cd_pg" in dd.tables) != dense
    sv = dd.to_dd(m2.rest_state())
    for _ in range(2):
        sv, aux2 = dd.step(sv)
    s2 = dd.from_dd(sv)
    assert abs(aux1["inv_iters"] - aux2["inv_iters"]) <= 1, (aux1["inv_iters"],
                                                            aux2["inv_iters"])
    assert maxdiff(st, s2, "u") < 1e-12
    assert maxdiff(st, s2, "b") < 1e-12


def test_dd_bowl3d_halo_bound_and_parity():
    """bowl3D: every space's halo at most 2 chunks on 8 shards, and one
    sharded step matches the single-device one."""
    kw = dict(inv_atol=1e-10, inv_rtol=1e-10, evo_atol=1e-12, evo_rtol=1e-12, inv_itmax=400)
    m1, m2 = pair(lambda npg: npg.generators.bowl3D(0.16, ALPHA, nz=5),
                   lambda npg: npg.BDF2(t_start=0, t_stop=1, dt=1e-3), kw)
    st, aux1 = m1.step(m1.rest_state())
    dd = DDModel(m2, 8)
    assert max(dd.part_u.K, dd.part_p.K, dd.part_b.K) <= 2, (
        dd.part_u.K, dd.part_p.K, dd.part_b.K)
    sv, aux2 = dd.step(dd.to_dd(m2.rest_state()))
    s2 = dd.from_dd(sv)
    assert abs(aux1["inv_iters"] - aux2["inv_iters"]) <= 1
    assert maxdiff(st, s2, "u") < 1e-11
    assert maxdiff(st, s2, "b") < 1e-11


def test_dd_periodic_channel3d_parity():
    """A periodic re-entrant channel: slave dofs pinned by the masks,
    the RCM graph with the identification; one sharded step matches."""
    def build(npg):
        m3 = npg.generators.channel3D(0.1)
        params = npg.Parameters(eps=0.3, alpha=1.0, mu_rho=1.0, N2=1.0,
                                f=lambda x: 1.0 + 0 * x[1], H=lambda x: 0.5)
        forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=-0.05, tau_y=0.0,
                            b_surface_bc=npg.SurfaceDirichletBC(0.0))
        spaces = npg.Spaces(m3, u_diri_tags=["bottom", "coastline"],
                            u_diri_vals=[(0, 0, 0)] * 2, u_diri_masks=[(True, True, True)] * 2,
                            b_diri_tags=[], b_diri_vals=[])
        return npg.PGModel(npg.FEData(m3, spaces), params, forc,
                           npg.BDF2(t_start=0, t_stop=1, dt=1e-2), dtype=torch.float64,
                           device="cpu", inv_atol=1e-10, inv_rtol=1e-10, evo_atol=1e-12,
                           evo_rtol=1e-12, inv_itmax=600)

    m1, m2 = build(npt), build(npt)
    st, aux1 = m1.step(m1.rest_state())
    dd = DDModel(m2, 8)
    sv, aux2 = dd.step(dd.to_dd(m2.rest_state()))
    s2 = dd.from_dd(sv)
    assert abs(aux1["inv_iters"] - aux2["inv_iters"]) <= 1
    assert maxdiff(st, s2, "u") < 1e-11
    assert maxdiff(st, s2, "b") < 1e-11


def test_dd_iterations_do_not_change_with_shard_count():
    """The replicated coarse level keeps the outer iteration count at
    the single-device level whatever S (the invariant of the JAX
    package's DD bench): S = 1, 2 and 8 take the same CG and FGMRES
    counts in every step, at the default tolerances."""
    mesh = npt.generators.bowl3D(0.2, ALPHA, nz=4)
    counts = {}
    for S in (1, 2, 8):
        m = bowl(npt, mesh, bdf2(), {})
        dd = DDModel(m, S)
        _, auxs = dd.multi_step(dd.to_dd(m.set_b(m.rest_state(), bic)), 3)
        counts[S] = (auxs["evo_iters"].tolist(), auxs["inv_iters"].tolist())
    assert counts[1] == counts[2] == counts[8], counts
    assert min(counts[8][1]) > 0


def test_dd_dirichlet_lift_with_nonzero_surface_value():
    """A nonzero surface buoyancy: the DD step lifts the Dirichlet
    values with the unmasked operator, as the single-device step does
    (the JAX DD step applies its masked operator and drops the lift)."""
    m1, m2 = pair(lambda npg: npg.generators.bowl2D(0.15, ALPHA), bdf2(), TIGHT,
                   b_surface=0.1)
    s1 = m1.run(m1.set_b(m1.rest_state(), bic), n_info=0, max_steps=3)
    s2 = DDModel(m2, 8).run(m2.set_b(m2.rest_state(), bic), n_info=0, max_steps=3)
    assert float(np.abs(np.asarray(s1.b)).max()) >= 0.1
    for f in ("u", "b", "p"):
        assert maxdiff(s1, s2, f) < 1e-12, f


def test_dd_refusals():
    """The u-block two-grid and a group of another shard count raise."""
    m = bowl015(npt, saddle_coarse=False, twogrid=True)
    with pytest.raises(NotImplementedError):
        DDModel(m, 2)
    from nupgcm_tpu_torch.parallel.comm import ShardGroup
    with pytest.raises(ValueError, match="n_shards"):
        DDModel(bowl015(npt), 4, ShardGroup(8))
