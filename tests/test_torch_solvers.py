"""Krylov solvers and smoothers of the PyTorch port against the JAX
package's, in f64, on small dense operators made with
numpy.random.default_rng: the same iteration counts and solutions
within 1e-10 relative (the loops do the same arithmetic; only the
summation order of the dot products differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nupgcm_tpu.solvers import cg as cg_j
from nupgcm_tpu.solvers import gmres as gmres_j
from nupgcm_tpu.solvers import preconditioners as pre_j
from nupgcm_tpu_torch.solvers import cg as cg_t
from nupgcm_tpu_torch.solvers import gmres as gmres_t
from nupgcm_tpu_torch.solvers import preconditioners as pre_t

N = 80


def _spd(rng):
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    return (Q * np.geomspace(1.0, 1e2, N)) @ Q.T


def _nonsym(rng):
    return np.diag(rng.uniform(1.0, 10.0, N)) + rng.standard_normal((N, N)) / np.sqrt(N)


def _both(A):
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    return (lambda x: Aj @ x), (lambda x: At @ x)


def _close(xt, xj, bar=1e-10):
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= bar * np.abs(xj).max()


@pytest.mark.parametrize("precond", [False, True])
def test_cg_matches(precond):
    rng = np.random.default_rng(0)
    A = _spd(rng)
    b = rng.standard_normal(N)
    opj, opt = _both(A)
    dinv = 1.0 / np.diag(A) if precond else None
    kw = dict(atol=0.0, rtol=1e-9, itmax=0)
    xj, sj = cg_j.cg(opj, jnp.asarray(b), jnp.zeros(N),
                     M_diag_inv=None if dinv is None else jnp.asarray(dinv), **kw)
    xt, st = cg_t.cg(opt, torch.from_numpy(b), torch.zeros(N, dtype=torch.float64),
                     M_diag_inv=None if dinv is None else torch.from_numpy(dinv), **kw)
    assert st.iterations == int(sj.iterations) > 1
    assert st.converged and bool(sj.converged)
    _close(xt, xj)


@pytest.mark.parametrize("flexible", [False, True])
@pytest.mark.parametrize("m", [8, 40])
def test_gmres_matches(flexible, m):
    """Restarted (m = 8, several cycles) and unrestarted; left-
    preconditioned GMRES and flexible (right-preconditioned) FGMRES."""
    rng = np.random.default_rng(1)
    A = _nonsym(rng)
    b = rng.standard_normal(N)
    x0 = rng.standard_normal(N)
    opj, opt = _both(A)
    dinv = 1.0 / np.abs(np.diag(A))
    kw = dict(m=m, atol=1e-12, rtol=1e-10, itmax=400, flexible=flexible)
    xj, sj = gmres_j.gmres(opj, jnp.asarray(b), jnp.asarray(x0),
                           M=lambda r: jnp.asarray(dinv) * r, **kw)
    xt, st = gmres_t.gmres(opt, torch.from_numpy(b), torch.from_numpy(x0),
                           M=lambda r: torch.from_numpy(dinv) * r, **kw)
    assert st.iterations == int(sj.iterations) > 8  # m = 8 restarts
    assert st.converged and bool(sj.converged)
    assert st.residual == pytest.approx(float(sj.residual), rel=1e-6)
    _close(xt, xj)


def test_chebyshev_and_power_lmax_match():
    rng = np.random.default_rng(2)
    A = _spd(rng)
    r = rng.standard_normal(N)
    opj, opt = _both(A)
    dinv = 1.0 / np.diag(A)
    lj = pre_j.power_lmax(opj, jnp.asarray(dinv), N)
    lt = pre_t.power_lmax(opt, torch.from_numpy(dinv), N)
    assert float(lt) == pytest.approx(float(lj), rel=1e-12)
    lmax = float(lj)
    zj = pre_j.chebyshev(opj, jnp.asarray(dinv), jnp.asarray(r), 8, lmax / 30, lmax)
    zt = pre_t.chebyshev(opt, torch.from_numpy(dinv), torch.from_numpy(r), 8, lmax / 30, lmax)
    _close(zt, zj, 1e-12)


def test_jacobi_and_const_diag_match():
    rng = np.random.default_rng(3)
    d, r = rng.uniform(1.0, 2.0, N), rng.standard_normal(N)
    _close(pre_t.jacobi(torch.from_numpy(d))(torch.from_numpy(r)),
           pre_j.jacobi(jnp.asarray(d))(jnp.asarray(r)), 1e-15)
    _close(pre_t.const_diag(3.0)(torch.from_numpy(r)),
           pre_j.const_diag(3.0)(jnp.asarray(r)), 1e-15)


def test_coarse_correction_and_two_grid_block_match():
    """CoarseCorrection (restriction by index_add_ where JAX uses
    segment_sum, a coarse solve, prolongation) and the block
    preconditioner's two-grid V-cycle on the velocity block, on random
    SPD operators with random parents and weights."""
    rng = np.random.default_rng(4)
    nn, nv = 10, 4  # fine nodes, coarse vertices (3 dofs each)
    A, Ac = _spd(rng)[: 3 * nn, : 3 * nn], _spd(rng)[: 3 * nv, : 3 * nv]
    parents = rng.integers(0, nv, (nn, 2))
    weights = np.where(rng.random((nn, 1)) < 0.5, [1.0, 0.0], [0.5, 0.5])
    cfree = (rng.random(3 * nv) < 0.8).astype(np.float64)
    ffree = (rng.random(3 * nn) < 0.8).astype(np.float64)
    Acinv = np.linalg.inv(Ac)
    r, z = rng.standard_normal(3 * nn), rng.standard_normal(3 * nn)
    opj, opt = _both(A)
    Cj = pre_j.CoarseCorrection(solve=lambda rc: jnp.asarray(Acinv) @ rc,
                                parents=jnp.asarray(parents), weights=jnp.asarray(weights),
                                coarse_free=jnp.asarray(cfree), free_u=jnp.asarray(ffree),
                                n_vert=nv)
    Ct = pre_t.CoarseCorrection(solve=lambda rc: torch.from_numpy(Acinv) @ rc,
                                parents=torch.from_numpy(parents),
                                weights=torch.from_numpy(weights),
                                coarse_free=torch.from_numpy(cfree),
                                free_u=torch.from_numpy(ffree), n_vert=nv)
    _close(Ct(opt, torch.from_numpy(r), torch.from_numpy(z)),
           Cj(opj, jnp.asarray(r), jnp.asarray(z)), 1e-13)
    dinv = 1.0 / np.diag(A)
    lmax = float(pre_j.power_lmax(opj, jnp.asarray(dinv), 3 * nn))
    Mp = np.eye(3)
    common = dict(nu_dofs=3 * nn, inner_iters_u=4, inner_iters_p=3, lmax_u=lmax,
                  lmax_p=1.1, cond_ratio=20.0)
    Mj = pre_j.BlockStokesPrecond(visc_op=opj, visc_diag_inv=jnp.asarray(dinv),
                                  mp_op=lambda x: jnp.asarray(Mp) @ x,
                                  mp_diag_inv=jnp.ones(3), coarse=Cj, **common)
    Mt = pre_t.BlockStokesPrecond(visc_op=opt, visc_diag_inv=torch.from_numpy(dinv),
                                  mp_op=lambda x: torch.from_numpy(Mp) @ x,
                                  mp_diag_inv=torch.ones(3, dtype=torch.float64),
                                  coarse=Ct, **common)
    rr = rng.standard_normal(3 * nn + 3)
    _close(Mt(torch.from_numpy(rr)), Mj(jnp.asarray(rr)), 1e-12)
