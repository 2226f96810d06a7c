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
