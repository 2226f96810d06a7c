"""``tools.eigen`` of the port against ``nupgcm_tpu.tools.eigen``, in
f64 on the CPU, on the bowl3D(0.35, nz=2) mixing configuration with the
JAX model's element tensors: the leading eigenvalues of the evolution
operator, the saddle inversion operator and the block-Stokes
preconditioned inversion operator agree within 1e-8 relative.  ARPACK
starts each package's run from the same vector (its own default start
is a random vector that differs from call to call), so both see the
same Krylov sequence up to rounding.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import nupgcm_tpu as npj
import nupgcm_tpu_torch as npt
from nupgcm_tpu.tools import eigen as EJ
from nupgcm_tpu_torch.models.model import ops_from_numpy
from nupgcm_tpu_torch.tools import eigen as ET
from test_torch_model import _mixing
from torch_parity import assert_same_rcm_branch


@pytest.fixture(scope="module")
def pair():
    assert_same_rcm_branch()
    mj = _mixing(npj, npj.generators.bowl3D(0.35, 0.5, nz=2), 0.05)
    mt = _mixing(npt, npt.generators.bowl3D(0.35, 0.5, nz=2), 0.05,
                 dtype=torch.float64, device="cpu")
    mt.ops = ops_from_numpy({k: np.asarray(v) for k, v in mj.ops.items()}, "cpu")
    return mj, mt


@pytest.fixture
def fixed_start(monkeypatch):
    """ARPACK from one start vector per operator size."""
    for name in ("eigs", "eigsh"):
        fn = getattr(spla, name)

        def with_v0(A, *a, _fn=fn, **kw):
            kw.setdefault("v0", np.cos(np.arange(A.shape[0]) * 0.7) + 1.5)
            return _fn(A, *a, **kw)

        monkeypatch.setattr(spla, name, with_v0)


SPECTRA = ("evolution_spectrum", "inversion_spectrum", "preconditioned_inversion_spectrum")


@pytest.mark.parametrize("name", SPECTRA)
def test_spectrum_matches_jax(pair, fixed_start, name):
    mj, mt = pair
    ET.matvec_count = 0
    vt = getattr(ET, name)(mt, k=6)
    assert ET.matvec_count > 6
    vj = getattr(EJ, name)(mj, k=6)
    assert vt.shape == vj.shape == (6,)
    assert np.all(np.isfinite(vt))
    assert np.abs(vt - vj).max() <= 1e-8 * np.abs(vj).max(), (vj, vt)
    if name == "evolution_spectrum":
        assert vt.dtype == np.float64 and (vt > 0).all()  # SPD


def test_linop_runs_on_the_model_device(pair):
    _, mt = pair
    n = mt.fe.spaces.n_b
    A = ET._as_linop(mt, lambda x: 2.0 * x, n)
    v = np.arange(n, dtype=np.float64)
    y = A.matvec(v)
    assert y.dtype == np.float64 and np.array_equal(y, 2.0 * v)
