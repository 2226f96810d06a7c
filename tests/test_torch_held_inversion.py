"""The inversion's operators and preconditioner are built when ``ops`` is
set (and by ``retune``), not by a solve, on the CPU: over three steps on
each preconditioner branch the model never calls ``_make_inv_precond``
and applies the one preconditioner it holds; ``retune`` replaces it, and
the next step equals that of a model built with the new budget.
"""

import pytest
import torch

from nupgcm_tpu_torch import generators
from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup

from test_torch_rebuild_refresh import _full

BRANCHES = {
    # the 0.87M bowl's: Chebyshev smoothing, the iterative saddle coarse
    # level with the aggregate level, applied once (k = 0)
    "aggregate": lambda **kw: mixing_setup(generators.bowl3D(0.35, 0.5, nz=3), "cpu",
                                           torch.float64, coarse_dense_max=256, **kw),
    # the full-physics bowl's: inner GMRES, the dense saddle coarse level
    "dense_inner_gmres": lambda **kw: _full(True, h=0.35, **kw),
    "twogrid": lambda **kw: mixing_setup(generators.bowl3D(0.35, 0.5, nz=3), "cpu",
                                         torch.float64, saddle_coarse=False, twogrid=True, **kw),
    "diag": lambda **kw: mixing_setup(generators.bowl3D(0.35, 0.5, nz=3), "cpu",
                                      torch.float64, preconditioner="diag", inv_itmax=300, **kw),
}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_the_inversion_is_built_when_ops_is_set_not_per_solve(branch, monkeypatch):
    m = BRANCHES[branch]()
    st = m.set_b(m.rest_state(), initial_b)
    builds = []
    make = m._make_inv_precond
    monkeypatch.setattr(m, "_make_inv_precond", lambda *a, **k: builds.append(1) or make(*a, **k))
    held = m._inv
    for _ in range(3):
        st, aux = m.step(st)
    assert aux["inv_iters"] > 0
    assert not builds and m._inv is held
    ip = m.inner_iters[1] + 2
    assert m.retune(inner_iters_p=ip) is m
    assert builds == [1] and m._inv[1] is not held[1]
    fresh = BRANCHES[branch](inner_iters_p=ip)
    a, aux_a = m.step(st)
    b, aux_b = fresh.step(st)
    assert aux_a["inv_iters"] == aux_b["inv_iters"]
    for f in ("u", "p", "b"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
