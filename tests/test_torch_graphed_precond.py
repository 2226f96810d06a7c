"""The inner_gmres block preconditioner applied in two halves
(``solvers/graphed.py``), on the CPU, where the halves run without
graphs: the same numbers as the preconditioner applied whole, bit for
bit.

  * ``gmres.arnoldi`` + ``gmres.lsq`` against one ``gmres`` cycle from
    zero: a full cycle, an early stop (an operator with three
    eigenvalues) and a zero right-hand side;
  * ``GraphedPrecond(pc, capture=False)`` against ``pc`` on the
    full-physics bowl (the dense saddle-coarse level) and on the
    two-grid with a dense coarse level;
  * steps of a model whose solves take the split application against
    the model's own;
  * which preconditioners the model captures (``PGModel._captures``),
    and when setting ``ops`` makes it capture anew.
"""

import dataclasses
import types

import pytest
import torch

from nupgcm_tpu_torch.models.model import PGModel
from nupgcm_tpu_torch.solvers import graphed
from nupgcm_tpu_torch.solvers.gmres import arnoldi, gmres, lsq

from test_torch_rebuild_refresh import _at_step, _full


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _split(op, b, M, m, rtol=1e-8):
    V, hb = arnoldi(op, b, M, m)
    y, j = lsq(hb.numpy(), m, 0.0, rtol)
    x = torch.zeros_like(b)
    if j:
        x = x + V[:j].T @ torch.as_tensor(y, dtype=b.dtype)
    return x, j


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["full", "early", "zero"])
def test_split_cycle_equals_gmres(case, dtype):
    g = torch.Generator().manual_seed(3)
    n, m = 40, 6
    if case == "early":
        # three distinct eigenvalues: GMRES is exact after three steps
        d = torch.tensor([1.0, 2.0, 5.0], dtype=dtype).repeat_interleave(torch.tensor([10, 15, 15]))
        A = torch.diag(d)
    else:
        A = torch.eye(n, dtype=dtype) * 4 + torch.randn(n, n, generator=g, dtype=dtype) * 0.3
    dinv = 1.0 / (1.0 + torch.rand(n, generator=g, dtype=dtype))
    if case == "early":
        dinv = torch.full_like(dinv, 0.5)
    rtol = 1e-5 if case == "early" else 1e-8
    b = torch.zeros(n, dtype=dtype) if case == "zero" else torch.randn(n, generator=g, dtype=dtype)
    op, M = (lambda v: A @ v), (lambda v: dinv * v)
    x, _ = gmres(op, b, torch.zeros_like(b), M=M, m=m, atol=0.0, rtol=rtol, itmax=m)
    xs, j = _split(op, b, M, m, rtol)
    assert j == {"full": m, "early": 3, "zero": 0}[case]
    assert torch.equal(x, xs)


def _precond(model):
    """The preconditioner the model's solves apply, built when its ``ops``
    was set."""
    return model._inv[1]


_CAPTURES = PGModel._captures


def _cuda_decision(model, M):
    """``model._captures`` as a CUDA model of the same configuration
    decides it (the predicate reads the device from ``model.device``)."""
    return _CAPTURES(types.SimpleNamespace(device=torch.device("cuda")), model.ops, M)


class _Uncaptured(graphed.GraphedPrecond):
    """The split halves run without graphs."""

    def __init__(self, pc):
        super().__init__(pc, capture=False)


def _as_on_cuda(monkeypatch):
    """From here on, CPU models decide capture as CUDA models do, and run
    what they would capture as the split halves without graphs."""
    monkeypatch.setattr(PGModel, "_captures", lambda self, ops, M: _cuda_decision(self, M))
    monkeypatch.setattr(graphed, "GraphedPrecond", _Uncaptured)


@pytest.fixture(scope="module")
def full_model():
    return _full(True)


def _residuals(model, k=3, seed=5):
    g = torch.Generator().manual_seed(seed)
    n = model.fe.spaces.n_u + model.fe.spaces.n_p
    return [torch.randn(n, generator=g, dtype=model.dtype) for _ in range(k)]


def test_split_application_equals_whole(full_model):
    M = _precond(full_model)
    assert _cuda_decision(full_model, M)
    G = graphed.GraphedPrecond(M, capture=False)
    for r in _residuals(full_model):
        assert torch.equal(G(r), M(r))


def test_split_application_with_dense_twogrid():
    m = _full(True, h=0.35, saddle_coarse=False, twogrid=True)
    M = _precond(m)
    assert M.coarse is not None and M.saddle_coarse is None and "coarse_inv" in m.ops
    assert _cuda_decision(m, M)
    G = graphed.GraphedPrecond(M, capture=False)
    for r in _residuals(m, 2):
        assert torch.equal(G(r), M(r))


def test_steps_with_split_application_equal_the_model(monkeypatch):
    """Four steps through the step-10 eddy rebuild, the preconditioner
    rebuilt with it, the solves taking the split application where a CUDA
    model would capture it."""
    plain = _full(True)
    _as_on_cuda(monkeypatch)
    split = _full(True)
    assert isinstance(_precond(split), graphed.GraphedPrecond)
    assert not isinstance(_precond(plain), graphed.GraphedPrecond)
    a = b = _at_step(plain, 8)
    for _ in range(4):
        a, aux_a = plain.step(a)
        b, aux_b = split.step(b)
        assert aux_a["inv_iters"] == aux_b["inv_iters"]
        for f in ("u", "p", "b"):
            assert torch.equal(getattr(a, f), getattr(b, f))
    assert aux_a["inv_iters"] > 0


def test_which_preconditioners_are_captured(full_model):
    """On a CUDA device, inner_gmres with dense levels only: not the
    Chebyshev smoother, nor a reduction hook, nor an iterative coarse
    level, nor the diagonal preconditioner; on the CPU nothing."""
    M = _precond(full_model)
    assert _cuda_decision(full_model, M)
    assert not full_model._captures(full_model.ops, M)
    assert not _cuda_decision(full_model, dataclasses.replace(M, method="chebyshev"))
    assert not _cuda_decision(full_model, dataclasses.replace(M, reduce=lambda v: v))
    iterative = _full(True, h=0.35, coarse_dense_max=64)
    M = _precond(iterative)
    assert M.method == "inner_gmres" and not _cuda_decision(iterative, M)
    diag = _full(True, h=0.35, preconditioner="diag")
    assert not _cuda_decision(diag, _precond(diag))


def _addresses(ops):
    return {k: v.data_ptr() for k, v in ops.items() if torch.is_tensor(v)}


@pytest.mark.parametrize("branch", ["dense", "iterative"])
def test_captured_preconditioner_outlives_rebuilds_and_refreshes(branch, monkeypatch):
    """The eddy rebuild, the preconditioner's rebuild after it and
    ``refresh_precond`` write every tensor of ``ops`` in place, so no
    address in ``ops`` changes on either branch.  On the dense branch the
    key of the captured preconditioner (those addresses and the bounds it
    took on the host) holds through both and through a restore of the
    saved dict, so setting ``ops`` keeps one ``GraphedPrecond``; a tensor
    set anew, or another bound, makes a new one."""
    _as_on_cuda(monkeypatch)
    m = _full(True, h=0.35, **({} if branch == "dense" else dict(coarse_dense_max=64)))
    st = _at_step(m, 5)
    saved, G = dict(m.ops), _precond(m)
    ptrs = _addresses(m.ops)
    for _ in range(5):                      # steps 6-10: a rebuild after step 10
        st, aux = m.step(st)
    assert aux["rebuilt"] == 1.0
    m.ops = m.refresh_precond(m.ops, st)
    assert _addresses(m.ops) == ptrs
    m.ops = dict(saved)
    assert isinstance(G, graphed.GraphedPrecond) == (branch == "dense")
    if branch == "iterative":
        return
    assert _precond(m) is G
    m.ops = dict(m.ops, saddle_coarse_inv=m.ops["saddle_coarse_inv"].clone())
    G2 = _precond(m)
    assert G2 is not G
    m.ops["lmax_p"].mul_(2.0)               # the same tensor, another bound
    m.ops = m.ops
    assert _precond(m) is not G2
