"""The port's scoped matmul-precision policy (nupgcm_tpu_torch/utils/precision.py).

``PGModel(matmul_precision="float32")`` (the default) and ``DDModel``
over it hold float32 products at full precision inside the build and
every entry point, whatever TF32 setting the caller's process holds,
and restore the caller's setting on return, also after an exception.
``None`` leaves the process's setting in force.  The flags are
process-global, so they are read inside the model's calls through
probes, and every test restores the session's flags.
"""

import dataclasses

import numpy as np
import pytest
import torch

import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import PGModel
from nupgcm_tpu_torch.parallel.dd import DDModel
from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup
from nupgcm_tpu_torch.utils import precision as P

FULL = (False, False, "highest")  # (matmul TF32, cudnn TF32, float32 matmul precision)
ENTRY_POINTS = ("step", "multi_step", "run", "invert", "solve_inversion",
                "refresh_precond", "retune")
DD_ENTRY_POINTS = ("step", "multi_step", "refresh_precond", "run")


def flags():
    return P._read()


def set_caller(kind):
    """A caller's process setting: PyTorch's default, TF32 as a user
    script turns it on, or bfloat16 products."""
    if kind == "default":
        P._write(False, True, "highest")
    elif kind == "tf32":
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
    else:
        torch.set_float32_matmul_precision("medium")
    return flags()


@pytest.fixture(autouse=True)
def restore_flags():
    saved = flags()
    yield
    P._write(*saved)


@pytest.fixture(scope="module")
def tiny():
    """A small bowl on the iterative saddle-coarse + aggregate branch."""
    return mixing_setup(npt.generators.bowl3D(0.4, 0.5, nz=2), "cpu", torch.float64,
                        coarse_dense_max=64)


@pytest.mark.parametrize("caller", ["default", "tf32", "medium"])
def test_precision_ctx_holds_full_float32_and_restores(caller):
    before = set_caller(caller)
    with P.precision_ctx("float32"):
        assert flags() == FULL
        with P.precision_ctx("float32"):  # nested entry points
            assert flags() == FULL
        assert flags() == FULL
    assert flags() == before


def test_precision_ctx_restores_after_an_exception():
    before = set_caller("tf32")
    with pytest.raises(ZeroDivisionError):
        with P.precision_ctx("float32"):
            1 / 0
    assert flags() == before
    fn = P.scoped_precision(lambda: 1 / 0, "float32")
    with pytest.raises(ZeroDivisionError):
        fn()
    assert flags() == before


def test_none_leaves_the_process_setting_alone():
    before = set_caller("tf32")
    with P.precision_ctx(None):
        assert flags() == before
    fn = lambda: flags()
    assert P.scoped_precision(fn, None) is fn
    assert P.scoped_precision(fn, "float32")() == FULL
    assert flags() == before
    with pytest.raises(ValueError, match="matmul precision"):
        with P.precision_ctx("bfloat16"):
            pass


@pytest.mark.parametrize("cls, names", [(PGModel, ENTRY_POINTS), (DDModel, DD_ENTRY_POINTS)])
def test_every_entry_point_is_scoped(cls, names):
    for name in names:
        fn = getattr(cls, name)
        assert fn.__code__ is P.scoped_method(lambda self: None).__code__, name
        assert fn.__wrapped__.__name__ == name


def _probe(model, method, seen, exc=None):
    """Record the flags whenever ``model.method`` runs (then raise
    ``exc`` if given)."""
    orig = getattr(model, method)

    def probe(*a, **k):
        seen.append(flags())
        if exc is not None:
            raise exc
        return orig(*a, **k)

    setattr(model, method, probe)


@pytest.mark.parametrize("policy", ["float32", None])
def test_model_entry_points_under_a_tf32_caller(tiny, policy):
    """step, multi_step, run, invert and solve_inversion reach the
    saddle solve; refresh_precond (eddy closure on) the eddy rebuild."""
    m = tiny
    before = set_caller("tf32")
    m.matmul_precision = policy
    forcings, seen = m.forcings, []
    try:
        _probe(m, "_solve_saddle", seen)
        st = m.invert(m.set_b(m.rest_state(), initial_b))
        st, _ = m.step(st)
        st, _ = m.multi_step(st, 1)
        m.run(st, n_info=0, max_steps=st.step + 1)
        m.solve_inversion(m.ops["s"])
        _probe(m, "_eddy_rebuild", seen, exc=LookupError("probe"))
        m.forcings = dataclasses.replace(
            forcings, eddy_param=dataclasses.replace(forcings.eddy_param, is_on=True))
        with pytest.raises(LookupError, match="probe"):
            m.refresh_precond(m.ops, st)
    finally:
        for k in ("_solve_saddle", "_eddy_rebuild"):
            m.__dict__.pop(k, None)
        m.forcings, m.matmul_precision = forcings, "float32"
    assert len(seen) == 6
    assert all(s == (FULL if policy else before) for s in seen), seen
    assert flags() == before


def test_model_restores_the_caller_after_an_exception(tiny):
    before = set_caller("tf32")
    seen = []
    _probe(tiny, "_invert_pure", seen, exc=RuntimeError("probe"))
    try:
        with pytest.raises(RuntimeError, match="probe"):
            tiny.step(tiny.rest_state())
    finally:
        del tiny._invert_pure
    assert seen == [FULL] and flags() == before


def test_retune_runs_under_the_policy(tiny):
    before = set_caller("tf32")

    class Opts(dict):
        def __setitem__(self, k, v):
            seen.append(flags())
            super().__setitem__(k, v)

    seen, opts = [], tiny.inv_opts
    tiny.inv_opts = Opts(opts)
    try:
        tiny.retune(inv_rtol=opts["rtol"])
    finally:
        tiny.inv_opts = opts
    assert seen == [FULL] and flags() == before


@pytest.mark.parametrize("policy", ["float32", None])
def test_build_runs_under_the_policy(monkeypatch, policy):
    before = set_caller("tf32")
    seen = []
    orig = PGModel._build_operators

    def probe(self):
        seen.append(flags())
        return orig(self)

    monkeypatch.setattr(PGModel, "_build_operators", probe)
    m = mixing_setup(npt.generators.bowl2D(0.4, 0.5), "cpu", torch.float64,
                     matmul_precision=policy)
    assert m.matmul_precision == policy
    assert seen == [FULL if policy else before] and flags() == before


def test_dd_model_entry_points_under_a_tf32_caller(tiny):
    before = set_caller("tf32")
    seen = []
    dd = DDModel(tiny, 2)
    assert dd.matmul_precision == "float32" and flags() == before
    _probe(dd.group, "shifts", seen)
    sv = dd.to_dd(tiny.set_b(tiny.rest_state(), initial_b))
    sv, _ = dd.step(sv)
    n = len(seen)
    dd.multi_step(sv, 1)
    assert n > 0 and len(seen) > n
    assert all(s == FULL for s in seen) and flags() == before
    tiny.matmul_precision = None
    try:
        seen.clear()
        dd.step(sv)
        assert seen and all(s == before for s in seen)
    finally:
        tiny.matmul_precision = "float32"


def test_full_float32_products_agree_with_float64():
    """Inside the scope a float32 product keeps float32's rounding (on
    a card TF32 would cost three decimal digits; the CPU never uses
    it, so this holds either way)."""
    set_caller("tf32")
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.standard_normal((64, 64)), dtype=torch.float32)
            for _ in range(2))
    with P.precision_ctx("float32"):
        y = torch.einsum("ij,jk->ik", a, b)
    ref = a.double() @ b.double()
    assert float((y.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
