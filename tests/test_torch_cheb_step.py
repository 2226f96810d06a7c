"""The Chebyshev smoother's fused step (``ops/kernels.ChebStep``,
``csrc/chebyshev_step.cu``) on the CPU, where the wrapper takes its
plain versions.

``chebyshev`` through it equals the unfused loop it replaced bit for
bit, with a masked and an unmasked operator, in f32 and f64, for 1 to 5
steps, from a residual at the start of its storage and from an offset
view, and never writes that residual; a model's step is the same bits
with the unfused loop in its place; ``cheb.plain`` counts one per step
of a call and ``cheb.fused`` none.  The kernel itself is held to the
plain versions on the card by ``chip_smoke.py`` (``check_cheb``).
"""

import pytest
import torch

from nupgcm_tpu_torch import generators
from nupgcm_tpu_torch.ops import kernels as K
from nupgcm_tpu_torch.ops.sparse import MaskedOperator
from nupgcm_tpu_torch.solvers import preconditioners as pc
from nupgcm_tpu_torch.tools._common import initial_b, mixing_setup
from nupgcm_tpu_torch.utils import timing

N = 37


def unfused(op, dinv, r, k, lmin, lmax):
    """The smoother as it was written before its updates were fused."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    d = (1.0 / theta) * (dinv * r)
    z = d
    for _ in range(k - 1):
        r = r - op(d)
        rho1 = 1.0 / (2.0 * sigma1 - rho)
        d = rho1 * rho * d + (2.0 * rho1 / delta) * (dinv * r)
        z = z + d
        rho = rho1
    return z


class _Dense:
    def __init__(self, A):
        self.A = A

    def matvec(self, x):
        return self.A @ x

    def diagonal(self):
        return torch.diagonal(self.A).clone()


def _operator(masked: bool, dtype):
    """An SPD operator (a MaskedOperator with pinned rows, or a plain
    callable as DD passes), its inverse diagonal and its bounds."""
    g = torch.Generator().manual_seed(5)
    B = torch.randn(N, N, generator=g, dtype=torch.float64)
    A = (B @ B.T / N + torch.eye(N, dtype=torch.float64)).to(dtype)
    if masked:
        free = (torch.arange(N) % 5 != 2).to(dtype)
        op = MaskedOperator(_Dense(A), free)
        dinv = 1.0 / op.diagonal()
    else:
        op = lambda x: A @ x  # noqa: E731
        dinv = 1.0 / torch.diagonal(A)
    lmax = float(pc.power_lmax(op, dinv, N))
    return op, dinv, lmax / 30.0, lmax


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_chebyshev_equals_the_unfused_loop_bit_for_bit(masked, dtype, k, offset):
    op, dinv, lmin, lmax = _operator(masked, dtype)
    g = torch.Generator().manual_seed(k)
    whole = torch.randn(N + offset, generator=g, dtype=torch.float64).to(dtype)
    kept = whole.clone()
    r = whole[offset:]  # the residual as a view, as the block smoothers pass it
    K.reset_counts()
    z = pc.chebyshev(op, dinv, r, k, lmin, lmax)
    assert torch.equal(z, unfused(op, dinv, r, k, lmin, lmax))
    assert torch.equal(whole, kept)  # r was never written
    assert K.plain_calls["cheb_step"] == k and K.launches["cheb_step"] == 0


def test_the_counters_count_each_step_of_a_call():
    op, dinv, lmin, lmax = _operator(True, torch.float64)
    r = torch.ones(N, dtype=torch.float64)
    timing.reset()
    timing.set_timing(True)
    try:
        pc.chebyshev(op, dinv, r, 4, lmin, lmax)
        pc.chebyshev(op, dinv, r, 2, lmin, lmax)
        counts = timing.snapshot()["counts"]
    finally:
        timing.set_timing(False)
        timing.reset()
    assert counts["cheb.plain"] == 6 and "cheb.fused" not in counts


def test_the_wrapper_raises_on_a_device_without_the_kernel():
    r = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        K.ChebStep(r, r, None, 1.0)


def test_a_step_of_the_aggregate_branch_is_the_same_bits_as_unfused(monkeypatch):
    """The 0.87M bowl's branch on a tiny bowl: every smoothing step of the
    fine and the coarse block goes through the wrappers (5 + 2 fine, 3 + 3
    coarse per application), and the step equals one with the unfused
    loop in place of ``chebyshev``."""
    mesh = generators.bowl3D(0.25, 0.5, nz=3)
    model = mixing_setup(mesh, "cpu", torch.float64, coarse_dense_max=256)
    assert model.inner_method == "chebyshev" and "sc2_inv" in model.ops
    st = model.set_b(model.rest_state(), initial_b)
    timing.reset()
    timing.set_timing(True)
    try:
        fused, aux = model.step(st)
        snap = timing.snapshot()
    finally:
        timing.set_timing(False)
        timing.reset()
    iu, ip = model.inner_iters
    spans = snap["spans"]
    assert snap["counts"]["cheb.plain"] == (spans["fgmres.precond"]["n"] * (iu + ip)
                                            + spans["precond.coarse_block"]["n"] * (3 + 3))
    monkeypatch.setattr(pc, "chebyshev", unfused)
    plain, aux_plain = model.step(st)
    assert aux == aux_plain
    assert all(torch.equal(getattr(fused, f), getattr(plain, f)) for f in ("u", "p", "b"))
