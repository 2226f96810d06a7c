"""Shared set-up of the parity tests that run ``nupgcm_tpu`` and
``nupgcm_tpu_torch`` side by side (imported by tests/test_torch_*.py).

Both packages number their dofs by reverse Cuthill-McKee, through
``native/libmeshkit.so`` when it loads and through SciPy otherwise; the
two orderings differ.  The library is built on first use, and parallel
test workers used to build it over each other: a worker that met a
half-written file fell back to SciPy in one package and loaded the
finished library in the other, and every parity test in that worker
then compared two different dof layouts.  Importing this module builds
the library through the port's locked, atomic build, at collection, so
each worker finds it complete before any test runs;
``assert_same_rcm_branch`` makes a split fail loudly.

``one_thread`` runs a test on one intra-op thread: the domain
decomposition tests make many small tensor operations, which one
thread runs as fast, and the suite's parallel workers (and the gloo
processes those tests spawn) then do not oversubscribe the cores.
"""

import pytest
import torch

from nupgcm_tpu_torch.mesh import native as _native_t

_native_t.load()


def assert_same_rcm_branch():
    """Both packages took the same RCM branch in this process."""
    from nupgcm_tpu.mesh import native as native_j

    t, j = _native_t.load() is not None, native_j.load() is not None
    assert t == j, (f"native RCM loaded in nupgcm_tpu_torch: {t}, in nupgcm_tpu: {j}; "
                    "their dof layouts differ")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
