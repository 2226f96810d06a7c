"""The benchmark's own tests: ``python -m pytest pgbench/tests`` from the
root of the checkout (CPU, a few minutes).  Tests marked ``chip`` need a
CUDA device and skip without one; run them on the card with
``python -m pytest pgbench/tests -m chip``."""

import os

import pytest

# one thread a test process, as a benchmark run has: several test
# processes share the host's cores
os.environ.setdefault("OMP_NUM_THREADS", "1")


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
