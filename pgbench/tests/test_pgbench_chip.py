"""On the card, at a size a test run holds: a sound run of each cell's
configuration is correct, and its control (the program with TF32 on, the
precision below the float32 the configurations state) is not.  Run with
``python -m pytest pgbench/tests -m chip`` on a machine with a card."""

import io
import json

import pytest

from pgbench import run as runmod
from pgbench.tests.small import small

SIZES = {"bowl870k-spinup": (0.08, 9), "bowl870k-northstar-settled": (0.08, 9)}


def _run(cell, control, seed):
    h, nz = SIZES[cell]
    cfg, tr = small(cell, h=h, nz=nz)
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "2", "--trace", "0"]
    out = io.StringIO()
    assert runmod.run(runmod.parse(argv + (["--control", control] if control else [])),
                      cfg=cfg, traffic=tr, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct_on_the_card(card, cell):
    res = _run(cell, None, 2**31 + 17)
    assert res["correct"] is True, res["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_tf32_control_is_not_correct(card, cell, seed):
    import torch

    try:
        res = _run(cell, "tf32", seed)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    assert res["correct"] is False, res["checks"]
