"""The port's examples (``nupgcm_tpu_torch.examples``) at tiny sizes
with ``--device cpu``: each runs through ``main(argv)`` and writes the
JAX examples' output files; without ``--device`` they ask for the card
and raise here."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from nupgcm_tpu_torch.examples import bowl_mixing, channel_spinup, convergence, sphere

CPU = ["--device", "cpu", "--dtype", "float64"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_sphere_example(tmp_path):
    summary = sphere.main(["--n", "2", "--steps", "2", "--block", "1", "--out",
                           str(tmp_path)] + CPU)
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert summary["steps"] == 2 and np.isfinite(summary["u_max"]) and summary["u_max"] > 0
    assert (tmp_path / "state_00000001.npz").exists()


def test_channel_spinup_example(tmp_path):
    model, state, psi = channel_spinup.main(["--h", "0.25", "--steps", "2", "--out",
                                             str(tmp_path)] + CPU)
    assert state.step == 2 and torch.isfinite(state.u).all()
    assert model.fe.mesh.periodic_pairs is not None
    assert (tmp_path / "channel_final.vtu").stat().st_size > 0
    assert np.isfinite(psi).any()


def test_bowl_mixing_example(tmp_path):
    plots = importlib.util.find_spec("matplotlib") is not None
    model, state = bowl_mixing.main(["--h", "0.4", "--steps", "2", "--out", str(tmp_path)]
                                    + CPU)
    assert state.step == 2 and torch.isfinite(state.u).all()
    files = ["state_00000002.npz", "state_00000002.vtu"]
    files += ["b_final.png", "profiles.png"] if plots else []
    for f in files:
        assert (tmp_path / f).stat().st_size > 0, f


def test_convergence_example():
    space, time = convergence.main(["--quick"] + CPU)
    assert space.shape == (1,) and space[0] > 1.5
    assert time["BDF1"][0] > 0.8 and time["BDF2"][0] > 1.5


@pytest.mark.parametrize("example", [sphere, channel_spinup, bowl_mixing])
def test_examples_default_to_the_card(example, tmp_path):
    with pytest.raises(RuntimeError):
        example.main(["--steps", "1", "--out", str(tmp_path)])
