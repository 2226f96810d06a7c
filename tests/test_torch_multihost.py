"""Multi-process runtime of the port (port of tests/test_multihost.py):
the sharded-state DD step over two gloo processes of 4 local shards
each gives norms bitwise equal on both processes and within 1e-12 of
one process holding all 8 shards (whose step test_torch_dd.py holds to
nupgcm_tpu's DDModel(., 8)); and the run loop with the eddy closure,
refresh_precond and per-rank checkpoints over the two processes.

The processes meet through a FileStore under the test's tmp_path (no
port to collide on between parallel workers); each has its own
``communicate`` timeout and a 120 s group timeout.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
from torch_parity import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_thread")


def _spawn(nproc, pid, store, steps):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.Popen(
        [sys.executable, "-m", "nupgcm_tpu_torch.tools.multihost_dryrun", "--device", "cpu",
         "--nproc", str(nproc), "--pid", str(pid), "--init-method", f"file://{store}",
         "--local-shards", "4", "--steps", str(steps)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_dd_step_matches_single_process(tmp_path):
    procs = [_spawn(2, pid, tmp_path / "store", steps=1) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"rc={p.returncode}\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    a, b = outs
    assert a["n_processes"] == 2 and a["n_devices"] == 8
    assert (a["process_id"], b["process_id"]) == (0, 1)
    for k in ("u2", "p2", "b2", "u_max", "b_max", "inv_iters"):
        assert a[k] == b[k], (k, a[k], b[k])  # bitwise-replicated scalars

    from nupgcm_tpu_torch.tools.multihost_dryrun import run

    ref = run(n_steps=1, n_shards=8, device="cpu")
    assert ref["n_processes"] == 1 and ref["halo_K"] == a["halo_K"]
    assert ref["inv_iters"] == a["inv_iters"]
    for k in ("u2", "p2", "b2"):
        assert np.isclose(ref[k], a[k], rtol=1e-12, atol=0), (k, ref[k], a[k])


def _eddy_model():
    """tests/test_parallel.py's eddy configuration on bowl2D(0.15), f64."""
    import torch

    import nupgcm_tpu_torch as npg

    alpha = 0.5
    params = npg.Parameters(eps=2e-1, alpha=alpha, mu_rho=1e1, N2=1 / alpha,
                            f=lambda x: 1.0 + 0.5 * x[1],
                            H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    forc = npg.Forcings(nu=1.0, kappa_h=1e-2, kappa_v=1e-2, tau_x=0.0, tau_y=0.0,
                        b_surface_bc=npg.SurfaceDirichletBC(0.0),
                        eddy_param=npg.EddyParameterization(f=lambda x: 1.0 + 0.5 * x[1],
                                                            N2_min=1e-2))
    mesh = npg.generators.bowl2D(0.15, alpha)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"], u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    dt = 1e-4 * 1e1 / (alpha * 2e-1) ** 2
    model = npg.PGModel(npg.FEData(mesh, spaces), params, forc,
                        npg.BDF2(t_start=0, t_stop=1, dt=dt), dtype=torch.float64,
                        device="cpu", inv_atol=1e-11, inv_rtol=1e-11, evo_atol=1e-13,
                        evo_rtol=1e-13, inv_itmax=800)
    bic = lambda x: -0.05 * np.exp((x[2] - alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.3 * alpha))
    return model, model.set_b(model.rest_state(), bic)


def _eddy_run(group, ckpt):
    """11 steps with a refresh every 5 and a checkpoint at step 5 (taken
    before that step's refresh), then the run resumed from the
    checkpoint: the straight and resumed final states (full vectors, on
    every rank) and the refreshed bound."""
    from nupgcm_tpu_torch.parallel.dd import DDModel

    model, state = _eddy_model()
    dd = DDModel(model, 8, group)
    save = lambda d, sv, i: d.save_checkpoint(sv, ckpt)
    s1 = dd.run(state, n_info=0, max_steps=11, n_precond_refresh=5, n_save=5,
                save_callback=save)
    model2, _ = _eddy_model()
    dd2 = DDModel(model2, 8, group)
    # the straight run refreshed after step 5 and again after step 10
    sv = dd2.refresh_precond(dd2.load_checkpoint(ckpt))
    s2 = dd2.run(sv, n_info=0, max_steps=11, n_precond_refresh=5)
    return {"u": s1.u.numpy(), "b": s1.b.numpy(), "u_res": s2.u.numpy(), "b_res": s2.b.numpy(),
            "lmax_u": np.array(dd.tables_repl["lmax_u"]), "step": np.array(s2.step)}


def test_two_process_run_refresh_checkpoint(tmp_path):
    """The run loop over 2 gloo ranks x 4 shards with the eddy closure:
    refresh_precond (gathered state, rank 0's replicated tables
    broadcast), per-rank checkpoint files written and resumed, from_dd
    gathering the full state on both ranks; all equal to one process
    holding the 8 shards to 1e-12."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()), "worker",
                               str(r), str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    assert sorted(f.name for f in tmp_path.glob("ckpt*")) == ["ckpt.proc0.npz", "ckpt.proc1.npz"]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    ref = _eddy_run(None, str(tmp_path / "one"))
    assert int(ref["step"]) == int(got[0]["step"]) == 11
    for k in ("u", "b", "u_res", "b_res", "lmax_u"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
        np.testing.assert_allclose(got[0][k], ref[k], rtol=0, atol=1e-12)
    for k in ("u", "b"):
        np.testing.assert_allclose(ref[k + "_res"], ref[k], rtol=0, atol=1e-12)


def _worker(rank, tmp):
    import datetime

    import torch
    import torch.distributed as dist

    from nupgcm_tpu_torch.parallel.comm import ShardGroup

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store_run", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        out = _eddy_run(ShardGroup(8, dist.group.WORLD), f"{tmp}/ckpt")
    finally:
        dist.destroy_process_group()
    np.savez(f"{tmp}/rank{rank}.npz", **out)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), sys.argv[3])
