"""The port's domain decomposition on the CPU, one process holding every
shard: ports of tests/test_parallel.py's eddy-rebuild, refresh_precond,
windowed-kernel (here the per-shard block tables of the CUDA kernel's
algorithm, ops/blocks.py, against the gather/scatter path) and run-loop
tests, at their bars."""

import numpy as np
import pytest

import nupgcm_tpu_torch as npt
from nupgcm_tpu_torch.models.model import BlowUpError
from nupgcm_tpu_torch.ops import blocks
from nupgcm_tpu_torch.ops.element import ElementOperator, SaddleOperator
from nupgcm_tpu_torch.parallel.dd import DDModel
from torch_dd_cases import bic, bowl015, eddy_pair, maxdiff
from torch_parity import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def test_dd_eddy_rebuild_parity():
    """The eddy closure's inversion blocks ride in the dd state and are
    rebuilt from each shard's own cells every 10 steps: 11 steps so the
    rebuild feeds step 11."""
    m1, m2 = eddy_pair()
    s1 = m1.run(m1.set_b(m1.rest_state(), bic), n_info=0, max_steps=11)
    s2 = DDModel(m2, 8).run(m2.set_b(m2.rest_state(), bic), n_info=0, max_steps=11)
    assert maxdiff(s1, s2, "b") < 1e-9
    assert maxdiff(s1, s2, "u") < 1e-9


def test_dd_refresh_precond_parity():
    """DDModel.refresh_precond on a cadence of 5 over 11 steps: it
    re-shards the refreshed tables (the bound changes) and the
    trajectory stays that of the single-device refresh path."""
    m1, m2 = eddy_pair()
    s1 = m1.run(m1.set_b(m1.rest_state(), bic), n_info=0, max_steps=11,
                n_precond_refresh=5)
    dd = DDModel(m2, 8)
    lmax0 = dd.tables_repl["lmax_u"]
    s2 = dd.run(m2.set_b(m2.rest_state(), bic), n_info=0, max_steps=11, n_precond_refresh=5)
    assert dd.tables_repl["lmax_u"] != lmax0
    assert maxdiff(s1, s2, "b") < 1e-9
    assert maxdiff(s1, s2, "u") < 1e-9


def test_dd_block_table_path_matches_take_path(monkeypatch):
    """Every shard operator through its per-shard block tables (the CUDA
    kernel's blocked algorithm in plain PyTorch: unique dofs per block,
    invalid slots on the shard's last valid cell) reproduces the
    gather/scatter step exactly: the eddy configuration (in-step rebuilt
    blocks) with the saddle-coarse FGMRES, 11 steps."""
    m1, m2 = eddy_pair()
    s1 = DDModel(m1, 8).run(m1.set_b(m1.rest_state(), bic), n_info=0, max_steps=11)

    calls = {"saddle": 0, "scalar": 0}

    def saddle(self, x):
        calls["saddle"] += 1
        return blocks.blocked_saddle_plain(self.uu, self.up, self.pu, self.pp,
                                           *self.tables[self.mode], x, self.mode,
                                           self.n_u_nodes)

    def up(self, x):
        calls["saddle"] += 1
        return blocks.blocked_saddle_plain(None, self.up, None, None, *self.tables["up"], x,
                                           "up", self.n_u_nodes)

    def scalar(self, x):
        calls["scalar"] += 1
        return blocks.blocked_scalar_plain(self.Ae, self.table, x)

    monkeypatch.setattr(SaddleOperator, "matvec", saddle)
    monkeypatch.setattr(SaddleOperator, "up_matvec", up)
    monkeypatch.setattr(ElementOperator, "matvec", scalar)
    dd2 = DDModel(m2, 8)
    s2 = dd2.run(m2.set_b(m2.rest_state(), bic), n_info=0, max_steps=11)
    assert calls["saddle"] > 0 and calls["scalar"] > 0
    assert len(dd2.blk) == 8 and all(b["fine"]["full"][0].nc == dd2.nc_pad for b in dd2.blk)
    for f in ("b", "u", "p"):
        assert maxdiff(s1, s2, f) < 1e-12, f


def test_dd_run_loop_blocks_checkpoint_blowup(tmp_path):
    """The run loop: blocks of 2 steps equal single steps, a checkpoint
    at step 2 resumes to step 4 exactly, and the blow-up guard fires."""
    kw = dict(inv_atol=1e-11, inv_rtol=1e-11, evo_atol=1e-13, evo_rtol=1e-13, inv_itmax=800)
    m = bowl015(npt, **kw)
    dd = DDModel(m, 8)
    logs = {"dd": [], "one": []}
    s_ref = dd.run(m.rest_state(), n_info=2, max_steps=4, log=logs["dd"].append)
    m.run(m.rest_state(), n_info=2, max_steps=4, log=logs["one"].append)
    # the progress block of the single-device run, but for the clock
    fields = {k: [ln for msg in v for ln in msg.splitlines()
                  if not ln.startswith(("time elapsed", "timestep duration", "estimated"))]
              for k, v in logs.items()}
    assert len(logs["dd"]) == 2 and fields["dd"] == fields["one"]
    s_blk = dd.run(m.rest_state(), n_info=0, max_steps=4, steps_per_block=2)
    assert int(s_blk.step) == 4
    assert maxdiff(s_ref, s_blk, "b") < 1e-14

    sv = dd.to_dd(m.rest_state())
    for _ in range(2):
        sv, _ = dd.step(sv)
    path = str(tmp_path / "dd_ckpt")
    dd.save_checkpoint(sv, path)
    sv2 = dd.load_checkpoint(path)
    for _ in range(2):
        sv2, _ = dd.step(sv2)
    s_res = dd.from_dd(sv2)
    assert int(s_res.step) == 4
    assert maxdiff(s_ref, s_res, "b") == 0.0
    assert maxdiff(s_ref, s_res, "u") == 0.0

    bad = m.set_b(m.rest_state(), lambda x: 1e6 * np.exp(x[2]))
    with pytest.raises(BlowUpError):
        dd.run(bad, n_info=0, max_steps=3)
