"""The shard group (nupgcm_tpu_torch.parallel.comm.ShardGroup) against
numpy, and the Krylov solvers' reduction hook.

* one process holding all 8 shards (no torch.distributed call);
* two gloo ranks of 2 shards each, spawned as subprocesses that meet
  through a FileStore under the test's tmp_path (no port to collide on
  between parallel workers) with a 120 s group timeout;
* CG and FGMRES over the two ranks on a 1D Laplacian whose right-hand
  side is zero on rank 0's shards: a rank-local stopping test would stop
  rank 0 at once (and hang the group); the reduced one iterates every
  rank as far as the one-process solve, to the same solution;
* ``reduce=None`` leaves cg/gmres bit for bit what they were.

Run as ``python tests/test_torch_dd_comm.py worker RANK WORLD STORE
OUT`` it is one gloo rank of the two-rank case.
"""

import datetime
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nupgcm_tpu_torch.parallel.comm import ShardGroup
from nupgcm_tpu_torch.solvers.cg import cg
from nupgcm_tpu_torch.solvers.gmres import gmres
from torch_parity import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_thread")
SHIFTS = (1, -1, 2, 3, 5, -6, 8, 0)
N_LOCAL = 6  # points per shard of the Laplacian


def _rows(g, width=3):
    """(L, width) rows of this rank's shards: 10 * shard + column."""
    i = torch.tensor([g.index(j) for j in range(g.L)], dtype=torch.float64)
    return 10.0 * i[:, None] + torch.arange(width, dtype=torch.float64)


def _laplacian(g, n=N_LOCAL):
    """The 1D Dirichlet Laplacian over S*n points, n on each shard, with
    the neighbours' end values brought in by shifts."""
    L, S = g.L, g.S
    first = torch.tensor([g.index(j) == 0 for j in range(L)])[:, None]
    last = torch.tensor([g.index(j) == S - 1 for j in range(L)])[:, None]

    def op(xf):
        x = xf.view(L, n)
        from_left, from_right = g.shifts([(x, 1), (x, -1)])
        left = torch.where(first, 0.0, from_left[:, -1:])
        right = torch.where(last, 0.0, from_right[:, :1])
        return (2.0 * x - torch.cat([left, x[:, :-1]], 1)
                - torch.cat([x[:, 1:], right], 1)).reshape(-1)

    return op


def _rhs(g, n=N_LOCAL):
    """Zero on the shards of the first half of the group, a smooth bump
    on the rest."""
    i = torch.tensor([g.index(j) for j in range(g.L)], dtype=torch.float64)
    pts = i[:, None] * n + torch.arange(n, dtype=torch.float64)
    return torch.where(i[:, None] < g.S // 2, 0.0, torch.sin(0.3 * pts)).reshape(-1)


def _solves(g):
    """CG and FGMRES on the Laplacian, reduced over the group."""
    op, b = _laplacian(g), _rhs(g)
    out = {"local_rhs_norm": float(torch.linalg.vector_norm(b))}
    x, st = cg(op, b, torch.zeros_like(b), M_diag_inv=torch.full_like(b, 0.5), atol=0.0,
               rtol=1e-10, reduce=g.all_sum)
    out["cg"] = (st.iterations, x.tolist())
    x, st = gmres(op, b, torch.zeros_like(b), m=30, itmax=60, atol=0.0, rtol=1e-10,
                  flexible=True, M=lambda r: 0.5 * r, reduce=g.all_sum)
    out["gmres"] = (st.iterations, x.tolist())
    return out


def _ops(g):
    """Every group operation on per-shard inputs made from shard indices."""
    x = _rows(g)
    out = {"shift": {h: g.shifts([(x, h)])[0].tolist() for h in SHIFTS},
           "shift_strided": g.shifts([(torch.cat([x, x], 1)[:, 2:5], 1)])[0].tolist()}
    v = x[:, :1] + 1.0
    out["max"], out["min"] = (float(f(v)) for f in (g.max, g.min))
    out["all_sum"] = float(g.all_sum(v.sum()))
    out["gather"] = g.all_gather(x).tolist()
    out["broadcast"] = g.broadcast(torch.tensor([float(g.rank + 7)])).tolist()
    return out


def _expected(S, width=3):
    x = 10.0 * np.arange(S)[:, None] + np.arange(width)
    return x, {h: x[(np.arange(S) - h) % S] for h in SHIFTS}


def test_single_process_group_matches_numpy():
    g = ShardGroup(8)
    assert (g.world, g.rank, g.L, g.backend) == (1, 0, 8, None)
    x, shifted = _expected(8)
    got = _ops(g)
    for h in SHIFTS:
        np.testing.assert_array_equal(got["shift"][h], shifted[h])
    np.testing.assert_array_equal(got["shift_strided"], np.roll(x[:, [2, 0, 1]], 1, 0))
    v = x[:, 0] + 1.0
    assert (got["all_sum"], got["max"], got["min"]) == (v.sum(), v.max(), v.min())
    np.testing.assert_array_equal(got["gather"], x)
    assert got["broadcast"] == [7.0]
    assert g.calls["shift"] == len(SHIFTS) + 1 and g.calls["reduce"] == 3
    with pytest.raises(ValueError):
        ShardGroup(0)


def _spawn(rank, world, store, out):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()), "worker",
                             str(rank), str(world), str(store), str(out)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_two_gloo_ranks_match_numpy_and_one_process(tmp_path):
    """2 ranks x 2 local shards: shifts across and within ranks, the
    reductions, the gather and the broadcast against numpy; the reduced
    solves equal on both ranks and to the one-process solve."""
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [_spawn(r, 2, tmp_path / "store", outs[r]) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]
    res = [json.loads(o.read_text()) for o in outs]

    x, shifted = _expected(4)
    for r, got in enumerate(res):
        own = slice(2 * r, 2 * r + 2)
        for h in SHIFTS:
            np.testing.assert_array_equal(got["shift"][str(h)], shifted[h][own])
        np.testing.assert_array_equal(got["shift_strided"],
                                      np.roll(x[:, [2, 0, 1]], 1, 0)[own])
        v = x[:, 0] + 1.0
        assert (got["all_sum"], got["max"], got["min"]) == (v.sum(), v.max(), v.min())
        np.testing.assert_array_equal(got["gather"], x)
        assert got["broadcast"] == [7.0]
        assert got["refused_cuda"]

    ref = _solves(ShardGroup(4))
    # rank 0 holds no right-hand side: alone it would stop at once
    assert res[0]["local_rhs_norm"] == 0.0 and res[1]["local_rhs_norm"] > 0.0
    for key in ("cg", "gmres"):
        its = [got[key][0] for got in res]
        assert its[0] == its[1] == ref[key][0] > 0, (key, its, ref[key][0])
        x_two = np.concatenate([got[key][1] for got in res])
        np.testing.assert_allclose(x_two, ref[key][1], rtol=0, atol=1e-12)


def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return torch.as_tensor(a @ a.T + n * np.eye(n)), torch.as_tensor(rng.standard_normal(n))


@pytest.mark.parametrize("solver", ["cg", "gmres", "fgmres"])
def test_reduce_none_is_bitwise_unchanged(solver):
    """The hook adds no arithmetic: reduce=None and an identity reduce
    give the same bits, iterations and residual."""
    A, b = _spd()
    op = lambda v: A @ v
    runs = []
    for reduce in (None, lambda v: v):
        if solver == "cg":
            runs.append(cg(op, b, torch.zeros_like(b), M_diag_inv=1.0 / torch.diagonal(A),
                           rtol=1e-12, atol=0.0, reduce=reduce))
        else:
            runs.append(gmres(op, b, torch.zeros_like(b), M=lambda r: r / torch.diagonal(A),
                              m=7, rtol=1e-12, atol=0.0, flexible=solver == "fgmres",
                              reduce=reduce))
    (x0, s0), (x1, s1) = runs
    assert torch.equal(x0, x1) and s0 == s1 and s0.iterations > 7


def _worker(rank, world, store, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        g = ShardGroup(4, dist.group.WORLD)
        assert (g.world, g.rank, g.L, g.backend) == (world, rank, 2, "gloo")
        res = _ops(g)
        res.update(_solves(g))
        try:
            g._check(types.SimpleNamespace(is_cuda=True, device="cuda:0"))
            res["refused_cuda"] = False
        except ValueError:
            res["refused_cuda"] = True
    finally:
        dist.destroy_process_group()
    pathlib.Path(out).write_text(json.dumps(res))


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
