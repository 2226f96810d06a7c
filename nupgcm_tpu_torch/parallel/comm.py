"""The shard group: S shards on ``world_size`` ranks, L local shards each.

The counterpart of the device-mesh axis ``AXIS`` that
``nupgcm_tpu/parallel/dd.py`` runs its step under (``shard_map``).
Rank r holds shards r*L ... r*L + L - 1, and every per-shard tensor
stacks this rank's shards along dim 0, shape (L, ...).

* ``shifts([(x, h), ...])``: ``jax.lax.ppermute(x, AXIS,
  [(i, (i + h) % S)])`` for each pair: shard i's tensor goes to shard
  (i + h) % S.  Pairs within a rank are local copies; pairs across
  ranks are ``torch.distributed`` point-to-point transfers, all of one
  call in one ``batch_isend_irecv``.
* ``all_sum`` / ``max`` / ``min``: ``psum`` / ``pmax`` / ``pmin``.
  ``all_sum`` reduces a value this rank has already summed over its
  local shards (the Krylov solvers' ``reduce`` hook: their dot products
  run over the rank's whole local vector); ``max`` and ``min`` take
  per-shard values (L, ...), reduce them over the local shards, then
  make one ``all_reduce``.
* ``index(j)``: ``axis_index`` of local shard j.

Without a process group the group is one rank with L = S and makes no
``torch.distributed`` call; this stands in for the JAX package's
virtual CPU devices.  With one, the backend must fit the tensors: gloo
carries CPU tensors and NCCL CUDA tensors, and a mismatch raises (no
staging through the host).  NCCL allows one rank per card, so one card
runs one rank with L = S: that is why local shards exist.

``seconds`` and ``calls`` accumulate the host time and the count of
the shift batches and of the reductions (``reset_stats`` sets them to
0).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


class ShardGroup:
    """S shards over the ranks of ``process_group`` (None: this process
    alone holds every shard)."""

    def __init__(self, n_shards: int, process_group=None):
        self.S = int(n_shards)
        self.pg = process_group
        if process_group is None:
            self.world, self.rank, self.backend = 1, 0, None
        else:
            self.world = dist.get_world_size(process_group)
            self.rank = dist.get_rank(process_group)
            self.backend = str(dist.get_backend(process_group)).lower()
            if self.backend not in ("gloo", "nccl"):
                raise ValueError(f"ShardGroup runs on gloo or NCCL, not {self.backend}")
            # point-to-point peers and broadcast sources are global ranks
            self._global = [dist.get_global_rank(process_group, r) for r in range(self.world)]
        if self.S < 1 or self.S % self.world:
            raise ValueError(f"{self.S} shards do not split over {self.world} ranks")
        self.L = self.S // self.world
        self.seconds = {"shift": 0.0, "reduce": 0.0}
        self.calls = {"shift": 0, "reduce": 0}
        if process_group is not None:
            # NCCL: the first collective of a group must involve every rank
            self._all_reduce(torch.zeros(1, device=self.device), dist.ReduceOp.SUM)
            self.reset_stats()

    @property
    def device(self) -> torch.device:
        """The device a rank's tensors live on for this group's backend."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def index(self, j: int) -> int:
        """Global index of local shard ``j``."""
        return self.rank * self.L + j

    def reset_stats(self) -> None:
        for d in (self.seconds, self.calls):
            for k in d:
                d[k] = 0

    def _check(self, t: torch.Tensor) -> None:
        if t.is_cuda != (self.backend == "nccl"):
            raise ValueError(f"a {self.backend} group cannot carry a tensor on {t.device}: "
                             "gloo carries CPU tensors and NCCL CUDA tensors")

    # ------------------------------------------------------------------
    def shifts(self, items) -> list:
        """For every (x, h) of ``items``, (L, ...) -> (L, ...): local
        shard j of the result holds the tensor of shard
        (index(j) - h) % S.  Every transfer across ranks goes in one
        batch (one round trip)."""
        t0 = time.perf_counter()
        S, L = self.S, self.L
        out, ops = [], []
        for k, (x, h) in enumerate(items):
            h %= S
            if h == 0:
                out.append(x)
                continue
            # right for every pair within the rank; rows that come from
            # another rank are received over them
            y = torch.roll(x, h, 0).contiguous()
            out.append(y)
            if self.world == 1:
                continue
            self._check(x)
            # the rows bound for (or coming from) one other rank are
            # consecutive here and there: one transfer for each run
            for rows, peer in self._runs([(self.index(j) + h) % S // L for j in range(L)]):
                ops.append(dist.P2POp(dist.isend, x[rows].contiguous(), self._global[peer],
                                      self.pg, tag=k))
            for rows, peer in self._runs([(self.index(j) - h) % S // L for j in range(L)]):
                ops.append(dist.P2POp(dist.irecv, y[rows], self._global[peer], self.pg, tag=k))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.seconds["shift"] += time.perf_counter() - t0
        self.calls["shift"] += 1
        return out

    def _runs(self, ranks):
        """(slice of local rows, rank) for each run of consecutive local
        rows whose entry of ``ranks`` is one other rank."""
        out, j0 = [], 0
        for j in range(1, len(ranks) + 1):
            if j == len(ranks) or ranks[j] != ranks[j0]:
                if ranks[j0] != self.rank:
                    out.append((slice(j0, j), ranks[j0]))
                j0 = j
        return out

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.pg is not None:
            self._check(x)
            dist.all_reduce(x, op=op, group=self.pg)
        self.seconds["reduce"] += time.perf_counter() - t0
        self.calls["reduce"] += 1
        return x

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks of a value already summed over this rank's
        shards.  ``x`` (a temporary of the caller's) is reduced in place
        and returned."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """pmax of per-shard values (L, ...)."""
        return self._all_reduce(x.amax(0), dist.ReduceOp.MAX)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """pmin of per-shard values (L, ...)."""
        return self._all_reduce(x.amin(0), dist.ReduceOp.MIN)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place."""
        if self.pg is not None:
            self._check(x)
            dist.broadcast(x, src=self._global[0], group=self.pg)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(L, ...) on every rank -> every shard's (S, ...), in shard order."""
        if self.world == 1:
            return x
        self._check(x)
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x.contiguous(), group=self.pg)
        return torch.cat(parts)
