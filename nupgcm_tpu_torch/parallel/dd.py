"""Domain-decomposed (sharded-state) model step over a shard group.

PyTorch counterpart of ``nupgcm_tpu.parallel.dd``: every state vector
is partitioned over S shards (contiguous owned blocks of each space's
RCM ordering), each operator application exchanges only neighbour
chunks, and Krylov reductions are local partials plus one sum over the
group.  The shards live on the ranks of a ``comm.ShardGroup``, L on
each: one process with L = S (no ``torch.distributed`` call), gloo
ranks on the CPU, or NCCL ranks, one per card.

Design (as the JAX module's)
----------------------------
* Each FE space (u nodes / p vertices / b nodes) is split into S
  contiguous blocks of its RCM ordering (chunk = ceil(N / S)); RCM keeps
  every element's dofs band-limited, so all off-block references fall
  within K neighbouring chunks (K measured at setup, typically 1).
* Cells go to the shard owning their median velocity node; each shard's
  batch is sorted by smallest velocity node and padded to a common
  count with invalid slots, whose element tensors are zero and whose
  dof rows repeat the shard's last valid cell (exact no-ops that keep
  every block table inside the shard's halo window).
* An operator application is: exchange (``ShardGroup.shifts`` of whole
  neighbour chunks) -> one element operator per shard over its
  EXTENDED vector -> fold-back (halo partial sums shifted back to their
  owners).  The element operators are ``ops/element.py``'s over each
  shard's extended index space with per-shard block tables: on a CUDA
  device they launch K1/K2 (``csrc/element_matvec.cu``), on the CPU
  they run the plain versions.  A CUDA ``DDModel`` never takes the
  plain path.
* The saddle-coarse correction runs with REPLICATED coarse vectors:
  restriction is a local scatter plus one sum over the group, the
  coarse solve is the dense inverse or the aggregate-level cycle / an
  inner FGMRES whose coarse matvecs run K1/K2 on each shard's own cells
  (global vertex ids, no exchange) plus one sum, and prolongation is
  local.  The u-block two-grid is not supported (as in JAX).

The step runs eagerly; ``multi_step`` is a Python loop in place of
``lax.scan``.  A rank's part of a DD vector is a tensor (L, width *
chunk) of its shards' owned blocks; the Krylov solvers see flat
vectors: (L * chunk_b,) for the evolution, [u (L*3*chunk_u) | p
(L*chunk_p)] for the inversion, and reduce their inner products with
``ShardGroup.all_sum``.

Not copied from the reference: its step reads stale spectral-bound
floats beside the traced ones (``dd.py:297,346-347,538,595-596``; here
every bound lives in ``tables_repl``, which ``refresh_precond``
replaces), and its Dirichlet lift applies the MASKED operator to the
Dirichlet values (``dd.py:821,835``), which drops the lift whenever a
Dirichlet value is nonzero; here the lift applies the unmasked
operator, as the single-device step does.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch

from ..fem import assembly as asm
from ..models.model import AUX_KEYS, BlowUpError, State, progress_message
from ..models.timesteppers import BDF2
from ..ops import blocks
from ..ops.element import ElementOperator, SaddleOperator
from ..solvers.cg import cg
from ..solvers.gmres import gmres
from ..solvers.preconditioners import AggregateCoarseCorrection, BlockStokesPrecond
from ..utils.precision import precision_ctx, scoped_method
from .comm import ShardGroup

VEC_KEYS = ("u", "p", "b", "u_prev", "b_prev")
EDDY_KEYS = ("A_uu_e", "A_up_e", "A_pu_e")
CELL_MULTIPLE = 4  # cell slots per shard: keeps each shard's tensor slices 16-byte aligned


def _ceil_div(a, b):
    return -(-a // b)


def _host(v) -> np.ndarray:
    """numpy copy of a tensor (any device), a JAX array or a number."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


@dataclass
class _SpacePart:
    """Per-space partition constants."""

    n: int  # true dof count
    chunk: int  # owned block size per shard
    K: int  # halo depth in chunks
    ext_len: int  # (2K+1)*chunk


class DDModel:
    """Sharded-state wrapper around a built ``PGModel``.

    Usage::

        model = PGModel(fe, params, forcings, ts, device="cpu")
        dd = DDModel(model, n_shards=8)              # one process, 8 shards
        state = dd.run(model.rest_state(), max_steps=10)

    ``group``: a ``ShardGroup`` of ``n_shards`` shards (default: this
    process holds them all).  Every rank builds the whole partition on
    the host and moves only its own shards' tables to the model's
    device.

    The eddy closure's in-step rebuild renews the inversion blocks alone:
    the preconditioner stays frozen until ``refresh_precond``, as in the
    reference, whatever the model's ``refresh_on_rebuild``."""

    def __init__(self, model, n_shards: int, group: ShardGroup = None):
        self.model = model
        self.S = int(n_shards)
        self.group = group if group is not None else ShardGroup(self.S)
        if self.group.S != self.S:
            raise ValueError(f"DDModel: n_shards={self.S} but the group holds "
                             f"{self.group.S} shards")
        if self.group.pg is not None and (
                (model.device.type == "cuda") != (self.group.backend == "nccl")):
            raise ValueError(f"DDModel: a {self.group.backend} group cannot carry a model "
                             f"on {model.device}: gloo for the CPU, NCCL for CUDA")
        if model.twogrid:
            raise NotImplementedError(
                "DD step: u-block two-grid not supported (use the saddle "
                "coarse correction, which subsumes it)")
        # periodic meshes need no special handling: cell dof tables map
        # slaves to masters, the RCM graph includes the identification,
        # and slave dofs are pinned by the masks like Dirichlet dofs
        self.eddy_on = bool(model.forcings.eddy_param.is_on)
        self.L = self.group.L
        self.own = np.array([self.group.index(j) for j in range(self.L)])
        self._op_cache = {}
        with precision_ctx(self.matmul_precision):
            self._build_partition()
            self._build_tables()
            self._build_blocks()

    @property
    def matmul_precision(self):
        """The wrapped model's policy (``PGModel(matmul_precision=...)``),
        entered around the build and every entry point, as the JAX
        ``DDModel`` does (``nupgcm_tpu/parallel/dd.py:110``)."""
        return self.model.matmul_precision

    # ------------------------------------------------------------------
    # host setup
    # ------------------------------------------------------------------
    def _build_partition(self):
        fe = self.model.fe
        sp = fe.spaces
        S = self.S
        cd_u = np.asarray(fe.cd_u)  # (ncp, nlu) node ids, current numbering
        cd_p = np.asarray(fe.cd_p)
        cd_b = np.asarray(fe.cd_b)

        cu = _ceil_div(sp.u_space.ndof, S)
        cp = _ceil_div(sp.p_space.ndof, S)
        cb = _ceil_div(sp.b_space.ndof, S)

        # owner by median velocity node
        owner = np.clip(np.median(cd_u, axis=1).astype(np.int64) // cu, 0, S - 1)
        # fe pad cells (zero wq) can go anywhere; spread for balance
        is_pad = np.abs(np.asarray(fe.geom.wq)).sum(axis=1) == 0
        owner[is_pad] = np.arange(is_pad.sum()) % S

        counts = np.bincount(owner, minlength=S)
        self.nc_max = int(counts.max())  # the JAX package's per-shard cell count
        nc = _ceil_div(self.nc_max, CELL_MULTIPLE) * CELL_MULTIPLE
        order = np.zeros((S, nc), dtype=np.int64)
        valid = np.zeros((S, nc), dtype=bool)
        for s in range(S):
            ids = np.where(owner == s)[0]
            # smallest velocity node first, pad cells last (FEData's
            # global cell sort): a run of consecutive cells touches a
            # narrow dof window, which keeps the block tables narrow
            key = np.where(is_pad[ids], np.iinfo(np.int64).max, cd_u[ids].min(axis=1))
            ids = ids[np.argsort(key, kind="stable")]
            order[s, : len(ids)] = ids
            # fe pad cells carry all-zero dof rows that may fall outside
            # far shards' halo windows: invalid slots, like the padding
            valid[s, : len(ids)] = ~is_pad[ids]
        self.cell_order = order  # (S, nc_pad) indices into the ncp cell axis
        self.cell_valid = valid
        self.nc_pad = nc

        # halo depth per space: max reach of any cell's dofs outside its
        # owner block, in chunks
        def halo_K(cd, chunk):
            lo = owner * chunk
            r_lo = np.maximum(lo - cd.min(axis=1), 0)
            r_hi = np.maximum(cd.max(axis=1) - (lo + chunk - 1), 0)
            r_lo[is_pad] = 0
            r_hi[is_pad] = 0
            H = int(max(r_lo.max(initial=0), r_hi.max(initial=0)))
            return _ceil_div(H, chunk) if H else 0

        Ku, Kp, Kb = halo_K(cd_u, cu), halo_K(cd_p, cp), halo_K(cd_b, cb)
        if max(Ku, Kp, Kb) >= S:
            raise ValueError(
                f"halo depth ({Ku},{Kp},{Kb}) chunks >= {S} shards: mesh too "
                f"small for this shard count (or RCM bandwidth too large)")
        self.part_u = _SpacePart(sp.u_space.ndof, cu, Ku, (2 * Ku + 1) * cu)
        self.part_p = _SpacePart(sp.p_space.ndof, cp, Kp, (2 * Kp + 1) * cp)
        self.part_b = _SpacePart(sp.b_space.ndof, cb, Kb, (2 * Kb + 1) * cb)

    def _fix_invalid(self, g: np.ndarray) -> np.ndarray:
        """(L, nc, nl) dof rows of this rank's shards: invalid slots take
        the shard's last valid row, or 0 in a shard without cells (their
        tensors are zero, so they gather and scatter exact no-ops inside
        the shard's window)."""
        g = np.array(g)
        for j, s in enumerate(self.own):
            nval = int(self.cell_valid[s].sum())
            g[j, ~self.cell_valid[s]] = g[j, nval - 1] if nval else 0
        return g

    def _ext_ids(self, cd, part) -> np.ndarray:
        """Global dof ids of this rank's shards' cells -> extended-vector
        indices: ext = gid - (s - K) * chunk."""
        g = np.asarray(cd)[self.cell_order[self.own]]
        e = self._fix_invalid(g - ((self.own - part.K) * part.chunk)[:, None, None])
        if e.min() < 0 or e.max() >= part.ext_len:
            raise AssertionError("ext index out of halo window")
        return e

    def _reorder_cells(self, arr) -> np.ndarray:
        """(ncp, ...) cell-axis array -> this rank's (L, nc_pad, ...),
        zeroed on invalid slots."""
        a = _host(arr)[self.cell_order[self.own]]
        if np.issubdtype(a.dtype, np.floating):
            valid = self.cell_valid[self.own]
            a = a * valid.reshape(*valid.shape, *([1] * (a.ndim - 2)))
        return a

    def _vec_dd(self, v, part, width=1) -> np.ndarray:
        """Full-length vector -> this rank's (L, width*chunk) blocks,
        zero-padded past the last dof."""
        v = _host(v).reshape(-1)
        v = np.pad(v, (0, self.S * part.chunk * width - v.shape[0]))
        return v.reshape(self.S, -1)[self.own]

    def _T(self, a) -> torch.Tensor:
        m = self.model
        return torch.as_tensor(np.ascontiguousarray(a), dtype=m.dtype, device=m.device)

    def _I(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                               device=self.model.device)

    def _build_tables(self):
        m = self.model
        fe, c, ops = m.fe, m.const, m.ops
        sp = fe.spaces
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        T, I = self._T, self._I

        self._cd_host = {"u": self._ext_ids(fe.cd_u, pu_), "p": self._ext_ids(fe.cd_p, pp_),
                         "b": self._ext_ids(fe.cd_b, pb_)}
        t = {f"cd_{k}": I(v) for k, v in self._cd_host.items()}
        # element tensors in shard batches; with the eddy closure the
        # inversion blocks ride in the state instead
        elem_keys = ["visc_e", "Mp_e", "B_e", "M_e", "Kh_e", "Kv_e"]
        if not self.eddy_on:
            elem_keys += list(EDDY_KEYS)
        for k in elem_keys:
            t[k] = T(self._reorder_cells(ops[k]))
        self._eddy_init = None
        if self.eddy_on:
            self._eddy_init = {k: self._reorder_cells(ops[k]) for k in EDDY_KEYS}
            t["f_q"] = T(self._reorder_cells(c["f_q"]))
            t["f_eddy_q"] = T(self._reorder_cells(c["f_eddy_q"]))
        # geometry + coefficients of the in-step assemblies
        for k in ("wq", "invJT", "kv_q"):
            t[k] = T(self._reorder_cells(c[k]))
        t["Gb3"] = asm.physical_grads(t["invJT"].flatten(0, 1), c["dphi_b"], c["embed"])
        valid = self.cell_valid[self.own]
        h = np.where(valid, np.asarray(fe.h_cells)[self.cell_order[self.own]], 1e30)
        t["h_cells"] = T(h)
        self.h_min = float(np.where(self.cell_valid, np.asarray(fe.h_cells)[self.cell_order],
                                    1e30).min())
        # masks / lifts / rhs in dd layout
        n_u = sp.n_u
        t["free_u"] = T(self._vec_dd(c["free_u"], pu_, 3))
        t["udiri"] = T(self._vec_dd(c["xdiri_inv"][:n_u], pu_, 3))
        t["free_b"] = T(self._vec_dd(c["free_b"], pb_))
        t["bdiri"] = T(self._vec_dd(c["bdiri"], pb_))
        t["free_p"] = T(self._vec_dd(c["free_inv"][n_u:], pp_))
        t["s_u"] = T(self._vec_dd(ops["s"][:n_u], pu_, 3))
        t["rhs_diff"] = T(self._vec_dd(ops["rhs_diff"], pb_))
        t["rhs_flux"] = T(self._vec_dd(ops["rhs_flux"], pb_))
        t["p_volw"] = T(self._vec_dd(ops["p_volw"], pp_))
        # preconditioner diagonals (single-device computation, resharded)
        t["visc_dinv"] = T(self._vec_dd(ops["visc_dinv"], pu_, 3))
        t["mp_dinv"] = T(self._vec_dd(ops["mp_dinv"], pp_))

        # ---- replicated tables, among them every spectral bound ------
        tr = {"lmax_u": float(ops["lmax_u"]), "lmax_p": float(ops["lmax_p"])}
        self.has_saddle_coarse = bool(m.saddle_coarse) and (
            "saddle_coarse_inv" in ops or "sc_uu" in ops)
        if self.has_saddle_coarse:
            nv = sp.p_space.ndof
            tr["tg_coarse_free"] = c["tg_coarse_free"]
            tr["free_p_c"] = c["free_inv"][n_u:]
            # per-shard slices of the P1 c P2 inclusion (fine u node ->
            # two parent vertices); pad nodes -> weight 0
            tp, tw = _host(c["tg_parents"]), _host(c["tg_weights"])
            nn = sp.u_space.ndof
            par = np.zeros((self.L, pu_.chunk, 2), np.int64)
            wts = np.zeros((self.L, pu_.chunk, 2))
            for j, s in enumerate(self.own):
                lo, hi = s * pu_.chunk, min((s + 1) * pu_.chunk, nn)
                if hi > lo:
                    par[j, : hi - lo] = tp[lo:hi]
                    wts[j, : hi - lo] = tw[lo:hi]
            t["tg_parents_dd"] = I(par)
            t["tg_weights_dd"] = T(wts)
            if "saddle_coarse_inv" in ops:
                tr["sc_inv"] = ops["saddle_coarse_inv"]
            else:
                # iterative coarse path: coarse element tensors sharded
                # by cell over GLOBAL vertex ids (no halo exchange)
                for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp", "sc_visc_e"):
                    t[k] = T(self._reorder_cells(ops[k]))
                self._cd_host["pg"] = self._fix_invalid(
                    np.asarray(fe.cd_p)[self.cell_order[self.own]])
                t["cd_pg"] = I(self._cd_host["pg"])
                tr["sc_pin"] = ops["sc_pin"]
                tr["sc_sigma"] = ops["sc_sigma"]
                tr["sc_lmax"] = float(ops["sc_lmax"])
                if "sc2_inv" in ops:
                    tr["sc2_inv"] = ops["sc2_inv"]
                    tr["sc2_agg"] = ops["sc2_agg"].long()
                tr["cvisc_dinv"] = ops["sc_visc_dinv"]
                tr["mp_c_dinv"] = ops["mp_dinv"]
        for k in ("free_u", "free_b", "free_p"):
            t[k + "_bool"] = t[k].bool()
        self.tables = t
        self.tables_repl = self._replicate(tr)

    def _replicate(self, tr: dict) -> dict:
        """Rank 0's replicated tables on every rank: each rank builds its
        own model, whose device reductions (atomics) may differ in the
        last bits; replicated values must not.  The tables are the
        model's own device tensors (no host round trip); with a process
        group each is broadcast into a copy, so the model keeps its own."""
        g = self.group
        if g.pg is None:
            return tr
        out = {}
        for k, v in tr.items():
            x = (torch.tensor(v, dtype=torch.float64, device=g.device)
                 if isinstance(v, float) else v.clone(memory_format=torch.contiguous_format))
            g.broadcast(x)
            out[k] = float(x) if isinstance(v, float) else x
        return out

    def _build_blocks(self):
        """Per-shard block tables of the element-matvec kernel
        (``ops/blocks.py``) over each shard's extended index space, and
        over global vertex ids for the coarse level."""
        m = self.model
        item = torch.empty((), dtype=m.dtype).element_size()
        dev, cdh = m.device, self._cd_host
        self.blk = []
        for j in range(self.L):
            b = {"fine": blocks.operator_tables(cdh["u"][j], cdh["p"][j], ("full", "up", "uu"),
                                                item, dev),
                 "b": blocks.scalar_table(cdh["b"][j], item, dev),
                 "p": blocks.scalar_table(cdh["p"][j], item, dev)}
            if "pg" in cdh:
                cd = cdh["pg"][j]
                b["coarse"] = blocks.operator_tables(cd, cd, ("full_pp", "up", "uu"), item, dev)
                b["pg"] = blocks.scalar_table(cd, item, dev)
            self.blk.append(b)
        self._cd_none = torch.zeros((self.nc_pad, 0), dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------
    # per-shard element operators
    # ------------------------------------------------------------------
    def _saddle_op(self, j, uu, up=None, pu=None, pp=None, coarse=False) -> SaddleOperator:
        t = self.tables
        if coarse:
            nv = self.part_p.n
            cd_u = cd_p = t["cd_pg"][j]
            n_u, n_p, tables = nv, nv, self.blk[j]["coarse"]
        else:
            cd_u, cd_p = t["cd_u"][j], t["cd_p"][j]
            n_u, n_p, tables = self.part_u.ext_len, self.part_p.ext_len, self.blk[j]["fine"]
        if up is None:
            cd_p, n_p = self._cd_none, 0
        return SaddleOperator(uu=uu, up=up, pu=pu, pp=pp, cd_u=cd_u, cd_p=cd_p, n_u_nodes=n_u,
                              n_p=n_p, tables=tables)

    def _ops(self, key, tensors, make):
        """This rank's L operators of ``key``, rebuilt only when one of
        ``tensors`` (L-stacked element tensors) is a new object."""
        hit = self._op_cache.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], tensors)):
            return hit[1]
        ops = [make(j) for j in range(self.L)]
        self._op_cache[key] = (tensors, ops)
        return ops

    def shard_operators(self, sv: dict = None) -> dict:
        """{name: this rank's L per-shard element operators} that the
        step applies (the evolution matrix at theta = 1); ``sv`` supplies
        the eddy closure's inversion blocks."""
        t = self.tables
        A = tuple((sv if self.eddy_on else t)[k] for k in EDDY_KEYS)
        out = {"saddle": self._fine_ops(A),
               "visc": self._ops("visc", (t["visc_e"],),
                                 lambda j: self._saddle_op(j, t["visc_e"][j])),
               "ublock": self._ops("ublock", A[:1], lambda j: self._saddle_op(j, A[0][j])),
               "mp": self._mp_ops()}
        evo = t["M_e"] + (t["Kh_e"] + t["Kv_e"])
        out["evolution"] = [self._evo_op(j, evo) for j in range(self.L)]
        if "cd_pg" in t:
            out.update(self._coarse_ops())
        return out

    def _fine_ops(self, A):
        return self._ops("fine", A, lambda j: self._saddle_op(j, A[0][j], A[1][j], A[2][j]))

    def _mp_ops(self):
        t = self.tables
        return self._ops("mp", (t["Mp_e"],), lambda j: ElementOperator(
            Ae=t["Mp_e"][j], cd=t["cd_p"][j], n=self.part_p.ext_len, table=self.blk[j]["p"]))

    def _evo_op(self, j, evo_Ae):
        return ElementOperator(Ae=evo_Ae[j], cd=self.tables["cd_b"][j], n=self.part_b.ext_len,
                               table=self.blk[j]["b"])

    def _coarse_ops(self) -> dict:
        t = self.tables
        sc = tuple(t[k] for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp"))
        return {
            "coarse": self._ops("coarse", sc, lambda j: self._saddle_op(
                j, *(a[j] for a in sc), coarse=True)),
            "coarse_visc": self._ops("coarse_visc", (t["sc_visc_e"],), lambda j: self._saddle_op(
                j, t["sc_visc_e"][j], coarse=True)),
            "coarse_uu": self._ops("coarse_uu", sc[:1], lambda j: self._saddle_op(
                j, sc[0][j], coarse=True)),
            "coarse_mp": self._ops("coarse_mp", (t["Mp_e"],), lambda j: ElementOperator(
                Ae=t["Mp_e"][j], cd=t["cd_pg"][j], n=self.part_p.n, table=self.blk[j]["pg"])),
        }

    # ------------------------------------------------------------------
    # exchange, fold-back, gathers
    # ------------------------------------------------------------------
    def _ex(self, x, part):
        """owned (L, w*chunk) -> extended (L, w*(2K+1)*chunk)."""
        K = part.K
        if K == 0:
            return x
        hs = [*range(K, 0, -1), 0, *range(-1, -K - 1, -1)]
        return torch.cat(self.group.shifts([(x, h) for h in hs]), dim=1)

    def _fold(self, y, part):
        """extended partial sums -> owned, the halo parts returned to
        their owners (reverse shifts)."""
        K = part.K
        if K == 0:
            return y
        w = y.shape[1] // (2 * K + 1)
        own = y[:, K * w:(K + 1) * w]
        halo = self.group.shifts([(y[:, (K + s * h) * w:(K + s * h + 1) * w], s * h)
                                  for h in range(1, K + 1) for s in (1, -1)])
        for v in halo:
            own = own + v
        return own

    @staticmethod
    def _apply(ops, xe, method="matvec"):
        """Each shard's operator on its row of ``xe`` -> (L, len y)."""
        ys = [getattr(op, method)(xe[j]) for j, op in enumerate(ops)]
        return ys[0].unsqueeze(0) if len(ys) == 1 else torch.stack(ys)

    def _coarse_sum(self, ops, x, method="matvec"):
        """Every shard's partial of a coarse operator on the replicated
        ``x``, summed over the group."""
        y = None
        for op in ops:
            v = getattr(op, method)(x)
            y = v if y is None else y + v
        return self.group.all_sum(y)

    def _gather(self, xe, cd):
        """(L, E) -> per-cell values (L*nc, nl)."""
        return torch.gather(xe, 1, cd.reshape(self.L, -1)).reshape(-1, cd.shape[-1])

    def _gather3(self, xe, cd):
        """node-major (L, 3E) -> per-cell node vectors (L*nc, nl, 3)."""
        idx = cd.reshape(self.L, -1, 1).expand(-1, -1, 3)
        return torch.gather(xe.reshape(self.L, -1, 3), 1, idx).reshape(-1, cd.shape[-1], 3)

    def _scatter(self, ye, cd, E):
        """per-cell values (L*nc, nl) -> (L, E) partial sums."""
        return ye.new_zeros((self.L, E)).scatter_add_(1, cd.reshape(self.L, -1),
                                                      ye.reshape(self.L, -1))

    def _scatter3(self, ye, cd, E):
        """per-cell node vectors (L*nc, nl, 3) -> node-major (L, 3E)."""
        idx = cd.reshape(self.L, -1, 1).expand(-1, -1, 3)
        return ye.new_zeros((self.L, E, 3)).scatter_add_(
            1, idx, ye.reshape(self.L, -1, 3)).reshape(self.L, -1)

    # ------------------------------------------------------------------
    # state conversion
    # ------------------------------------------------------------------
    def to_dd(self, state) -> dict:
        """A ``State`` (tensors, numpy or JAX arrays) -> this rank's dd
        state: (L, width*chunk) vectors, 0-d t and dt, an int step, and
        with the eddy closure the inversion blocks (L, nc_pad, ...)."""
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        T = self._T
        dd = {"u": T(self._vec_dd(state.u, pu_, 3)),
              "u_prev": T(self._vec_dd(state.u_prev, pu_, 3)),
              "p": T(self._vec_dd(state.p, pp_)),
              "b": T(self._vec_dd(state.b, pb_)),
              "b_prev": T(self._vec_dd(state.b_prev, pb_)),
              "t": T(_host(state.t)), "dt": T(_host(state.dt)),
              "step": int(_host(state.step))}
        if self.eddy_on:
            for k, v in self._eddy_init.items():
                dd[k] = T(v)
        return dd

    def from_dd(self, dd: dict) -> State:
        """The full ``State`` on the model's device, on every rank."""
        g = self.group
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b

        def full(k, part, width=1):
            return g.all_gather(dd[k]).reshape(-1)[: width * part.n]

        return State(u=full("u", pu_, 3).reshape(-1, 3), p=full("p", pp_), b=full("b", pb_),
                     u_prev=full("u_prev", pu_, 3).reshape(-1, 3), b_prev=full("b_prev", pb_),
                     t=dd["t"], dt=dd["dt"], step=int(dd["step"]))

    def norms(self, dd: dict) -> dict:
        """Replicated global squared L2 norms of the state, the same on
        every rank."""
        sq = torch.stack([torch.dot(dd[k].reshape(-1), dd[k].reshape(-1))
                          for k in ("u", "p", "b")])
        return dict(zip(("u2", "p2", "b2"), self.group.all_sum(sq).tolist()))

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    @scoped_method
    def step(self, sv: dict):
        """One timestep of the sharded state: (new dd state, aux), aux
        holding the solver counts and the progress-line diagnostics as
        Python numbers, the same on every rank."""
        m = self.model
        pr, c, t, tr = m.params, m.const, self.tables, self.tables_repl
        g, L = self.group, self.L
        pu_, pp_, pb_ = self.part_u, self.part_p, self.part_b
        Eu, Ep, Eb = pu_.ext_len, pp_.ext_len, pb_.ext_len
        nU = L * 3 * pu_.chunk
        u_loc, p_loc, b_loc = sv["u"], sv["p"], sv["b"]
        up_loc, bp_loc = sv["u_prev"], sv["b_prev"]
        tt, dtv, stp = sv["t"], sv["dt"], sv["step"]
        A = tuple((sv if self.eddy_on else t)[k] for k in EDDY_KEYS)
        free_u, free_p, free_b = t["free_u"], t["free_p"], t["free_b"]
        fu, fp, fb = t["free_u_bool"], t["free_p_bool"], t["free_b_bool"]
        ex_u, ex_p, ex_b = (partial(self._ex, part=q) for q in (pu_, pp_, pb_))
        fold_u, fold_p, fold_b = (partial(self._fold, part=q) for q in (pu_, pp_, pb_))

        # ---- operators -------------------------------------------------
        fine = self._fine_ops(A)
        visc = self._ops("visc", (t["visc_e"],), lambda j: self._saddle_op(j, t["visc_e"][j]))
        mp = self._mp_ops()

        def saddle_apply(xu, xp):
            y = self._apply(fine, torch.cat([ex_u(xu), ex_p(xp)], dim=1))
            return fold_u(y[:, :3 * Eu]), fold_p(y[:, 3 * Eu:])

        def saddle_mv(x):
            """masked saddle matvec on the flat local [u | p]."""
            xu, xp = x[:nU].view(L, -1), x[nU:].view(L, -1)
            yu, yp = saddle_apply(xu * free_u, xp * free_p)
            return torch.cat([torch.where(fu, yu, xu).reshape(-1),
                              torch.where(fp, yp, xp).reshape(-1)])

        def u_block(ops):
            def mv(xu):
                xu = xu.view(L, -1)
                y = fold_u(self._apply(ops, ex_u(xu * free_u)))
                return torch.where(fu, y, xu).reshape(-1)
            return mv

        def up_mv(xp):
            y = fold_u(self._apply(fine, ex_p(xp.view(L, -1)), "up_matvec"))
            return (free_u * y).reshape(-1)

        def mp_mv(xp):
            xp = xp.view(L, -1)
            y = fold_p(self._apply(mp, ex_p(xp * free_p)))
            return torch.where(fp, y, xp).reshape(-1)

        # ---- CFL dt ----------------------------------------------------
        dt_old = dtv
        u_ext = ex_u(u_loc)
        if getattr(m.ts, "adaptive", False):
            u_q = torch.einsum("qi,cia->cqa", c["phi_u"], self._gather3(u_ext, t["cd_u"]))
            speed = torch.linalg.vector_norm(u_q, dim=-1).amax(dim=1).view(L, -1)
            ratios = t["h_cells"] / torch.clamp(speed, min=0.01)
            dt_new = m.ts.CFL_factor * g.min(ratios.amin(dim=1))
            if isinstance(m.ts, BDF2):
                dt_new = torch.minimum(dt_new, 2.0 * dtv)
            dtv = dt_new
        r = dtv / dt_old

        # ---- evolution (advection + diffusion solve) -------------------
        wq, Gb3 = t["wq"].flatten(0, 1), t["Gb3"]
        b_e = self._gather(ex_b(b_loc), t["cd_b"])
        bp_e = self._gather(ex_b(bp_loc), t["cd_b"])
        u_e = self._gather3(u_ext, t["cd_u"])
        upv_e = self._gather3(ex_u(up_loc), t["cd_u"])
        conv = m.forcings.conv_param
        if conv.is_on:
            abz = pr.alpha * (pr.N2 + torch.einsum("cqi,ci->cq", Gb3[..., 2], b_e))
            kv_q = conv.kappa_v(t["kv_q"].flatten(0, 1), abz)
            Kv_e = asm.elem_stiffness(wq, kv_q, Gb3, (2,)).view_as(t["Kv_e"])
            rhs_diff = fold_b(self._scatter(asm.elem_rhs_diff(wq, kv_q, Gb3, pr.N2),
                                            t["cd_b"], Eb))
        else:
            Kv_e, rhs_diff = t["Kv_e"], t["rhs_diff"]

        # BDF coefficients as the single-device step (BDF2's first step
        # runs as BDF1; variable-step BDF2 of ratio r)
        base_theta = dtv * pr.a2e2 / pr.mu_rho
        if isinstance(m.ts, BDF2) and stp > 0:
            w = (1.0 + r) / (1.0 + 2.0 * r)
            theta, cdt, w2 = w * base_theta, w * dtv, 1.0 + r
            c0, c1 = (1.0 + r) ** 2 / (1.0 + 2.0 * r), r ** 2 / (1.0 + 2.0 * r)
        else:
            theta, c0, c1, cdt, w2 = base_theta, 1.0, 0.0, dtv, 1.0
        ue = w2 * u_e - (w2 - 1.0) * upv_e
        be = w2 * b_e - (w2 - 1.0) * bp_e
        u_q = torch.einsum("qi,cia->cqa", c["phi_u"], ue)
        gb_q = torch.einsum("cqid,ci->cqd", Gb3, be)
        adv = torch.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * pr.N2
        b_q = torch.einsum("qi,ci->cq", c["phi_b"], b_e)
        bp_q = torch.einsum("qi,ci->cq", c["phi_b"], bp_e)
        integ = c0 * b_q - c1 * bp_q - cdt * adv
        rhs_adv = fold_b(self._scatter(torch.einsum("cq,qi,cq->ci", wq, c["phi_b"], integ),
                                       t["cd_b"], Eb))

        evo_Ae = t["M_e"] + theta * (t["Kh_e"] + Kv_e)
        evo = [self._evo_op(j, evo_Ae) for j in range(L)]

        def evo_apply(x):
            return fold_b(self._apply(evo, ex_b(x)))

        def evo_mv(x):
            x = x.view(L, -1)
            return torch.where(fb, evo_apply(x * free_b), x).reshape(-1)

        # Jacobi diagonal of the evolution matrix (masked)
        de = torch.diagonal(evo_Ae, dim1=-2, dim2=-1).flatten(0, 1)
        evo_dinv = 1.0 / torch.where(fb, fold_b(self._scatter(de, t["cd_b"], Eb)), 1.0)

        y_full = rhs_adv + theta * rhs_diff + dtv * t["rhs_flux"]
        xd = t["bdiri"] * (1.0 - free_b)
        y = torch.where(fb, y_full - evo_apply(xd), t["bdiri"])
        b_new, evo_stats = cg(evo_mv, y.reshape(-1), b_loc.reshape(-1),
                              M_diag_inv=evo_dinv.reshape(-1), reduce=g.all_sum, **m.evo_opts)
        b_new = b_new.view(L, -1)

        # ---- inversion -------------------------------------------------
        b_e_new = self._gather(ex_b(b_new), t["cd_b"])
        Bye = torch.einsum("cij,cj->ci", t["B_e"].flatten(0, 1), b_e_new)
        yu = fold_u(self._scatter3(Bye.view(b_e_new.shape[0], -1, 3), t["cd_u"], Eu))
        xdu = t["udiri"] * (1.0 - free_u)
        lu, lp = saddle_apply(xdu, torch.zeros_like(p_loc))
        y_inv = torch.cat([torch.where(fu, yu + t["s_u"] - lu, t["udiri"]).reshape(-1),
                           torch.where(fp, -lp, 0.0).reshape(-1)])

        iu, ip = m.inner_iters
        coarse = self._saddle_coarse(c) if self.has_saddle_coarse else None
        M = BlockStokesPrecond(
            visc_op=u_block(visc), visc_diag_inv=t["visc_dinv"].reshape(-1), mp_op=mp_mv,
            mp_diag_inv=t["mp_dinv"].reshape(-1), nu_dofs=nU, inner_iters_u=iu,
            inner_iters_p=ip, method=m.inner_method, lmax_u=tr["lmax_u"], lmax_p=tr["lmax_p"],
            cond_ratio=m.cond_ratio,
            ublock_op=(u_block(self._ops("ublock", A[:1], lambda j: self._saddle_op(j, A[0][j])))
                       if m.inner_method == "inner_gmres" else None),
            up_coupling=up_mv, saddle_coarse=coarse, outer_op=saddle_mv, reduce=g.all_sum)
        x0 = torch.cat([u_loc.reshape(-1), p_loc.reshape(-1)])
        x, inv_stats = gmres(saddle_mv, y_inv, x0, M=M, flexible=True, reduce=g.all_sum,
                             **m.inv_opts)
        u_new = x[:nU].view(L, -1)
        p_new = x[nU:].view(L, -1)
        pw = t["p_volw"]
        p_new = p_new - (g.all_sum(torch.dot(pw.reshape(-1), p_new.reshape(-1)))
                         / g.all_sum(pw.sum()))

        # ---- diagnostics (one reduction) -------------------------------
        inf = torch.tensor(float("inf"), dtype=b_new.dtype, device=b_new.device)
        loc = torch.stack([u_new.abs().amax(1), b_new.abs().amax(1),
                           torch.where(fb, b_new, -inf).amax(1),
                           -torch.where(fb, b_new, inf).amin(1),
                           torch.where(fb, (b_new - b_loc).abs(), 0.0).amax(1) / dtv], dim=1)
        u_max, b_max, bf_max, neg_bf_min, db_dt = g.max(loc).tolist()
        aux = {"evo_iters": evo_stats.iterations, "evo_res": evo_stats.residual,
               "inv_iters": inv_stats.iterations, "inv_res": inv_stats.residual,
               "u_max": u_max, "b_max": b_max, "b_free_min": -neg_bf_min,
               "b_free_max": bf_max, "db_dt_max": db_dt,
               "cfl_dt": self.h_min / max(u_max, 1e-30)}
        out = {"u": u_new, "p": p_new, "b": b_new, "u_prev": u_loc, "b_prev": b_loc,
               "t": tt + dtv, "dt": dtv, "step": stp + 1}
        if self.eddy_on:
            # eddy-viscosity inversion-block rebuild every 10 steps
            # (reference src/model.jl:160-170) from this shard's own
            # cells; the preconditioner is kept (the reference's frozen
            # one: PGModel's refresh_on_rebuild does not reach here)
            rebuilt = (self._eddy_blocks(Gb3, b_new) if (stp + 1) % 10 == 0 else A)
            out.update(zip(EDDY_KEYS, rebuilt))
        return out, aux

    def _eddy_blocks(self, Gb3, b_new):
        m, c, t = self.model, self.model.const, self.tables
        pr = m.params
        abz = pr.alpha * (pr.N2 + torch.einsum(
            "cqi,ci->cq", Gb3[..., 2], self._gather(self._ex(b_new, self.part_b), t["cd_b"])))
        nu_q = m.forcings.eddy_param.nu(t["f_eddy_q"].flatten(0, 1), abz)

        def build_(wq, nu_q, f_q, invJT):
            Gu3 = asm.physical_grads(invJT, c["dphi_u"], c["embed"])
            return asm.elem_inversion_blocks(wq, nu_q, f_q, c["phi_u"], Gu3, c["phi_p"],
                                             pr.a2e2, m.variable_nu)

        flat = m._chunked_cells(build_, t["wq"].flatten(0, 1), nu_q, t["f_q"].flatten(0, 1),
                                t["invJT"].flatten(0, 1))
        return tuple(a.view(self.L, self.nc_pad, *a.shape[1:]) for a in flat)

    def _saddle_coarse(self, c):
        """The replicated saddle-coarse correction, as ``BlockStokesPrecond``
        applies it: z + P solve(R (r - A z)) on the free dofs."""
        m, t, tr, g = self.model, self.tables, self.tables_repl, self.group
        L, S = self.L, self.S
        pu_, pp_ = self.part_u, self.part_p
        nv, cp = pp_.n, pp_.chunk
        nU = L * 3 * pu_.chunk
        tgf, fpc = tr["tg_coarse_free"], tr["free_p_c"]
        free_c = torch.cat([tgf, fpc])
        free_inv = torch.cat([t["free_u"].reshape(-1), t["free_p"].reshape(-1)])
        par, wts = t["tg_parents_dd"], t["tg_weights_dd"]
        p0 = g.rank * L * cp  # this rank's first pressure dof in the S*cp layout

        def restrict(rv):
            ru = rv[:nU].view(L, -1, 1, 3)
            rcu = rv.new_zeros((nv, 3)).index_add_(
                0, par.reshape(-1), (wts[..., None] * ru).reshape(-1, 3))
            rp = rv.new_zeros(S * cp)
            rp[p0:p0 + L * cp] = rv[nU:]
            both = g.all_sum(torch.cat([rcu.reshape(-1), rp]))
            return torch.cat([both[:3 * nv] * tgf, both[3 * nv:4 * nv]])

        def prolong(zc):
            zcu = (zc[: 3 * nv] * tgf).view(nv, 3)
            zu = (wts[..., None] * zcu[par]).sum(2).reshape(-1)
            zp = torch.nn.functional.pad(zc[3 * nv:], (0, S * cp - nv))[p0:p0 + L * cp]
            return torch.cat([zu, zp])

        if "sc_inv" in tr:
            sc_inv = tr["sc_inv"]
            coarse_solve = lambda rc: sc_inv @ rc
        else:
            ops = self._coarse_ops()
            fcb, tgb, fpb = free_c.bool(), tgf.bool(), fpc.bool()
            w, sigma = tr["sc_pin"], tr["sc_sigma"]

            def cmat(xc):
                y = self._coarse_sum(ops["coarse"], xc * free_c)
                return torch.where(fcb, y, xc) + sigma * w * torch.dot(w, xc)

            def c_block(key):
                def mv(xu):
                    return torch.where(tgb, self._coarse_sum(ops[key], xu * tgf), xu)
                return mv

            def cmp_mv(xp):
                return torch.where(fpb, self._coarse_sum(ops["coarse_mp"], xp * fpc), xp)

            def cup_mv(xp):
                return tgf * self._coarse_sum(ops["coarse"], xp, "up_matvec")

            Mc = BlockStokesPrecond(
                visc_op=c_block("coarse_visc"), visc_diag_inv=tr["cvisc_dinv"], mp_op=cmp_mv,
                mp_diag_inv=tr["mp_c_dinv"], nu_dofs=3 * nv,
                inner_iters_u=6 if m.inner_method == "inner_gmres" else 3, inner_iters_p=3,
                method=m.inner_method, lmax_u=tr["sc_lmax"], lmax_p=tr["lmax_p"],
                cond_ratio=m.cond_ratio, ublock_op=c_block("coarse_uu"), up_coupling=cup_mv)
            M_in = Mc
            if "sc2_inv" in tr:
                sc2 = AggregateCoarseCorrection(inv=tr["sc2_inv"], agg=tr["sc2_agg"],
                                                n_agg=tr["sc2_inv"].shape[0] // 4, free_c=free_c)
                M_in = lambda rv: sc2(cmat, rv, Mc(rv))
            k = m.saddle_coarse_inner
            if k <= 0:
                coarse_solve = M_in
            else:
                def coarse_solve(rc):
                    zc, _ = gmres(cmat, rc, torch.zeros_like(rc), M=M_in, flexible=True,
                                  m=k, itmax=k, atol=0.0, rtol=1e-2)
                    return zc

        def correct(A, r, z):
            # multiplicative two-level step: block pre-smooth, then the
            # geostrophic coarse correction
            return z + prolong(coarse_solve(restrict(r - A(z)))) * free_inv

        return correct

    # ------------------------------------------------------------------
    @scoped_method
    def multi_step(self, dd: dict, n: int):
        """``n`` steps: (dd, auxs) with ``auxs[key]`` a length-n numpy
        array (a Python loop in place of the JAX ``lax.scan``)."""
        auxs = {k: [] for k in AUX_KEYS}
        for _ in range(n):
            dd, aux = self.step(dd)
            for k in AUX_KEYS:
                auxs[k].append(aux[k])
        return dd, {k: np.asarray(v) for k, v in auxs.items()}

    @scoped_method
    def refresh_precond(self, dd: dict) -> dict:
        """DD counterpart of ``PGModel.refresh_precond``: rebuild every
        nu-dependent preconditioner table from the CURRENT eddy viscosity
        and reshard it (the smoother block and its diagonal, the coarse
        saddle tensors, the replicated bounds and coarse inverses), and
        the state's own inversion blocks.  Returns the new dd state;
        without the eddy closure it returns ``dd``."""
        m = self.model
        if not self.eddy_on:
            return dd
        m.ops = m.refresh_precond(m.ops, self.from_dd(dd))
        ops, T, t = m.ops, self._T, self.tables
        t["visc_e"] = T(self._reorder_cells(ops["visc_e"]))
        t["visc_dinv"] = T(self._vec_dd(ops["visc_dinv"], self.part_u, 3))
        tr = {"lmax_u": float(ops["lmax_u"])}
        if self.has_saddle_coarse:
            if "sc_inv" in self.tables_repl:
                tr["sc_inv"] = ops["saddle_coarse_inv"]
            else:
                for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp", "sc_visc_e"):
                    t[k] = T(self._reorder_cells(ops[k]))
                tr["sc_pin"] = ops["sc_pin"]
                tr["sc_sigma"] = ops["sc_sigma"]
                tr["sc_lmax"] = float(ops["sc_lmax"])
                tr["cvisc_dinv"] = ops["sc_visc_dinv"]
                if "sc2_inv" in self.tables_repl:
                    tr["sc2_inv"] = ops["sc2_inv"]
        self.tables_repl = {**self.tables_repl, **self._replicate(tr)}
        out = dict(dd)
        for k in EDDY_KEYS:
            out[k] = T(self._reorder_cells(ops[k]))
        return out

    @scoped_method
    def run(self, state, max_steps: int = None, n_info: int = 10, n_save=None,
            save_callback=None, steps_per_block: int = 1, n_precond_refresh: int = None,
            log=print) -> State:
        """Run loop over the sharded state: blocked dispatch, blow-up
        guard and the reference's progress block (field parity with
        ``PGModel.run``, reference src/model.jl:90-211).

        ``state`` may be a ``State`` or a dd state (e.g. from
        ``load_checkpoint``).  ``save_callback(dd_model, dd_state, step)``
        runs every ``n_save`` steps.  Every branch reads values that are
        the same on every rank."""
        dd = state if isinstance(state, dict) else self.to_dd(state)
        t_stop = float(self.model.ts.t_stop)
        t0 = t_last = time.time()
        i = i0 = last_refresh = int(dd["step"])
        while float(dd["t"]) < t_stop:
            if steps_per_block > 1:
                dd, auxs = self.multi_step(dd, steps_per_block)
                aux = {k: v[-1].item() for k, v in auxs.items()}
                i += steps_per_block
            else:
                dd, aux = self.step(dd)
                i += 1
            u_max, b_max = aux["u_max"], aux["b_max"]
            if max(u_max, b_max) > 1e3 or np.isnan(u_max) or np.isnan(b_max):
                raise BlowUpError(f"Blow-up detected at step {i}: "
                                  f"|u|max={u_max:.3e} |b|max={b_max:.3e}")
            if n_info and i % n_info == 0:
                t1 = time.time()
                log(progress_message(i, i0, n_info, float(dd["t"]), float(dd["dt"]), t_stop,
                                     t1 - t0, t1 - t_last, aux))
                t_last = t1
                sys.stdout.flush()
            if n_save and i % n_save == 0 and save_callback is not None:
                save_callback(self, dd, i)
            # steps since the last refresh, not a modulo: robust to block
            # sizes that do not divide the cadence
            if n_precond_refresh and i - last_refresh >= n_precond_refresh and self.eddy_on:
                dd = self.refresh_precond(dd)
                last_refresh = i
            if max_steps is not None and i >= int(max_steps):
                break
        return self.from_dd(dd)

    # ------------------------------------------------------------------
    # sharded checkpoints, in the JAX DDModel's keys and layout: each
    # rank writes and reads only its own shards
    # ------------------------------------------------------------------
    def _ckpt_path(self, path: str) -> str:
        g = self.group
        return f"{path}.proc{g.rank}" if g.world > 1 else path

    def save_checkpoint(self, dd: dict, path: str) -> None:
        """Write this rank's shards of ``dd`` to ``path`` (npz; with more
        than one rank, ``path.procK``): ``scalar:<key>`` for t, dt and
        step, ``shard:<key>:<offset>`` for each shard's block at its
        offset along the global first axis."""
        data = {"scalar:t": _host(dd["t"]), "scalar:dt": _host(dd["dt"]),
                "scalar:step": np.asarray(dd["step"], np.int32)}
        for k in VEC_KEYS + (EDDY_KEYS if self.eddy_on else ()):
            v = _host(dd[k])
            if k in EDDY_KEYS:
                v = v[:, None, : self.nc_max]  # the JAX package's cell count
            for j, s in enumerate(self.own):
                data[f"shard:{k}:{s * v.shape[1]}"] = v[j]
        np.savez_compressed(self._ckpt_path(path), **data)

    def load_checkpoint(self, path: str) -> dict:
        """This rank's dd state from a ``save_checkpoint`` file (of
        either package, with the same shard count and rank layout)."""
        p = self._ckpt_path(path)
        if not p.endswith(".npz"):
            p = p + ".npz"
        f = np.load(p)
        blocks_ = {}
        for name in f.files:
            kind, rest = name.split(":", 1)
            if kind == "shard":
                k, start = rest.rsplit(":", 1)
                blocks_.setdefault(k, {})[int(start)] = f[name]
        T = self._T
        dd = {"t": T(f["scalar:t"]), "dt": T(f["scalar:dt"]), "step": int(f["scalar:step"])}
        for k, bl in blocks_.items():
            n = next(iter(bl.values())).shape[0]
            own = np.stack([bl[s * n] for s in self.own])
            if k in EDDY_KEYS:
                own = own[:, 0]
                pad = self.nc_pad - own.shape[1]
                own = np.pad(own, [(0, 0), (0, pad)] + [(0, 0)] * (own.ndim - 2))
            dd[k] = T(own)
        return dd
