"""The least device time of the operators a step applies.

Each operator application is counted at the operator's Python entry
point, whatever kernel then runs (the element kernel K1/K2, the
assembled vertex-block kernel, a dense matrix product), and its work is
reckoned from what is applied, never from how: the values of the
operator's assembled nonzeros, once, at the operator's dtype, plus x
read once and y written once; no index bytes; two flops a nonzero.  The
nonzeros are counted here from the mesh (node pairs that share a cell)
and the weak forms (which velocity components a block couples).  The
least time of an application is the larger of its bytes over the HBM
bandwidth and its flops over the float32 peak of one H100.

A layout that stores less than the assembled values (a symmetric half,
a matrix-free application) would make this count stale; correcting it
then takes a change to the benchmark.
"""

from __future__ import annotations

import weakref
from collections import Counter

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet, at its 700 W limit
PEAK_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TET_EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def pair_counts(cells, n_vertices) -> dict:
    """Node counts and the node pairs that share a cell: ``n2`` P2 nodes,
    ``n1`` vertices, ``N22`` (P2 x P2), ``N21`` (P2 x vertex) and
    ``N11`` (vertex x vertex) pairs, each pair ordered and counted once."""
    cells = np.asarray(cells, np.int64)
    nv = int(n_vertices)
    pairs = np.sort(cells[:, list(TET_EDGES)].reshape(-1, 2), axis=1)
    edges, inv = np.unique(pairs, axis=0, return_inverse=True)
    n2 = nv + len(edges)
    cd2 = np.hstack([cells, nv + inv.reshape(len(cells), -1)])

    def n_pairs(rows, cols, n_cols):
        keys = (rows[:, :, None] * np.int64(n_cols) + cols[:, None, :]).ravel()
        return len(np.unique(keys))

    return {"n2": n2, "n1": nv, "N22": n_pairs(cd2, cd2, n2), "N21": n_pairs(cd2, cells, nv),
            "N11": n_pairs(cells, cells, nv)}


class OperatorWork:
    """Counts the operator applications of one model and their least
    device time, as a subscriber of ``hooks.Hooks``."""

    def __init__(self, model, counts: dict, variable_nu: bool):
        self.model, self.c = model, counts
        # velocity components a velocity block couples: the viscous
        # term's diagonal, plus f (zhat x u) between u and v; all nine
        # where nu varies (the symmetric-gradient form)
        self.cuu = 9 if variable_nu else 5
        self.calls = Counter()
        self._seen = {}

    # -- what an application is -------------------------------------
    def _key(self, tensor):
        for k, v in self.model.ops.items():
            if v is tensor:
                return k
        return None

    def _held_key(self, op):
        for k, v in getattr(self.model, "_held", {}).items():
            if v is op:
                return k
        return None

    def _velocity(self, key, pairs):
        """(nnz) of a velocity-only block by the element tensor it holds."""
        if key in ("A_uu_e", "sc_uu"):
            return self.cuu * pairs
        if key in ("visc_e", "sc_visc_e", "coarse_e"):
            return 3 * pairs          # the SPD surrogate is diagonal in components
        return None

    def kind(self, op, method):
        """(name, nnz, rows, cols, itemsize) of one application, or None
        for an operator this count does not know."""
        c = self.c
        name = type(op).__name__
        if name == "SaddleOperator":
            item = op.uu.element_size() if op.uu is not None else op.up.element_size()
            p2 = op.n_u_nodes == c["n2"]
            nn, nu_rows = (c["N22"], c["N21"]) if p2 else (c["N11"], c["N11"])
            nu = 3 * op.n_u_nodes
            if method == "up_matvec":
                return ("coupling" if p2 else "coarse_coupling", 3 * nu_rows, nu, op.n_p, item)
            if op.up is None:
                nnz = self._velocity(self._key(op.uu), nn)
                return None if nnz is None else (self._key(op.uu), nnz, nu, nu, item)
            nnz = self.cuu * nn + 6 * nu_rows + (0 if op.pp is None else nn)
            n = nu + op.n_p
            return ("inversion" if p2 else "coarse_saddle", nnz, n, n, item)
        if name == "ElementOperator":
            pairs = {c["n2"]: c["N22"], c["n1"]: c["N11"]}.get(op.n)
            nm = "evolution" if op.n == c["n2"] else "pressure_mass"
            return None if pairs is None else (nm, pairs, op.n, op.n, op.Ae.element_size())
        if name == "AssembledBlocks":
            key, item = self._held_key(op), op.vals.element_size()
            if op.mode == "scalar":
                return ("pressure_mass", c["N11"], c["n1"], c["n1"], item)
            if op.mode == "up":
                return ("coupling", 3 * c["N21"], 3 * c["n2"], c["n1"], item)
            nnz = self._velocity(key, c["N11"])
            return None if nnz is None else (key, nnz, 3 * c["n1"], 3 * c["n1"], item)
        if name == "AssembledSaddle":
            item = op.vals.element_size()
            if method == "up_matvec":
                return ("coarse_coupling", 3 * c["N11"], 3 * c["n1"], c["n1"], item)
            n = 4 * c["n1"]
            return ("coarse_saddle", (self.cuu + 7) * c["N11"], n, n, item)
        if name in ("SaddleCoarseCorrection", "CoarseCorrection"):
            inv = self.model.ops.get("saddle_coarse_inv" if name[0] == "S" else "coarse_inv")
            if inv is None:      # an iterative coarse solve: its operators count
                return ("coarse_correction", 0, 0, 0, 0)
            return ("dense_coarse", inv.numel(), inv.shape[0], inv.shape[1], inv.element_size())
        if name == "AggregateCoarseCorrection":
            return ("aggregate_level", op.inv.numel(), op.inv.shape[0], op.inv.shape[1],
                    op.inv.element_size())
        return None

    # -- counting (a subscriber of ``hooks.Hooks``) --------------------
    def __call__(self, op, meth, args, result):
        # an operator is classified once (the model builds some anew
        # each solve; a weak reference tells a reused id apart)
        hit = self._seen.get((id(op), meth))
        if hit is None or hit[0]() is not op:
            hit = self._seen[(id(op), meth)] = (weakref.ref(op), self.kind(op, meth))
        self.calls[hit[1]] += 1

    def reset(self):
        self.calls.clear()

    def summary(self) -> dict:
        """{kind: {"calls", "bytes", "flops", "least_s"}} over the counted
        applications; operators this count does not know under
        "unknown", with no work."""
        out = {}
        for k, n in self.calls.items():
            name, nnz, rows, cols, item = k if k is not None else ("unknown", 0, 0, 0, 0)
            bytes_ = (nnz + rows + cols) * item
            flops = 2 * nnz
            rec = out.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0, "least_s": 0.0})
            rec["calls"] += n
            rec["bytes"] += n * bytes_
            rec["flops"] += n * flops
            rec["least_s"] += n * max(bytes_ / HBM_BYTES_PER_S, flops / PEAK_FLOPS)
        return out


def least_seconds(summary: dict) -> float:
    return sum(v["least_s"] for v in summary.values())
