"""Assembled sparse matrices and the Dirichlet-masked operator.

PyTorch counterpart of ``nupgcm_tpu.ops.sparse``.  ``COOMatrix`` is a
sorted-COO (CSR-ordered) matrix whose SpMV is a gather, a multiply and
one ``index_add_`` over the rows; ``ELLMatrix`` pads every row to one
width, so its SpMV is a 2D gather and a row sum.  Both run on the
device of their tensors.  The step never assembles a matrix (every
operator is element-local, ``ops/element.py``): these serve
diagnostics, SciPy export and the reference's assembled-matrix
regressions, with values from ``fem.assembly.MatrixPlan``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class COOMatrix:
    """Sorted-COO sparse matrix (row-major order)."""

    rows: torch.Tensor  # (nnz,) int64, sorted
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float
    shape: tuple        # (n_rows, n_cols)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        prod = self.vals * x[self.cols]
        return prod.new_zeros(self.shape[0]).index_add_(0, self.rows, prod)

    def diagonal(self) -> torch.Tensor:
        d = torch.where(self.rows == self.cols, self.vals, 0.0)
        return d.new_zeros(self.shape[0]).index_add_(0, self.rows, d)

    def with_vals(self, vals: torch.Tensor) -> "COOMatrix":
        return COOMatrix(rows=self.rows, cols=self.cols, vals=vals, shape=self.shape)

    def to_scipy(self):
        """scipy CSR on the host (duplicate entries summed)."""
        import scipy.sparse as sp

        return sp.csr_matrix((self.vals.cpu().numpy(), (self.rows.cpu().numpy(),
                                                        self.cols.cpu().numpy())),
                             shape=self.shape)


def coo_from_plan(plan, vals: torch.Tensor) -> COOMatrix:
    """Bind assembled nnz values to a MatrixPlan's structure, on the
    values' device."""
    index = lambda a: torch.as_tensor(a, dtype=torch.int64, device=vals.device)
    return COOMatrix(rows=index(plan.rows), cols=index(plan.cols), vals=vals,
                     shape=(plan.n_rows, plan.n_cols))


@dataclass
class ELLMatrix:
    """Fixed-width padded rows: cols/vals (n_rows, width).

    Padding entries point at column 0 with value 0.  SpMV is a 2D
    gather and a row reduction."""

    cols: torch.Tensor  # (n, w) int64
    vals: torch.Tensor  # (n, w)
    shape: tuple

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("nw,nw->n", self.vals, x[self.cols])

    def diagonal(self) -> torch.Tensor:
        row = torch.arange(self.shape[0], device=self.cols.device)[:, None]
        return torch.where(self.cols == row, self.vals, 0.0).sum(dim=1)


def ell_from_coo(rows: np.ndarray, cols: np.ndarray, n_rows: int = None):
    """Host: the static ELL layout of a sorted-COO structure.

    Returns (ell_cols (n, w) int32, slot_map (nnz,) int32, w), where
    ``vals_ell.reshape(-1)[slot_map[k]] = coo_vals[k]`` fills the
    values."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    n = n_rows if n_rows is not None else int(rows.max()) + 1
    counts = np.bincount(rows, minlength=n)
    w = int(counts.max())
    ell_cols = np.zeros((n, w), dtype=np.int32)
    # rows sorted: position within a row = running index
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot_map = rows.astype(np.int64) * w + (np.arange(len(rows)) - starts[rows])
    ell_cols.reshape(-1)[slot_map] = cols
    return ell_cols, slot_map.astype(np.int32), w


class MaskedOperator:
    """Dirichlet-pinned linear operator over full dof vectors.

    op(x) = A x on free dofs, identity on constrained dofs.  This keeps
    full-length vectors (no free-dof compaction) while being
    mathematically the reference's free-dof system + lift
    (src/evolution.jl:256-260).
    """

    def __init__(self, mat, free_mask: torch.Tensor):
        self.mat = mat
        self.free = free_mask  # float 0/1
        self.free_bool = free_mask.bool()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mat.matvec(x * self.free)
        return torch.where(self.free_bool, y, x)

    def diagonal(self) -> torch.Tensor:
        d = self.mat.diagonal()
        return torch.where(self.free_bool, d, torch.ones_like(d))
