"""The P1-P1 coarse saddle operator, assembled into vertex blocks.

    y = sum_e P_e^T A_e P_e x

Element-local tensors hold each vertex pair once per cell that shares
it (about 5.5 tets a vertex, 16^2 values a tet); the assembled form
holds it once: one 4x4 block per vertex pair (i, j) that shares a cell,
rows [u_x, u_y, u_z, p] of vertex i against the same columns of vertex
j, in CSR order.  ``AssembledSaddle`` applies it through the vertex-
block kernel of ``ops/kernels.py`` (``csrc/vertex_block_matvec.cu`` on
a CUDA device, the plain version on the CPU) in the element
``SaddleOperator``'s modes "full_pp" (``matvec``) and "up"
(``up_matvec``), over the same vectors.

* ``vertex_pattern`` -- the layout, built once per mesh on the dof
  table's device (``torch.unique`` of the cells' pair keys): row
  pointers, column ids, each block's row, and each element entry's
  block (``slot``).
* ``AssembledSaddle`` -- the operator: the blocks' values, scattered
  from the element tensors by ``index_add_`` over ``slot`` (``fill``,
  in place, whenever the model's element tensors change), and the
  pressure-gradient columns again as their own contiguous (n_blocks, 3)
  copy, which "up" reads instead of the whole block.  A model holds one
  for its every solve, with its kernel launches prepared once.

Padded cells carry zero tensors and repeat vertex 0 (models/fedata.py),
so they add zeros to an existing block.  A periodic slave vertex appears
in no cell: its row holds no block and its outputs are zero, as the
element path leaves them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kernels
from .element import saddle_diagonal


@dataclass
class VertexPattern:
    """The vertex-pair blocks of a P1 cell dof table, sorted by row
    then column."""

    n_rows: int            # vertices
    row_ptr: torch.Tensor  # (n_rows + 1,) int32 block offsets of the rows
    col: torch.Tensor      # (n_blocks,) int32 column vertex of each block
    row: torch.Tensor      # (n_blocks,) int32 row vertex of each block
    slot: torch.Tensor     # (nc, nl * nl) int32 block of element entry (cell, a, b)

    @property
    def n_blocks(self) -> int:
        return self.col.shape[0]


def vertex_pattern(cd: torch.Tensor, n_rows: int) -> VertexPattern:
    """The blocks of the cell dof table ``cd`` (nc, nl) over ``n_rows``
    vertices, on ``cd``'s device: every pair (cd[c, a], cd[c, b]) of a
    cell is one block, and slot[c, a * nl + b] is its index."""
    nc, nl = cd.shape
    cdl = cd.long()
    keys = (cdl[:, :, None] * n_rows + cdl[:, None, :]).reshape(-1)
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    row = uniq // n_rows
    counts = torch.bincount(row, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=cd.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    i32 = lambda t: t.to(torch.int32).contiguous()
    return VertexPattern(n_rows=n_rows, row_ptr=i32(row_ptr), col=i32(uniq - row * n_rows),
                         row=i32(row), slot=i32(inverse.reshape(nc, nl * nl)))


def element_blocks(uu, up, pu, pp) -> torch.Tensor:
    """The element tensors of a P1-P1 saddle operator as (nc, nl, nl, 4, 4)
    vertex-pair blocks: entry (c, a, b) holds rows [u_x, u_y, u_z, p] of
    local vertex a against the same columns of local vertex b."""
    nc, nl = pp.shape[:2]
    e = uu.new_empty((nc, nl, nl, 4, 4))
    e[..., :3, :3] = uu.reshape(nc, nl, 3, nl, 3).permute(0, 1, 3, 2, 4)
    e[..., :3, 3] = up.reshape(nc, nl, 3, nl).permute(0, 1, 3, 2)
    e[..., 3, :3] = pu.reshape(nc, nl, nl, 3)
    e[..., 3, 3] = pp
    return e


class AssembledSaddle:
    """The P1-P1 saddle operator over the combined (u, p) vector of the
    coarse level (u node-major over the vertices, then p), applied from
    its vertex blocks: ``vals`` (n_blocks, 16), and the pressure-gradient
    columns again as ``up_vals`` (n_blocks, 3), which "up" reads instead
    of the whole block.  One operator serves a model's every solve: its
    blocks are allocated once, ``fill`` rewrites them in place, and its
    kernel launches are prepared on first use.  ``diagonal`` reads the
    element tensors of the last ``fill``, as the element
    ``SaddleOperator`` does, so both give the same bits."""

    def __init__(self, pattern: VertexPattern, cd: torch.Tensor, dtype: torch.dtype):
        nb, device = pattern.n_blocks, pattern.col.device
        self.pattern, self.cd = pattern, cd
        self.n_u_nodes = self.n_p = pattern.n_rows
        self.vals = torch.zeros((nb, 16), dtype=dtype, device=device)
        self.up_vals = torch.zeros((nb, 3), dtype=dtype, device=device)
        self.uu = self.pp = None
        self._launch = self._up_launch = None

    def fill(self, uu, up, pu, pp) -> "AssembledSaddle":
        """Scatter these element tensors into the blocks (``index_add_``
        over ``slot``), in place; returns ``self``."""
        e = element_blocks(uu, up, pu, pp).reshape(-1, 16)
        nb = self.pattern.n_blocks
        self.vals.zero_().index_add_(0, self.pattern.slot.reshape(-1).long(), e)
        self.up_vals.copy_(self.vals.view(nb, 4, 4)[:, :3, 3])
        self.uu, self.pp = uu, pp
        return self

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda:
            return self._plain(self.vals, x, "full_pp")
        if self._launch is None:
            self._launch = kernels.VBlockLaunch(self.vals, self.pattern.col,
                                                self.pattern.row_ptr, "full_pp")
        return self._launch(x)

    def up_matvec(self, p_vec: torch.Tensor) -> torch.Tensor:
        """Coupling block alone: velocity rows of [0, up; 0, 0] @ [0; p]."""
        if not p_vec.is_cuda:
            return self._plain(self.up_vals, p_vec, "up")
        if self._up_launch is None:
            self._up_launch = kernels.VBlockLaunch(self.up_vals, self.pattern.col,
                                                   self.pattern.row_ptr, "up")
        return self._up_launch(p_vec)

    def _plain(self, vals, x, mode):
        p = self.pattern
        return kernels.vblock_matvec(vals, p.col, p.row_ptr, p.row, x, mode)

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal: velocity (3 n_rows), then pressure."""
        return saddle_diagonal(self.uu, self.pp, self.cd, self.n_u_nodes, self.cd, self.n_p)
