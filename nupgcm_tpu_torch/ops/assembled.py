"""Operators assembled into node-pair blocks.

    y = sum_e P_e^T A_e P_e x

Element-local tensors hold each node pair once per cell that shares it
(about 5.5 tets a vertex); the assembled form holds it once: one block
per pair (i, j) of a row node and a column node that share a cell, in
CSR order.  The operators here apply their blocks through the block
kernel of ``ops/kernels.py`` (``csrc/vertex_block_matvec.cu`` on a CUDA
device, the plain version on the CPU), over the same vectors as the
element ``SaddleOperator`` they stand for:

* ``vertex_pattern`` -- the layout, built once per mesh on the dof
  tables' device (``torch.unique`` of the cells' pair keys): row
  pointers, column ids, each block's row, and each element entry's
  block (``slot``).  Square over the vertices (the P1 operators), or
  rectangular: P2 velocity nodes against vertices (the P2-P1 coupling).
* ``AssembledSaddle`` -- the P1-P1 coarse saddle: one 4x4 block per
  vertex pair, rows [u_x, u_y, u_z, p] of vertex i against the same
  columns of vertex j, in modes "full_pp" (``matvec``) and "up"
  (``up_matvec``, from its own contiguous (n_blocks, 3) copy of the
  pressure-gradient columns).
* ``AssembledBlocks`` -- one operator in one mode: "uu", a P1 vector
  velocity block (3x3 blocks over the vertex pattern; the coarse level's
  velocity block and viscous smoother, the
  u-block two-grid's coarse level), or "up", the P2-P1 inversion
  operator's pressure coupling (3x1 blocks, rows u_x, u_y, u_z of a P2
  node against a vertex).

Each operator's blocks are allocated once and scattered from the
element tensors by ``index_add_`` over ``slot`` (``fill``, in place,
whenever the model's element tensors change); its kernel launch is
prepared on first use.  A model holds one operator per element tensor
for its every solve.  ``diagonal`` reads the element tensors of the last
``fill``, as the element ``SaddleOperator`` does, so both give the same
bits.

Padded cells carry zero tensors and repeat node 0 (models/fedata.py),
so they add zeros to an existing block.  A periodic slave vertex (and
its P2 nodes) appears in no cell: its row holds no block and its
outputs are zero, as the element path leaves them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import kernels
from .element import saddle_diagonal


@dataclass
class VertexPattern:
    """The node-pair blocks of a row and a column cell dof table, sorted
    by row then column."""

    n_rows: int            # row nodes
    n_cols: int            # column nodes
    sizes: tuple           # (nl_r, nl_c): local sizes of the row and column dof tables
    row_ptr: torch.Tensor  # (n_rows + 1,) int32 block offsets of the rows
    col: torch.Tensor      # (n_blocks,) int32 column node of each block
    row: torch.Tensor      # (n_blocks,) int32 row node of each block
    slot: torch.Tensor     # (nc, nl_r * nl_c) int32 block of element entry (cell, a, b)

    @property
    def n_blocks(self) -> int:
        return self.col.shape[0]


def vertex_pattern(cd: torch.Tensor, n_rows: int, cd_c: torch.Tensor = None,
                   n_cols: int = None) -> VertexPattern:
    """The blocks of the row dof table ``cd`` (nc, nl_r) over ``n_rows``
    nodes against the column dof table ``cd_c`` (nc, nl_c) over
    ``n_cols`` nodes (by default ``cd`` and ``n_rows`` again: the square
    vertex pattern), on ``cd``'s device: every pair (cd[c, a],
    cd_c[c, b]) of a cell is one block, and slot[c, a * nl_c + b] is its
    index."""
    cd_c, n_cols = (cd, n_rows) if cd_c is None else (cd_c, n_cols)
    nc, nl_r = cd.shape
    nl_c = cd_c.shape[1]
    keys = (cd.long()[:, :, None] * n_cols + cd_c.long()[:, None, :]).reshape(-1)
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    del keys
    row = uniq // n_cols
    counts = torch.bincount(row, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=cd.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    i32 = lambda t: t.to(torch.int32).contiguous()
    return VertexPattern(n_rows=n_rows, n_cols=n_cols, sizes=(nl_r, nl_c),
                         row_ptr=i32(row_ptr), col=i32(uniq - row * n_cols), row=i32(row),
                         slot=i32(inverse.reshape(nc, nl_r * nl_c)))


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


class _Applies:
    """The launch of a block operator: the plain version through the
    wrapper on the CPU; on a CUDA device one ``VBlockLaunch`` a mode,
    prepared on first use."""

    def _apply(self, vals, x, mode):
        p = self.pattern
        if not x.is_cuda:
            return kernels.vblock_matvec(vals, p.col, p.row_ptr, p.row, x, mode, p.n_cols)
        launch = self._launches.get(mode)
        if launch is None:
            launch = self._launches[mode] = kernels.VBlockLaunch(
                vals, p.col, p.row_ptr, mode, p.sizes, p.n_cols)
        return launch(x)


class AssembledSaddle(_Applies):
    """The P1-P1 saddle operator over the combined (u, p) vector of the
    coarse level (u node-major over the vertices, then p), applied from
    its vertex blocks: ``vals`` (n_blocks, 16), and the pressure-gradient
    columns again as ``up_vals`` (n_blocks, 3), which "up" reads instead
    of the whole block."""

    def __init__(self, pattern: VertexPattern, cd: torch.Tensor, dtype: torch.dtype):
        nb, device = pattern.n_blocks, pattern.col.device
        self.pattern, self.cd = pattern, cd
        self.n_u_nodes = self.n_p = pattern.n_rows
        self.vals = torch.zeros((nb, 16), dtype=dtype, device=device)
        self.up_vals = torch.zeros((nb, 3), dtype=dtype, device=device)
        self.uu = self.pp = None
        self._launches = {}

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
        return self._apply(self.vals, x, "full_pp")

    def up_matvec(self, p_vec: torch.Tensor) -> torch.Tensor:
        """Coupling block alone: velocity rows of [0, up; 0, 0] @ [0; p]."""
        return self._apply(self.up_vals, p_vec, "up")

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal: velocity (3 n_rows), then pressure."""
        return saddle_diagonal(self.uu, self.pp, self.cd, self.n_u_nodes, self.cd, self.n_p)


class AssembledBlocks(_Applies):
    """One element operator applied from its blocks in ``mode``:

    "uu": a P1 vector velocity operator over u (3 n_rows, node-major,
          the layout of the coarse correction vectors) from element
          tensors (nc, 3 nl, 3 nl) over the row dof table ``cd``; 3x3
          blocks ``vals`` (n_blocks, 9), row-major.
    "up": a pressure coupling, u rows (3 n_rows) from p (n_cols), from
          element tensors (nc, 3 nl_r, nl_c) (the P2-P1 ``A_up_e``); 3x1
          blocks ``vals`` (n_blocks, 3)."""

    def __init__(self, pattern: VertexPattern, mode: str, dtype: torch.dtype,
                 cd: torch.Tensor = None):
        self.pattern, self.mode, self.cd = pattern, mode, cd
        self.vals = torch.zeros((pattern.n_blocks, kernels.VBLOCK_WIDTH[mode]), dtype=dtype,
                                device=pattern.col.device)
        self.e = None
        self._launches = {}

    def fill(self, e) -> "AssembledBlocks":
        """Scatter the element tensor ``e`` into the blocks (``index_add_``
        over ``slot``), in place; returns ``self``."""
        nc = e.shape[0]
        nl_r, nl_c = self.pattern.sizes
        if self.mode == "uu":
            eb = e.reshape(nc, nl_r, 3, nl_c, 3).permute(0, 1, 3, 2, 4).reshape(-1, 9)
        else:
            eb = e.reshape(nc, nl_r, 3, nl_c).permute(0, 1, 3, 2).reshape(-1, 3)
        self.vals.zero_().index_add_(0, self.pattern.slot.reshape(-1).long(), eb)
        self.e = e
        return self

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._apply(self.vals, x, self.mode)

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal of a "uu" operator (3 n_rows)."""
        return saddle_diagonal(self.e, None, self.cd, self.pattern.n_rows)
