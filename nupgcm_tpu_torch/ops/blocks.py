"""Cell-block dof tables of the element-matvec kernel.

The kernel (``csrc/element_matvec.cu``) cuts the cells into blocks of
B contiguous cells.  For a cell dof table ``cd`` (nc, nl) and B, a
``BlockTable`` holds

* ``lists`` -- (nblk, list_stride) int32: each block's sorted unique
  dofs after a 4-entry header holding their count, padded (by repeating
  the last dof) to a common stride of 16-byte multiples, so that the
  kernel streams a block's list with one bulk copy from an address it
  computes, without reading an offset first;
* ``slot``  -- (nc, nl) each (cell, local slot)'s index into its
  block's list (int16), so ``cd[c, j] == lists[c // B, 4 + slot[c, j]]``;
  ``slot_blocks`` holds the same values block by block, each block's
  slice padded to ``slot_stride`` (a multiple of 8 entries, 16 bytes);
* ``max_count`` -- the longest list, which sizes the kernel's shared
  x and y tiles.

The cells keep the RCM order of ``models/fedata.py``, so a block's
cells share most of their nodes: the kernel gathers each unique x once
and adds each unique y once per block.  The tables depend on the dof
table alone; the model builds them once, next to ``cd_*`` in its
constants, and the element tensors rebuilt every step reuse them.

``blocked_saddle_plain`` and ``blocked_scalar_plain`` are the kernel's
blocked algorithm in plain PyTorch, reading only the tables: gather the
unique x of each block, apply the cell blocks, add per block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

STAGE_BYTES = 16 * 1024  # a block's element tensors (one of two shared-memory stages)
MAX_CELLS = 256          # cells per block (slots fit int16)
CELL_MULTIPLE = 4        # keeps every block's tensor slices 16-byte aligned
N_SM = 132               # H100 SXM streaming multiprocessors
MIN_BLOCKS = 4 * N_SM    # enough blocks to spread over every SM four times


HEADER = 4  # list entries before a block's dofs: the count, then padding


@dataclass(frozen=True)
class BlockTable:
    cells: int                 # B, cells per block
    nc: int
    nl: int
    lists: torch.Tensor        # int32 (nblk, list_stride): count, 0, 0, 0, dofs...
    slot: torch.Tensor         # int16 (nc, nl)
    slot_blocks: torch.Tensor  # int16 (nblk * slot_stride,)
    slot_stride: int
    max_count: int

    @property
    def nblk(self) -> int:
        return self.lists.shape[0]

    @property
    def list_stride(self) -> int:
        return self.lists.shape[1]

    @property
    def device(self) -> torch.device:
        return self.slot.device

    def block_lists(self, b: int) -> torch.Tensor:
        """Block ``b``'s sorted unique dofs."""
        return self.lists[b, HEADER:HEADER + int(self.lists[b, 0])]


def cells_per_block(nc: int, cell_bytes: int) -> int:
    """B for a table whose widest operator streams ``cell_bytes`` per
    cell: one stage of B cells within STAGE_BYTES, at least MIN_BLOCKS
    blocks where the mesh allows, a multiple of CELL_MULTIPLE."""
    m = CELL_MULTIPLE
    by_stage = STAGE_BYTES // max(cell_bytes, 1) // m * m
    per_block = -(-nc // MIN_BLOCKS)
    by_count = -(-per_block // m) * m
    return max(m, min(MAX_CELLS, by_stage, by_count))


def saddle_cell_bytes(mode: str, nlu: int, nlp: int, itemsize: int) -> int:
    """Element-tensor bytes per cell that saddle ``mode`` streams."""
    nu = 3 * nlu
    vals = {"full": nu * nu + 2 * nu * nlp, "full_pp": nu * nu + 2 * nu * nlp + nlp * nlp,
            "uu": nu * nu, "up": nu * nlp}[mode]
    return vals * itemsize


def build(cd, cells: int, device=None) -> BlockTable:
    """The block tables of ``cd`` (nc, nl) for blocks of ``cells``
    cells (host NumPy, once)."""
    if isinstance(cd, torch.Tensor):
        device = cd.device if device is None else device
        cd = cd.cpu().numpy()
    cd = np.asarray(cd, np.int64)
    nc, nl = cd.shape
    if cells <= 0 or cells > MAX_CELLS:
        raise ValueError(f"cells per block must be in 1..{MAX_CELLS}, got {cells}")
    nblk = -(-nc // cells)
    stride = -(-cells * nl // 8) * 8
    if nc == 0 or nl == 0:
        return BlockTable(cells, nc, nl,
                          _i32(np.zeros((nblk, HEADER)), device),
                          torch.zeros((nc, nl), dtype=torch.int16, device=device),
                          torch.zeros(nblk * stride, dtype=torch.int16, device=device),
                          stride, 0)
    span = int(cd.max()) + 1
    blk = np.arange(nc)[:, None] // cells
    keys, inv = np.unique(blk * span + cd, return_inverse=True)
    start = np.searchsorted(keys // span, np.arange(nblk + 1))
    counts = np.diff(start)
    slot = inv.reshape(nc, nl) - start[blk]
    # each block's list after its header, padded with its last dof
    width = HEADER + -(-int(counts.max()) // 4) * 4
    dofs = keys % span
    lists = np.repeat(dofs[start[1:] - 1][:, None], width, axis=1)
    lists[:, 0] = counts
    lists[:, 1:HEADER] = 0
    col = np.arange(len(dofs)) - np.repeat(start[:-1], counts) + HEADER
    lists[np.repeat(np.arange(nblk), counts), col] = dofs
    slot_blocks = np.zeros((nblk, stride), np.int16)
    flat = np.zeros(nblk * cells * nl, np.int64)
    flat[:nc * nl] = slot.reshape(-1)
    slot_blocks[:, :cells * nl] = flat.reshape(nblk, cells * nl)
    return BlockTable(cells, nc, nl, _i32(lists, device),
                      torch.as_tensor(slot.astype(np.int16), device=device),
                      torch.as_tensor(slot_blocks.reshape(-1), device=device), stride,
                      int(counts.max()))


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def saddle_tables(cd_u, cd_p, mode: str, itemsize: int, device=None):
    """(velocity table, pressure table) with the block size of saddle
    ``mode``; the pressure table is None in mode "uu"."""
    return operator_tables(cd_u, cd_p, (mode,), itemsize, device)[mode]


def operator_tables(cd_u, cd_p, modes, itemsize: int, device=None) -> dict:
    """{mode: (velocity table, pressure table or None)} for the saddle
    modes one operator family runs, each with its own block size (a
    mode that streams fewer bytes per cell takes more cells); modes with
    one block size share their tables."""
    nc, nlu = cd_u.shape
    nlp = cd_p.shape[1]
    out, by_cells = {}, {}
    for mode in modes:
        cells = cells_per_block(nc, saddle_cell_bytes(mode, nlu, nlp, itemsize))
        if cells not in by_cells:
            tu = build(cd_u, cells, device)
            by_cells[cells] = (tu, tu if cd_p is cd_u else build(cd_p, cells, device))
        tu, tp = by_cells[cells]
        out[mode] = (tu, None if mode == "uu" else tp)
    return out


def scalar_table(cd, itemsize: int, device=None) -> BlockTable:
    """The table of a scalar-space operator A (nc, nl, nl)."""
    nc, nl = cd.shape
    return build(cd, cells_per_block(nc, nl * nl * itemsize), device)


# ----------------------------------------------------------------------
# the blocked algorithm in plain PyTorch (reads only the tables)
# ----------------------------------------------------------------------

def _block_index(t: BlockTable) -> torch.Tensor:
    """(nc, nl) index of each (cell, slot) into ``t.lists`` flattened."""
    blk = torch.arange(t.nc, device=t.device) // t.cells
    return (blk * t.list_stride + HEADER)[:, None] + t.slot.long()


def _gather(t: BlockTable, x, ncomp: int):
    """Per (cell, slot) values of x through the block lists: (nc, nl*ncomp)."""
    xv = x.reshape(-1, ncomp)
    xs = xv[t.lists.reshape(-1).long().clamp(0, xv.shape[0] - 1)]  # each block's list, once
    return xs[_block_index(t)].reshape(t.nc, -1)


def _scatter(t: BlockTable, ye, n: int, ncomp: int):
    """Add per-cell rows ye (nc, nl*ncomp) into the block tiles, then
    each tile into y (n*ncomp) once per unique dof (the list entries
    past a block's count and the headers add zero tiles)."""
    ys = ye.new_zeros((t.lists.numel(), ncomp)).index_add_(
        0, _block_index(t).reshape(-1), ye.reshape(-1, ncomp))
    return ye.new_zeros((n, ncomp)).index_add_(
        0, t.lists.reshape(-1).long().clamp(0, n - 1), ys).reshape(-1)


def blocked_saddle_plain(uu, up, pu, pp, tu: BlockTable, tp: BlockTable, x, mode: str,
                         n_u_nodes: int):
    """``kernels.saddle_matvec``'s function computed as the kernel
    computes it, from the block tables ``tu`` (velocity) and ``tp``
    (pressure; None in mode "uu")."""
    n3 = 3 * n_u_nodes
    if mode != "up":
        xe_u = _gather(tu, x[:n3], 3)
    if mode != "uu":
        xp = x if mode == "up" else x[n3:]
        xe_p = _gather(tp, xp, 1)
    if mode == "uu":
        ye_u = torch.einsum("cij,cj->ci", uu, xe_u)
    elif mode == "up":
        ye_u = torch.einsum("cij,cj->ci", up, xe_p)
    else:
        ye_u = (torch.einsum("cij,cj->ci", uu, xe_u)
                + torch.einsum("cij,cj->ci", up, xe_p))
        ye_p = torch.einsum("cij,cj->ci", pu, xe_u)
        if mode == "full_pp":
            ye_p = ye_p + torch.einsum("cij,cj->ci", pp, xe_p)
    yu = _scatter(tu, ye_u, n_u_nodes, 3)
    if mode in ("uu", "up"):
        return yu
    return torch.cat([yu, _scatter(tp, ye_p, x.shape[0] - n3, 1)])


def blocked_scalar_plain(ae, t: BlockTable, x):
    """``kernels.scalar_matvec``'s function from the block table ``t``."""
    ye = torch.einsum("cij,cj->ci", ae, _gather(t, x, 1))
    return _scatter(t, ye, x.shape[0], 1)
