"""Dirichlet-masked operator over full dof vectors."""

from __future__ import annotations

import torch


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
