"""Element-local (matrix-free) operators.

    y = sum_e  P_e^T ( A_e  (P_e x) )

The element tensors are exactly the ones the assembly produces
(fem/assembly.py); no sparse matrix is ever assembled.  ``matvec`` and
``up_matvec`` go through the kernel wrappers of ``ops/kernels.py``
(the CUDA kernels on a CUDA device, their plain versions on the CPU);
``diagonal`` is plain PyTorch, computed when a preconditioner is built.

An operator checks its tensors' shapes and types once, at
construction.  On a CUDA device it also prepares its kernel launch
there (``kernels.saddle_launch`` / ``scalar_launch``) over the block
tables it is given (``ops/blocks.py``; the model builds them once with
its constants), so each application costs one ctypes call.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import blocks, kernels


@dataclass
class ElementOperator:
    """Square scalar-space operator.

    Ae: (nc, nl, nl) element matrices
    cd: (nc, nl) int32 global dofs (rows = cols)
    n:  dof count
    """

    Ae: torch.Tensor
    cd: torch.Tensor
    n: int
    table: blocks.BlockTable = None  # built here when None (CUDA only)
    _launch: kernels.PreparedLaunch = field(default=None, init=False, repr=False)

    def __post_init__(self):
        kernels.check_scalar(self.Ae, self.cd)
        if self.Ae.is_cuda:
            if self.table is None:
                self.table = blocks.scalar_table(self.cd, self.Ae.element_size())
            self._launch = kernels.scalar_launch(self.Ae, self.table, self.n)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self._launch is not None:
            return self._launch(x)
        return kernels.scalar_matvec(self.Ae, self.cd, x)

    def diagonal(self) -> torch.Tensor:
        de = torch.diagonal(self.Ae, dim1=1, dim2=2)
        return self.Ae.new_zeros(self.n).index_add_(0, self.cd.reshape(-1).long(), de.reshape(-1))


@dataclass
class SaddleOperator:
    """Element-local operator over the combined (u, p) vector with the
    node-major velocity layout (dof = 3*node + comp).

    uu: (nc, 3*nlu, 3*nlu);  up: (nc, 3*nlu, nlp);  pu: (nc, nlp, 3*nlu)
    (up/pu None for velocity-only operators, e.g. the preconditioner's
    viscous block).  ``pp`` is an optional (nc, nlp, nlp)
    pressure-pressure block (zero for the plain saddle system; the
    Brezzi-Pitkaranta stabilization of the P1-P1 coarse system lives
    there).
    cd_u: (nc, nlu) int32 velocity node ids
    cd_p: (nc, nlp) int32 pressure dof ids (nlp may be 0)
    n_u_nodes: velocity node count
    n_p: pressure dof count (0 for velocity-only operators)
    """

    uu: torch.Tensor
    up: torch.Tensor
    pu: torch.Tensor
    cd_u: torch.Tensor
    cd_p: torch.Tensor
    n_u_nodes: int
    n_p: int = 0
    pp: torch.Tensor = None
    tables: dict = None  # {mode: (velocity, pressure) block tables}; built when None (CUDA)
    _launch: kernels.PreparedLaunch = field(default=None, init=False, repr=False)
    _up_launch: kernels.PreparedLaunch = field(default=None, init=False, repr=False)

    @property
    def mode(self) -> str:
        if self.up is None:
            return "uu"
        return "full" if self.pp is None else "full_pp"

    def __post_init__(self):
        kernels.check_saddle(self.uu, self.up, self.pu, self.pp, self.cd_u, self.cd_p,
                             self.mode)
        if self.uu.is_cuda:
            if self.tables is None:
                modes = (self.mode,) if self.up is None else (self.mode, "up")
                self.tables = blocks.operator_tables(self.cd_u, self.cd_p, modes,
                                                     self.uu.element_size())
            self._launch = kernels.saddle_launch(self.uu, self.up, self.pu, self.pp,
                                                 self.tables[self.mode], self.mode,
                                                 self.n_u_nodes, self.n_p)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self._launch is not None:
            return self._launch(x)
        return kernels.saddle_matvec(self.uu, self.up, self.pu, self.pp,
                                     self.cd_u, self.cd_p, x, self.mode, self.n_u_nodes)

    def up_matvec(self, p_vec: torch.Tensor) -> torch.Tensor:
        """Coupling block alone: velocity rows of [0, up; 0, 0] @ [0; p]
        (the pressure-gradient term).  Used by the block-triangular
        Stokes preconditioner."""
        if self._launch is None:
            return kernels.saddle_matvec(None, self.up, None, None, self.cd_u,
                                         self.cd_p, p_vec, "up", self.n_u_nodes)
        if self._up_launch is None:
            self._up_launch = kernels.saddle_launch(None, self.up, None, None,
                                                    self.tables["up"], "up", self.n_u_nodes,
                                                    self.n_p)
        return self._up_launch(p_vec)

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal: velocity (3 n_u_nodes), then pressure
        (n_p) when the operator has a pressure block."""
        du_e = torch.diagonal(self.uu, dim1=1, dim2=2).reshape(-1, 3)
        du = self.uu.new_zeros((self.n_u_nodes, 3)).index_add_(
            0, self.cd_u.reshape(-1).long(), du_e).reshape(-1)
        if self.up is None:
            return du
        dp = self.uu.new_zeros(self.n_p)
        if self.pp is not None:
            dp.index_add_(0, self.cd_p.reshape(-1).long(),
                          torch.diagonal(self.pp, dim1=1, dim2=2).reshape(-1))
        return torch.cat([du, dp])
