"""Spaces + FEData: the static finite-element setup bundle.

API parity with the reference's ``Spaces``/``FEData`` constructors
(reference src/spaces.jl:31-72, src/dofs.jl:102-124): Taylor-Hood
P2-P1 velocity/pressure plus P2 buoyancy with per-tag Dirichlet data,
and RCM dof renumbering for gather locality (the analog of the
reference's CuthillMcKee permutations, src/dofs.jl:70-100).

Everything here is host-side one-shot NumPy, identical to
``nupgcm_tpu.models.fedata``; the model copies the tables it needs to
its device once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fem.assembly import build_matrix_plan, build_vector_plan
from ..fem.geometry import CellGeometry, FacetGeometry, cell_geometry, facet_geometry, grad_embedding
from ..fem.reference import element_tables, tabulate
from ..fem.spaces import ScalarSpace, scalar_dirichlet, velocity_dirichlet
from ..mesh.core import Mesh
from ..utils.timing import build_step


class Spaces:
    """Velocity (P2 vector), pressure (P1 zero-mean), buoyancy (P2)."""

    @build_step("spaces")
    def __init__(
        self,
        mesh: Mesh,
        u_diri_tags=(),
        u_diri_vals=None,
        u_diri_masks=None,
        b_diri_tags=(),
        b_diri_vals=None,
        u_order: int = 2,
        b_order: int = 2,
        rcm: bool = True,
    ):
        self.mesh = mesh
        self.u_order, self.b_order = u_order, b_order
        self.u_space = ScalarSpace(mesh, u_order)
        self.p_space = ScalarSpace(mesh, u_order - 1)
        self.b_space = ScalarSpace(mesh, b_order)
        if rcm:
            # One RCM traversal (on the u-space dof graph) induces ALL
            # three orderings: u keeps its own RCM; p (vertices) takes
            # the vertices in u-RCM order; b shares u's graph when the
            # orders match (identical RCM) else the induced vertex
            # order.  Alignment matters for domain decomposition
            # (parallel/dd.py): contiguous dof blocks of every space
            # then own the SAME mesh region, so halo depths stay O(1)
            # chunks in all spaces (independent per-space RCM gave the
            # pressure space near-global halos).
            u_perm = self.u_space.rcm_permutation()
            self.u_space.renumber(u_perm)
            vert_order = u_perm[u_perm < mesh.n_vertices]

            def induced(space):
                if space.order == self.u_space.order:
                    return u_perm.copy()
                if space.order == 1:
                    return vert_order.copy()
                return space.rcm_permutation()

            self.p_space.renumber(induced(self.p_space))
            self.b_space.renumber(induced(self.b_space))

        if u_diri_vals is None:
            u_diri_vals = [(0.0, 0.0, 0.0)] * len(u_diri_tags)
        self.u_bc = velocity_dirichlet(self.u_space, u_diri_tags, u_diri_vals, u_diri_masks)
        if b_diri_vals is None:
            b_diri_vals = [0.0] * len(b_diri_tags)
        self.b_bc = scalar_dirichlet(self.b_space, b_diri_tags, b_diri_vals)

    @property
    def n_u(self) -> int:
        """Vector velocity dof count (3 components per node)."""
        return 3 * self.u_space.ndof

    @property
    def n_p(self) -> int:
        return self.p_space.ndof

    @property
    def n_b(self) -> int:
        return self.b_space.ndof


@dataclass
class SurfaceGroup:
    """Per-tag boundary facet data for dGamma integrals."""

    facets: np.ndarray
    geom: FacetGeometry
    phi_u: np.ndarray  # facet-simplex basis values at facet quad pts
    phi_b: np.ndarray
    u_facet_dofs: np.ndarray  # (nf, 3*nl_uf) combined velocity dofs
    b_facet_dofs: np.ndarray  # (nf, nl_bf)


class FEData:
    """Static FE tables + scatter plans for the PG systems."""

    @build_step("fedata")
    def __init__(self, mesh: Mesh, spaces: Spaces, degree: int = 4,
                 surface_tags=("surface",), pad_multiple: int = 8):
        """``pad_multiple``: the cell axis is padded to this multiple
        (pad cells have zero quadrature weight, so they are exact
        no-ops), keeping cell tables identical to ``nupgcm_tpu``'s."""
        self.mesh = mesh
        self.spaces = spaces
        self.degree = degree
        self.pad_multiple = pad_multiple

        # volume geometry + reference tables
        self.geom: CellGeometry = cell_geometry(mesh, degree)
        self.embed = grad_embedding(mesh)
        self.tab_u = element_tables(mesh.tdim, spaces.u_order, degree)
        self.tab_p = element_tables(mesh.tdim, spaces.u_order - 1, degree)
        self.tab_b = element_tables(mesh.tdim, spaces.b_order, degree)
        self.h_cells = mesh.h_cells()
        self.h_median = mesh.median_edge_length()

        us, ps, bs = spaces.u_space, spaces.p_space, spaces.b_space

        # Sort cells by their smallest (RCM-renumbered) velocity node:
        # consecutive cells then touch a contiguous banded dof window
        # (the RCM bandwidth), so neighbouring threads of the element
        # matvec kernels (ops/kernels.py) gather and scatter nearby
        # dofs.  Assembly is a sum over cells, so the order is free.
        self.cell_order = np.argsort(
            us.cell_dofs.min(axis=1), kind="stable").astype(np.int64)
        g = self.geom
        self.geom = CellGeometry(
            tdim=g.tdim, invJT=g.invJT[self.cell_order],
            wq=g.wq[self.cell_order], xq=g.xq[self.cell_order],
        )
        self.h_cells = self.h_cells[self.cell_order]

        nc = mesh.n_cells
        npad = (-nc) % pad_multiple
        self.n_cells_padded = nc + npad
        if npad:
            g = self.geom
            eye = np.broadcast_to(np.eye(mesh.tdim), (npad, mesh.tdim, mesh.tdim))
            self.geom = CellGeometry(
                tdim=g.tdim,
                invJT=np.concatenate([g.invJT, eye]),
                wq=np.concatenate([g.wq, np.zeros((npad, g.wq.shape[1]))]),
                xq=np.concatenate([g.xq, np.repeat(g.xq[:1], npad, axis=0)]),
            )
            # large pad h so padded cells never set the CFL minimum
            self.h_cells = np.concatenate([self.h_cells, np.full(npad, 1e30)])

        def _pad_cd(cd):
            if not npad:
                return cd
            return np.concatenate([cd, np.zeros((npad, cd.shape[1]), cd.dtype)])

        self.cd_u = _pad_cd(us.cell_dofs[self.cell_order])
        self.cd_p = _pad_cd(ps.cell_dofs[self.cell_order])
        self.cd_b = _pad_cd(bs.cell_dofs[self.cell_order])

        # combined inversion dof layout: u dof (node n, comp a) = 3n + a,
        # then pressure offset by 3*ndof_u
        ncp = self.n_cells_padded
        cd_u3 = (3 * self.cd_u[:, :, None] + np.arange(3)[None, None, :]).reshape(ncp, -1)
        cd_p = 3 * us.ndof + self.cd_p
        self.cell_dofs_inv = np.hstack([cd_u3, cd_p])
        self.n_inv = 3 * us.ndof + ps.ndof

        # vector scatter plans
        self.cd_u3 = cd_u3
        self.vec_plan_b = build_vector_plan(self.cd_b, bs.ndof)
        self.vec_plan_p = build_vector_plan(self.cd_p, ps.ndof)
        # node-grouped velocity scatter (one index per 3-vector row)
        self.vec_plan_u_nodes = build_vector_plan(self.cd_u, us.ndof)

        # assembled-sparsity plans (diagnostics / scipy export / tests);
        # built lazily -- the solver hot path is element-local
        self._plans = {}

        # surface facet group (dGamma)
        facets = mesh.tagged_facets(list(surface_tags))
        fdim = mesh.tdim - 1
        fg = facet_geometry(mesh, facets, degree)
        phi_uf, _ = tabulate(fdim, spaces.u_order, _fq(fdim, degree))
        phi_bf, _ = tabulate(fdim, spaces.b_order, _fq(fdim, degree))
        u_fd = us.facet_dofs(facets)
        u_fd3 = (3 * u_fd[:, :, None] + np.arange(3)[None, None, :]).reshape(len(facets), -1)
        self.surface = SurfaceGroup(
            facets=facets, geom=fg, phi_u=phi_uf, phi_b=phi_bf,
            u_facet_dofs=u_fd3, b_facet_dofs=bs.facet_dofs(facets),
        )
        self.vec_plan_b_surf = build_vector_plan(self.surface.b_facet_dofs, bs.ndof)
        self.vec_plan_u_surf = build_vector_plan(self.surface.u_facet_dofs, 3 * us.ndof)

    def _lazy_plan(self, name, rd, cd, nr, nc):
        if name not in self._plans:
            self._plans[name] = build_matrix_plan(rd, cd, nr, nc,
                                                  pad_nnz_to=self.pad_multiple)
        return self._plans[name]

    @property
    def plan_inv(self):
        return self._lazy_plan("inv", self.cell_dofs_inv, self.cell_dofs_inv,
                               self.n_inv, self.n_inv)

    @property
    def plan_B(self):
        return self._lazy_plan("B", self.cd_u3, self.cd_b, self.n_inv,
                               self.spaces.n_b)

    @property
    def plan_b(self):
        return self._lazy_plan("b", self.cd_b, self.cd_b, self.spaces.n_b,
                               self.spaces.n_b)

    @property
    def plan_visc(self):
        return self._lazy_plan("visc", self.cd_u3, self.cd_u3,
                               self.spaces.n_u, self.spaces.n_u)

    @property
    def plan_Mp(self):
        return self._lazy_plan("Mp", self.cd_p, self.cd_p, self.spaces.n_p,
                               self.spaces.n_p)

    def summary(self) -> str:
        s = self.spaces
        return (
            f"FEData: n_u={s.n_u} n_p={s.n_p} n_b={s.n_b} "
            f"(inversion N={self.n_inv}), cells={self.mesh.n_cells}"
        )


def _fq(fdim: int, degree: int) -> np.ndarray:
    from ..fem.quadrature import simplex_rule

    qp, _ = simplex_rule(fdim, degree)
    return qp
