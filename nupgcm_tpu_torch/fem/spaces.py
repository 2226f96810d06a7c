"""Scalar Lagrange FE spaces and DoF management (host-side).

Replaces the reference's Gridap ``TestFESpace/TrialFESpace`` +
``DoFHandler`` stack (reference src/spaces.jl:31-72, src/dofs.jl:27-100)
with explicit NumPy DoF tables:

  * P1 dofs = mesh vertices; P2 dofs = vertices then edge midpoints.
  * Dirichlet conditions are *masks over the full dof vector* (we never
    compact free dofs out -- the model masks full-length vectors
    instead; mathematically identical to the reference's
    free-value + lift formulation).
  * Reverse Cuthill-McKee renumbering (scipy) gives gather locality on
    device, the analog of the reference's ``CuthillMcKee.symrcm``
    permutations (src/dofs.jl:98-100).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..mesh.core import Mesh


class ScalarSpace:
    """Scalar H1 Lagrange space of order 1 or 2 on a simplicial mesh."""

    def __init__(self, mesh: Mesh, order: int):
        if order not in (1, 2):
            raise ValueError("only P1/P2 supported")
        self.mesh = mesh
        self.order = order
        nv = mesh.n_vertices
        if order == 1:
            self.ndof = nv
            self.cell_dofs = mesh.cells.copy()
        else:
            self.ndof = nv + mesh.n_edges
            self.cell_dofs = np.hstack([mesh.cells, nv + mesh.cell_edges])
        self.cell_dofs = self.cell_dofs.astype(np.int64)
        self.nloc = self.cell_dofs.shape[1]
        # identity renumbering by default
        self._dof_coords = None

        # periodic dof identification: slave dofs redirect to masters
        # (the dof-level analog of gmsh setPeriodic, reference
        # meshes/channel.jl:19-25); slaves become inactive (pinned 0).
        self.active = np.ones(self.ndof, dtype=bool)
        self._dof_map = np.arange(self.ndof)
        pp = mesh.periodic_pairs
        if pp is not None and len(pp):
            self._dof_map[pp[:, 0]] = pp[:, 1]
            self.active[pp[:, 0]] = False
            if order == 2:
                ep = mesh.periodic_edge_pairs()
                self._dof_map[nv + ep[:, 0]] = nv + ep[:, 1]
                self.active[nv + ep[:, 0]] = False
            self.cell_dofs = self._dof_map[self.cell_dofs]
        # original-numbering copy for tag lookups after renumbering
        self._dof_map_orig = self._dof_map.copy()

    # -- dof geometry --------------------------------------------------
    @property
    def dof_coords(self) -> np.ndarray:
        """(ndof, 3) coordinates of the Lagrange nodes."""
        if self._dof_coords is None:
            m = self.mesh
            if self.order == 1:
                self._dof_coords = m.coords.copy()
            else:
                mids = 0.5 * (m.coords[m.edges[:, 0]] + m.coords[m.edges[:, 1]])
                self._dof_coords = np.vstack([m.coords, mids])
        return self._dof_coords

    def interpolate(self, f) -> np.ndarray:
        """Nodal interpolation of ``f`` (callable on (n,3) coords, or
        a constant)."""
        x = self.dof_coords
        if callable(f):
            return np.asarray(_eval_coeff(f, x), dtype=np.float64)
        return np.full(self.ndof, float(f))

    # -- boundary dofs -------------------------------------------------
    def tagged_dofs(self, tag_names) -> np.ndarray:
        """Dof ids (current numbering) in the closure of the tags;
        periodic slaves resolve to their masters."""
        v, e = self.mesh.tag_closure(tag_names)
        ids = v if self.order == 1 else np.concatenate([v, self.mesh.n_vertices + e])
        return np.unique(self.map_ids(self._dof_map_orig[ids]))

    def facet_dofs(self, facets: np.ndarray) -> np.ndarray:
        """(nf, nloc_f) dofs of boundary facets, local order = facet
        vertices then facet edges (matching reference.tabulate on the
        facet simplex)."""
        if self.order == 1:
            return self.map_ids(self._dof_map_orig[facets])
        fe = self.mesh.facet_edges(facets)
        ids = np.hstack([facets, self.mesh.n_vertices + fe])
        return self.map_ids(self._dof_map_orig[ids])

    # -- renumbering ---------------------------------------------------
    def rcm_permutation(self) -> np.ndarray:
        """perm such that new_id = perm_inv[old_id]; returns the RCM
        ordering computed on the dof connectivity graph (native
        meshkit with George-Liu pseudo-peripheral starts when
        available, scipy otherwise)."""
        rows = np.repeat(self.cell_dofs, self.nloc, axis=1).ravel()
        cols = np.tile(self.cell_dofs, (1, self.nloc)).ravel()
        g = sp.csr_matrix(
            (np.ones(len(rows), dtype=np.int8), (rows, cols)), shape=(self.ndof, self.ndof)
        )
        g.sum_duplicates()
        from ..mesh import native

        return native.rcm(g.indptr, g.indices)

    def renumber(self, perm: np.ndarray) -> np.ndarray:
        """Apply dof permutation: ``perm[k]`` = old dof id of new dof k.
        Returns the inverse permutation (old -> new)."""
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        self.cell_dofs = inv[self.cell_dofs]
        if self._dof_coords is not None:
            self._dof_coords = self._dof_coords[perm]
        else:
            self._dof_coords = None  # recompute lazily in old order: force eager
            _ = self.dof_coords
            self._dof_coords = self._dof_coords[perm]
        self._perm = perm
        self._inv_perm = inv
        self.active = self.active[perm]
        return inv

    def map_ids(self, old_ids: np.ndarray) -> np.ndarray:
        """Map old dof ids through the renumbering (identity if none)."""
        if hasattr(self, "_inv_perm"):
            return self._inv_perm[old_ids]
        return old_ids

    def to_original_order(self, vals: np.ndarray) -> np.ndarray:
        """Map a dof vector to the mesh-canonical (pre-renumbering)
        order -- invariant to the RCM strategy, for golden files."""
        vals = np.asarray(vals)
        if not hasattr(self, "_perm"):
            return vals.copy()
        out = np.empty_like(vals)
        out[self._perm] = vals
        return out

    def from_original_order(self, vals: np.ndarray) -> np.ndarray:
        vals = np.asarray(vals)
        if not hasattr(self, "_perm"):
            return vals.copy()
        return vals[self._perm]

    def resolve_periodic(self, vals: np.ndarray) -> np.ndarray:
        """Fill periodic slave dof entries with their master values
        (current numbering) -- for output/visualization."""
        if self.mesh.periodic_pairs is None:
            return vals
        orig = self._perm if hasattr(self, "_perm") else np.arange(self.ndof)
        cur_map = self.map_ids(self._dof_map_orig[orig])
        return np.asarray(vals)[cur_map]


def _eval_coeff(f, x: np.ndarray):
    """Evaluate a coefficient callable on (..., 3) coordinates.

    Callables follow the reference convention of taking one point
    ``x`` with components x[0], x[1], x[2] (reference test
    configurations, e.g. test/bowl_mixing_tests.jl:22-31).  We call
    them with the trailing axis unpacked so numpy broadcasting
    applies: f((x, y, z)).
    """
    return f((x[..., 0], x[..., 1], x[..., 2]))


@dataclass
class DirichletBC:
    """Dirichlet data over a full dof vector."""

    mask: np.ndarray  # (ndof,) or (ndof, ncomp) bool -- True where constrained
    values: np.ndarray  # same shape, BC value where constrained else 0


def scalar_dirichlet(space: ScalarSpace, tags, vals) -> DirichletBC:
    """Dirichlet BC for a scalar space: ``tags``/``vals`` as in the
    reference's b_diri_tags/b_diri_vals (src/spaces.jl:47,60-64)."""
    mask = np.zeros(space.ndof, dtype=bool)
    values = np.zeros(space.ndof)
    x = space.dof_coords
    for tag, val in zip(tags, vals):
        ids = space.tagged_dofs([tag])
        mask[ids] = True
        if callable(val):
            values[ids] = np.asarray(_eval_coeff(val, x[ids]), dtype=np.float64)
        else:
            values[ids] = float(val)
    return DirichletBC(mask=mask, values=values)


def velocity_dirichlet(space: ScalarSpace, tags, vals, masks) -> DirichletBC:
    """Per-component Dirichlet BC for the vector velocity space.

    ``masks`` selects which of (u, v, w) are constrained on each tag
    (reference src/spaces.jl:44 dirichlet_masks).  Returns (ndof, 3)
    arrays.
    """
    mask = np.zeros((space.ndof, 3), dtype=bool)
    values = np.zeros((space.ndof, 3))
    if masks is None:
        masks = [(True, True, True)] * len(tags)
    for tag, val, m in zip(tags, vals, masks):
        ids = space.tagged_dofs([tag])
        for c in range(3):
            if m[c]:
                mask[ids, c] = True
                if callable(val):
                    raise NotImplementedError("callable velocity Dirichlet values")
                values[ids, c] = float(val[c])
    return DirichletBC(mask=mask, values=values)
