"""Unstructured simplicial mesh (host-side, NumPy).

Equivalent role to the reference's ``Mesh`` wrapper over Gmsh/Gridap
(reference src/meshes.jl:1-39) but self-contained: we parse ``.msh``
files ourselves or generate meshes programmatically, and precompute the
static combinatorics (unique edges, boundary facets, tagged entity
closures, per-cell sizes) that the assembly consumes as constant tables.

Conventions:
  * ``coords`` is always (nv, 3): for a 2D (x-z plane) mesh the y
    column is zero.  Coefficient callables therefore always receive
    3-vector coordinates like the reference's ``VectorValue{3}`` points
    (reference src/nuPGCM.jl:16-23).
  * ``tdim`` is the topological dimension (2 => triangles in the x-z
    plane, 3 => tets).  Geometry mappings use the in-plane coordinate
    columns ``plane_axes`` = [0, 2] for tdim=2 and [0, 1, 2] for tdim=3.
  * Physical groups: ``tagged[name][d]`` is an (n, d+1) array of
    d-dimensional boundary simplices (vertex ids) carrying that tag.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..fem.reference import LOCAL_EDGES


def unique_edges(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All unique (sorted) vertex-pair edges of a simplex mesh.

    Returns (edges, cell_edges): edges is (ne, 2) with v0 < v1;
    cell_edges is (nc, n_local_edges) indexing into edges, local edges
    ordered per LOCAL_EDGES.  Analog of the reference's ``all_edges``
    (reference src/meshes.jl:94-108), vectorized.
    """
    nc, nvert = cells.shape
    tdim = nvert - 1
    led = np.array(LOCAL_EDGES[tdim])  # (nle, 2)
    pairs = cells[:, led]  # (nc, nle, 2)
    pairs = np.sort(pairs.reshape(-1, 2), axis=1)
    edges, inv = np.unique(pairs, axis=0, return_inverse=True)
    cell_edges = inv.reshape(nc, led.shape[0]).astype(np.int64)
    return edges.astype(np.int64), cell_edges


def edge_lookup(edges: np.ndarray, nv: int):
    """Dict-free lookup: map sorted vertex pair -> edge id via key array."""
    keys = edges[:, 0].astype(np.int64) * np.int64(nv) + edges[:, 1]
    order = np.argsort(keys)
    return keys[order], order


def find_edges(edges_keys_sorted, edges_order, pairs: np.ndarray, nv: int) -> np.ndarray:
    """Look up edge ids for (n, 2) vertex pairs (any order)."""
    p = np.sort(np.asarray(pairs, dtype=np.int64), axis=1)
    k = p[:, 0] * np.int64(nv) + p[:, 1]
    idx = np.searchsorted(edges_keys_sorted, k)
    if np.any(idx >= len(edges_keys_sorted)) or np.any(edges_keys_sorted[np.clip(idx, 0, len(edges_keys_sorted) - 1)] != k):
        raise KeyError("edge pair not found in mesh edge table")
    return edges_order[idx]


@dataclass
class Mesh:
    tdim: int
    coords: np.ndarray  # (nv, 3) float64
    cells: np.ndarray  # (nc, tdim+1) int64 vertex ids
    # physical groups: name -> {dim: (n, dim+1) vertex-id simplices}
    tagged: dict = field(default_factory=dict)
    # in-plane coordinate columns for 2D meshes: [0, 2] = x-z slice
    # (bowl sections), [1, 2] = y-z slice (meridional channel sections)
    plane: tuple = None
    # periodic identification: (n, 2) [slave_vertex, master_vertex]
    periodic_pairs: np.ndarray = None

    # derived (filled in __post_init__)
    edges: np.ndarray = None
    cell_edges: np.ndarray = None

    def __post_init__(self):
        self.coords = np.ascontiguousarray(self.coords, dtype=np.float64)
        self.cells = np.ascontiguousarray(self.cells, dtype=np.int64)
        if self.coords.shape[1] != 3:
            raise ValueError("coords must be (nv, 3); embed 2D meshes in the x-z plane")
        if self.edges is None:
            # native meshkit edge extraction when available (~8x)
            from . import native

            self.edges, self.cell_edges = native.unique_edges(self.cells)
        self._edge_keys, self._edge_order = edge_lookup(self.edges, self.n_vertices)
        self._fix_orientation()

    # -- basic sizes ---------------------------------------------------
    @property
    def n_vertices(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def plane_axes(self) -> list[int]:
        """Coordinate columns spanning the mesh plane/volume."""
        if self.tdim == 3:
            return [0, 1, 2]
        return list(self.plane) if self.plane is not None else [0, 2]

    def periodic_edge_pairs(self) -> np.ndarray:
        """(n, 2) [slave_edge, master_edge] ids induced by the vertex
        periodic_pairs: an edge whose endpoints are both slaves maps to
        the edge of the corresponding masters.

        Edges with no matching master (mismatched seam-face diagonals
        on composite geometries) are dropped: their mid-edge dofs stay
        independent, a local weak nonconformity at discretization
        level.  Extruded meshes (channel3D) always match exactly.
        """
        if self.periodic_pairs is None or len(self.periodic_pairs) == 0:
            return np.zeros((0, 2), dtype=np.int64)
        s2m = -np.ones(self.n_vertices, dtype=np.int64)
        s2m[self.periodic_pairs[:, 0]] = self.periodic_pairs[:, 1]
        e = self.edges
        both = (s2m[e[:, 0]] >= 0) & (s2m[e[:, 1]] >= 0)
        slave_e = np.where(both)[0]
        master_pairs = np.sort(
            np.stack([s2m[e[slave_e, 0]], s2m[e[slave_e, 1]]], axis=1), axis=1
        )
        keys = master_pairs[:, 0] * np.int64(self.n_vertices) + master_pairs[:, 1]
        pos = np.searchsorted(self._edge_keys, keys)
        pos_c = np.clip(pos, 0, len(self._edge_keys) - 1)
        found = self._edge_keys[pos_c] == keys
        master_ids = self._edge_order[pos_c[found]]
        return np.stack([slave_e[found], master_ids], axis=1)

    # -- geometry ------------------------------------------------------
    def cell_coords(self) -> np.ndarray:
        """(nc, tdim+1, tdim) vertex coordinates in plane axes."""
        return self.coords[self.cells][:, :, self.plane_axes]

    def cell_jacobians(self) -> tuple[np.ndarray, np.ndarray]:
        """Affine map Jacobians: J (nc, tdim, tdim) with columns the
        edge vectors from vertex 0, and detJ (nc,)."""
        X = self.cell_coords()
        J = np.transpose(X[:, 1:, :] - X[:, :1, :], (0, 2, 1))  # d x_phys / d x_ref
        detJ = np.linalg.det(J)
        return J, detJ

    def _fix_orientation(self):
        """Flip inverted cells so det J > 0 (swap last two vertices)."""
        _, detJ = self.cell_jacobians()
        bad = detJ < 0
        if np.any(bad):
            c = self.cells[bad]
            c[:, [-2, -1]] = c[:, [-1, -2]]
            self.cells[bad] = c
            # edge table unchanged (edges are vertex sets) but local
            # ordering changed: recompute cell_edges
            _, self.cell_edges = unique_edges(self.cells)

    def h_cells(self) -> np.ndarray:
        """Characteristic size (max edge length) per cell.

        Parity: reference ``compute_h_cells`` (src/meshes.jl:127-133).
        """
        X = self.coords[self.cells]  # (nc, nvert, 3)
        nvert = self.tdim + 1
        h = np.zeros(self.n_cells)
        for i in range(nvert):
            for j in range(i + 1, nvert):
                d = np.linalg.norm(X[:, i] - X[:, j], axis=1)
                h = np.maximum(h, d)
        return h

    def median_edge_length(self) -> float:
        """Median edge length (used for the 1/h^dim diagonal
        preconditioner scale, reference src/inversion.jl:43-54)."""
        e = self.coords[self.edges]
        hs = np.linalg.norm(e[:, 0] - e[:, 1], axis=1)
        return float(np.sort(hs)[len(hs) // 2])

    # -- tags ----------------------------------------------------------
    def tag_names(self) -> list[str]:
        return list(self.tagged.keys())

    def tagged_facets(self, names) -> np.ndarray:
        """(nf, tdim) facets ((tdim-1)-simplices) carrying any of the
        given tags -- used for surface measures dGamma."""
        fdim = self.tdim - 1
        out = []
        for name in names:
            ents = self.tagged.get(name, {})
            if fdim in ents and len(ents[fdim]):
                out.append(np.asarray(ents[fdim], dtype=np.int64))
        if not out:
            return np.zeros((0, fdim + 1), dtype=np.int64)
        return np.unique(np.vstack(out), axis=0)

    def tag_closure(self, names) -> tuple[np.ndarray, np.ndarray]:
        """Closure of tagged entities: (vertex_ids, edge_ids).

        A vertex/edge is tagged if it belongs to any tagged simplex of
        any dimension (matching Gridap's face-labeling closure used for
        Dirichlet tags, reference src/spaces.jl:44-47).
        """
        verts: list[np.ndarray] = []
        edge_ids: list[np.ndarray] = []
        for name in names:
            if name not in self.tagged:
                raise KeyError(
                    f"unknown physical tag {name!r}; available: {self.tag_names()}"
                )
            for d, simplices in self.tagged[name].items():
                simp = np.asarray(simplices, dtype=np.int64)
                if simp.size == 0:
                    continue
                verts.append(simp.ravel())
                if d >= 1:
                    led = np.array(LOCAL_EDGES[d]) if d >= 1 else None
                    pairs = simp[:, led].reshape(-1, 2)
                    edge_ids.append(
                        find_edges(self._edge_keys, self._edge_order, pairs, self.n_vertices)
                    )
        v = np.unique(np.concatenate(verts)) if verts else np.zeros(0, dtype=np.int64)
        e = np.unique(np.concatenate(edge_ids)) if edge_ids else np.zeros(0, dtype=np.int64)
        return v, e

    def facet_edges(self, facets: np.ndarray) -> np.ndarray:
        """Edge ids for each facet, local edges per LOCAL_EDGES[fdim]."""
        fdim = self.tdim - 1
        if facets.shape[0] == 0:
            return np.zeros((0, len(LOCAL_EDGES[fdim])), dtype=np.int64)
        led = np.array(LOCAL_EDGES[fdim])
        pairs = facets[:, led].reshape(-1, 2)
        ids = find_edges(self._edge_keys, self._edge_order, pairs, self.n_vertices)
        return ids.reshape(facets.shape[0], led.shape[0])

    def facet_measures(self, facets: np.ndarray) -> np.ndarray:
        """|J_f| scale of each boundary facet: length (2D meshes) or
        twice-area factor (3D meshes).  Multiplying reference-facet
        quadrature weights by this gives physical surface measure."""
        X = self.coords[facets]  # (nf, fdim+1, 3)
        if self.tdim == 2:
            return np.linalg.norm(X[:, 1] - X[:, 0], axis=1)
        c = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
        return np.linalg.norm(c, axis=1)

    def summary(self) -> str:
        per = (
            f", periodic pairs={len(self.periodic_pairs)}"
            if self.periodic_pairs is not None else ""
        )
        return (
            f"Mesh(tdim={self.tdim}, {self.n_vertices} vertices, "
            f"{self.n_cells} cells, {self.n_edges} edges, "
            f"tags={self.tag_names()}{per})"
        )


def detect_periodic_pairs(mesh: Mesh, axis: int = 0, tol: float = 1e-9) -> np.ndarray:
    """Match boundary vertices on the axis-max plane (slaves) to
    translated partners on the axis-min plane (masters) by the
    remaining coordinates -- the reader-side analog of gmsh's
    ``setPeriodic`` (reference meshes/channel.jl:19-25).  Returns the
    (n, 2) [slave, master] array to store in ``mesh.periodic_pairs``.
    """
    x = mesh.coords[:, axis]
    lo, hi = x.min(), x.max()
    slaves = np.where(np.abs(x - hi) < tol)[0]
    masters = np.where(np.abs(x - lo) < tol)[0]
    other = [a for a in range(3) if a != axis]
    key_m = mesh.coords[masters][:, other]
    key_s = mesh.coords[slaves][:, other]
    from scipy.spatial import cKDTree

    tree = cKDTree(key_m)
    d, idx = tree.query(key_s)
    if np.any(d > 10 * tol + 1e-12):
        raise ValueError(
            f"periodic match failed: max mismatch {d.max():.2e} "
            f"(meshes must have congruent boundary triangulations)"
        )
    return np.stack([slaves, masters[idx]], axis=1)
