"""Programmatic mesh generators (host-side, NumPy).

Self-contained replacements for the reference's offline Gmsh scripts
(reference meshes/mesh_bowl2D.jl, mesh_bowl3D.jl): bowl-shaped basins
with the same physical groups ("bottom", "coastline", "surface",
"interior"), plus a structured rectangle for unit tests.  All
generators emit :class:`nupgcm_tpu_torch.mesh.core.Mesh` and produce
the same vertices and cells as ``nupgcm_tpu.mesh.generators``.

2D meshes live in the x-z plane (y == 0).
"""

from __future__ import annotations

import numpy as np

from .core import Mesh


# ----------------------------------------------------------------------
# structured rectangle (for unit tests)
# ----------------------------------------------------------------------

def rect_mesh(nx: int, nz: int, x0=0.0, x1=1.0, z0=0.0, z1=1.0) -> Mesh:
    """Structured triangle mesh of [x0,x1] x [z0,z1] in the x-z plane.

    Tags: "left", "right", "bottom", "top" (1D), "boundary" (all sides),
    "interior" (2D).
    """
    xs = np.linspace(x0, x1, nx + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    nvx, nvz = nx + 1, nz + 1
    coords = np.zeros((nvx * nvz, 3))
    coords[:, 0] = X.ravel()
    coords[:, 2] = Z.ravel()
    vid = np.arange(nvx * nvz).reshape(nvx, nvz)
    cells = []
    for i in range(nx):
        for j in range(nz):
            a, b = vid[i, j], vid[i + 1, j]
            c, d = vid[i + 1, j + 1], vid[i, j + 1]
            # split consistently along (a, c)
            cells.append((a, b, c))
            cells.append((a, c, d))
    cells = np.array(cells, dtype=np.int64)

    def _seg(ids):
        return np.stack([ids[:-1], ids[1:]], axis=1)

    left, right = _seg(vid[0, :]), _seg(vid[-1, :])
    bot, top = _seg(vid[:, 0]), _seg(vid[:, -1])
    tagged = {
        "left": {1: left},
        "right": {1: right},
        "bottom": {1: bot},
        "top": {1: top},
        "surface": {1: top},
        "boundary": {1: np.vstack([left, right, bot, top])},
        "interior": {2: cells},
    }
    return Mesh(tdim=2, coords=coords, cells=cells, tagged=tagged)


# ----------------------------------------------------------------------
# 2D bowl (x-z plane), quasi-uniform column strips
# ----------------------------------------------------------------------

def bowl2D(h: float, alpha: float = 0.5, depth=None) -> Mesh:
    """Bowl basin {(x, z): -H(x) <= z <= 0, |x| <= 1}, H = alpha(1-x^2).

    Quasi-uniform resolution ``h``; physical groups match the reference
    bowl meshes: "bottom" (curve), "surface" (curve z=0), "coastline"
    (the two end points), "interior".
    """
    H = depth if depth is not None else (lambda x: alpha * (1.0 - x ** 2))
    nx = max(4, int(round(2.0 / h)))
    xs = np.linspace(-1.0, 1.0, nx + 1)

    columns = []  # list of arrays of node ids, bottom -> top
    coords = []

    def add_node(x, z):
        coords.append((x, 0.0, z))
        return len(coords) - 1

    for x in xs:
        Hx = max(H(x), 0.0)
        nzi = max(1, int(round(Hx / h)))
        if Hx <= 1e-14:
            columns.append(np.array([add_node(x, 0.0)]))
        else:
            zs = np.linspace(-Hx, 0.0, nzi + 1)
            columns.append(np.array([add_node(x, z) for z in zs]))

    coords = np.array(coords)
    cells = []
    for ci in range(nx):
        A, B = columns[ci], columns[ci + 1]
        a = b = 0
        # two-pointer strip triangulation, advancing the chain whose
        # next node gives the shorter diagonal
        while a < len(A) - 1 or b < len(B) - 1:
            can_a, can_b = a < len(A) - 1, b < len(B) - 1
            if can_a and can_b:
                da = np.linalg.norm(coords[A[a + 1]] - coords[B[b]])
                db = np.linalg.norm(coords[B[b + 1]] - coords[A[a]])
                use_a = da <= db
            else:
                use_a = can_a
            if use_a:
                cells.append((A[a], B[b], A[a + 1]))
                a += 1
            else:
                cells.append((A[a], B[b], B[b + 1]))
                b += 1
    cells = np.array(cells, dtype=np.int64)

    tops = np.array([c[-1] for c in columns])
    bots = np.array([c[0] for c in columns])
    surface = np.stack([tops[:-1], tops[1:]], axis=1)
    bottom = np.stack([bots[:-1], bots[1:]], axis=1)
    coast = np.array([[columns[0][0]], [columns[-1][0]]])
    tagged = {
        "surface": {1: surface},
        "bottom": {1: bottom},
        "coastline": {0: coast},
        "interior": {2: cells},
    }
    return Mesh(tdim=2, coords=coords, cells=cells, tagged=tagged)


# ----------------------------------------------------------------------
# 3D bowl: triangulated disk base x sigma layers, prisms -> tets
# ----------------------------------------------------------------------

def disk_mesh_2d(h: float) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quasi-uniform triangulated unit disk.

    Returns (xy (nv, 2), tris (nt, 3), boundary ring node ids in order).
    """
    nr = max(2, int(round(1.0 / h)))
    rings = [np.zeros((1, 2))]
    counts = [1]
    for k in range(1, nr + 1):
        r = k / nr
        m = max(6, int(round(2.0 * np.pi * r / h)))
        th = 2.0 * np.pi * np.arange(m) / m
        rings.append(np.stack([r * np.cos(th), r * np.sin(th)], axis=1))
        counts.append(m)
    offs = np.cumsum([0] + counts)
    xy = np.vstack(rings)
    tris = []
    for k in range(nr):
        A = np.arange(offs[k], offs[k + 1])       # inner ring ids
        B = np.arange(offs[k + 1], offs[k + 2])   # outer ring ids
        if len(A) == 1:
            c = A[0]
            m = len(B)
            for i in range(m):
                tris.append((c, B[i], B[(i + 1) % m]))
            continue
        # merge two circular chains by angle (nodes were generated in
        # increasing-angle order starting at 0)
        angA = np.mod(np.arctan2(xy[A, 1], xy[A, 0]), 2.0 * np.pi)
        angB = np.mod(np.arctan2(xy[B, 1], xy[B, 0]), 2.0 * np.pi)
        a = b = 0
        nA, nB = len(A), len(B)

        def ang(arr, i):
            return arr[i % len(arr)] + 2.0 * np.pi * (i // len(arr))

        while a < nA or b < nB:
            if a < nA and b < nB:
                use_a = ang(angA, a + 1) <= ang(angB, b + 1)
            else:
                use_a = a < nA
            if use_a:
                tris.append((A[a % nA], B[b % nB], A[(a + 1) % nA]))
                a += 1
            else:
                tris.append((A[a % nA], B[b % nB], B[(b + 1) % nB]))
                b += 1
    tris = np.array(tris, dtype=np.int64)
    # enforce CCW orientation
    v = xy[tris]
    area2 = (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1]) - (
        v[:, 1, 1] - v[:, 0, 1]
    ) * (v[:, 2, 0] - v[:, 0, 0])
    flip = area2 < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]
    ring = np.arange(offs[nr], offs[nr + 1])
    return xy, tris, ring


def _split_prism(prism: list[int], key: np.ndarray | None = None
                 ) -> list[tuple[int, int, int, int]]:
    """Split a prism into <=3 tets with globally consistent diagonals.

    ``prism`` = [v0, v1, v2, v3, v4, v5] with vi+3 vertically above vi.
    Uses the smallest-index rule (Dompierre et al. 1999): every quad
    face is split along the diagonal through its smallest vertex, so
    shared faces between neighboring prisms pick the same diagonal.
    Comparisons go through ``key`` when given (identity otherwise):
    mapping periodic slave vertices to their masters' keys makes the
    two seam planes of a re-entrant channel split IDENTICALLY under
    the periodic translation -- an exactly conforming seam.
    """
    V = list(prism)
    k = (lambda v: int(key[v])) if key is not None else (lambda v: v)
    # rotate so the smallest-key vertex is V[0]
    imin = int(np.argmin([k(v) for v in V]))
    if imin >= 3:
        # flip the prism upside down (reverse winding to keep pairing)
        V = [V[3], V[5], V[4], V[0], V[2], V[1]]
        imin = int(np.argmin([k(v) for v in V]))
    for _ in range(imin):
        V = [V[1], V[2], V[0], V[4], V[5], V[3]]
    v0, v1, v2, v3, v4, v5 = V
    if min(k(v1), k(v5)) < min(k(v2), k(v4)):
        tets = [(v0, v1, v2, v5), (v0, v1, v5, v4), (v0, v4, v5, v3)]
    else:
        tets = [(v0, v1, v2, v4), (v0, v4, v2, v5), (v0, v4, v5, v3)]
    # drop tets degenerated by merged (collapsed) vertices
    return [t for t in tets if len(set(t)) == 4]


def bowl3D(h: float, alpha: float = 0.5, nz: int | None = None, depth=None) -> Mesh:
    """Bowl basin {(x,y,z): -H <= z <= 0, x^2+y^2 <= 1}, H = alpha(1-x^2-y^2).

    Sigma-layer tet mesh over a quasi-uniform disk base; coastline
    columns collapse to single nodes on the unit circle.  Physical
    groups: "bottom", "surface", "coastline" (1D ring), "interior".
    """
    H = depth if depth is not None else (lambda x, y: alpha * (1.0 - x ** 2 - y ** 2))
    xy, tris, ring = disk_mesh_2d(h)
    nb = xy.shape[0]
    if nz is None:
        nz = max(2, int(round(alpha / h)))
    Hb = np.maximum(np.array([H(x, y) for x, y in xy]), 0.0)
    collapsed = Hb <= 1e-14

    # node ids: column of nz+1 levels per base vertex; collapsed -> 1
    node_id = np.full((nb, nz + 1), -1, dtype=np.int64)
    coords = []
    for i in range(nb):
        if collapsed[i]:
            coords.append((xy[i, 0], xy[i, 1], 0.0))
            node_id[i, :] = len(coords) - 1
        else:
            zs = np.linspace(-Hb[i], 0.0, nz + 1)
            for j, z in enumerate(zs):
                coords.append((xy[i, 0], xy[i, 1], z))
                node_id[i, j] = len(coords) - 1
    coords = np.array(coords)

    tets = []
    for (a, b, c) in tris:
        for j in range(nz):
            prism = [
                node_id[a, j], node_id[b, j], node_id[c, j],
                node_id[a, j + 1], node_id[b, j + 1], node_id[c, j + 1],
            ]
            if len(set(prism)) < 4:
                continue
            tets.extend(_split_prism(prism))
    tets = np.array(tets, dtype=np.int64)
    # drop numerically degenerate tets (can appear near the coastline)
    X = coords[tets]
    vol6 = np.einsum(
        "ij,ij->i",
        np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
        X[:, 3] - X[:, 0],
    )
    tets = tets[np.abs(vol6) > 1e-12 * h ** 3]

    surface = np.stack(
        [node_id[tris[:, 0], nz], node_id[tris[:, 1], nz], node_id[tris[:, 2], nz]],
        axis=1,
    )
    bottom = np.stack(
        [node_id[tris[:, 0], 0], node_id[tris[:, 1], 0], node_id[tris[:, 2], 0]],
        axis=1,
    )
    # bottom facets fully collapsed onto the surface are not real facets
    keep = ~np.all(collapsed[tris], axis=1)
    bottom = bottom[keep & (np.vectorize(len)(list(map(set, map(tuple, bottom)))) == 3)]
    ring_nodes = node_id[ring, 0]
    coast = np.stack([ring_nodes, np.roll(ring_nodes, -1)], axis=1)
    tagged = {
        "surface": {2: surface},
        "bottom": {2: bottom},
        "coastline": {1: coast},
        "interior": {3: tets},
    }
    return Mesh(tdim=3, coords=coords, cells=tets, tagged=tagged)
