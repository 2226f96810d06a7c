"""Programmatic mesh generators (host-side, NumPy).

Self-contained replacements for the reference's offline Gmsh scripts
(reference meshes/mesh_bowl2D.jl, mesh_bowl3D.jl): bowl-shaped basins
with the same physical groups ("bottom", "coastline", "surface",
"interior"), the sphere, the 2D and 3D channels, the x-periodic
channel + basin family of the production runs (reference
meshes/channel_basin*.jl), plus simple rectangles/boxes for
manufactured-solution tests.  All generators emit
:class:`nupgcm_tpu_torch.mesh.core.Mesh` and produce the same
vertices, cells, tags and periodic pairs as
``nupgcm_tpu.mesh.generators``.

2D meshes live in the x-z plane (y == 0).
"""

from __future__ import annotations

import numpy as np

from ..utils.timing import build_step
from .core import Mesh


# ----------------------------------------------------------------------
# structured rectangle / box (for MMS + unit tests)
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


def box_mesh(nx: int, ny: int, nz: int, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)) -> Mesh:
    """Structured tet mesh of a box (6 tets per hex, Kuhn split).

    Tags: "left"/"right" (x), "front"/"back" (y), "bottom"/"top" (z),
    "boundary", "surface" (= top), "interior".
    """
    xs = np.linspace(lo[0], hi[0], nx + 1)
    ys = np.linspace(lo[1], hi[1], ny + 1)
    zs = np.linspace(lo[2], hi[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    vid = np.arange(coords.shape[0]).reshape(nx + 1, ny + 1, nz + 1)

    # Kuhn triangulation: 6 tets per cube, conforming across faces
    perms = [
        (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0),
    ]
    cells = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                base = np.array([i, j, k])
                for p in perms:
                    path = [base.copy()]
                    cur = base.copy()
                    for axis in p:
                        cur = cur.copy()
                        cur[axis] += 1
                        path.append(cur)
                    cells.append([vid[tuple(q)] for q in path])
    cells = np.array(cells, dtype=np.int64)

    def face_tris(fixed_axis, fixed_idx):
        axes = [a for a in range(3) if a != fixed_axis]
        n0 = [nx, ny, nz][axes[0]]
        n1 = [nx, ny, nz][axes[1]]
        tris = []
        for a in range(n0):
            for b in range(n1):
                idx = [0, 0, 0]
                idx[fixed_axis] = fixed_idx

                def v(da, db):
                    q = list(idx)
                    q[axes[0]] = a + da
                    q[axes[1]] = b + db
                    return vid[tuple(q)]

                # split matching the Kuhn tets: diagonal from (0,0) to (1,1)
                tris.append((v(0, 0), v(1, 0), v(1, 1)))
                tris.append((v(0, 0), v(1, 1), v(0, 1)))
        return np.array(tris, dtype=np.int64)

    sides = {
        "left": face_tris(0, 0),
        "right": face_tris(0, nx),
        "front": face_tris(1, 0),
        "back": face_tris(1, ny),
        "bottom": face_tris(2, 0),
        "top": face_tris(2, nz),
    }
    tagged = {name: {2: tris} for name, tris in sides.items()}
    tagged["surface"] = {2: sides["top"]}
    tagged["boundary"] = {2: np.vstack(list(sides.values()))}
    tagged["interior"] = {3: cells}
    return Mesh(tdim=3, coords=coords, cells=cells, tagged=tagged)


def _graded_sigma(nz: int, refinement_factor) -> np.ndarray:
    """Normalized vertical levels s in [0, 1] (s=0 bottom, s=1 surface).

    Uniform when no refinement; otherwise graded so the end spacings
    (bottom + surface boundary layers) shrink by ``refinement_factor``
    and ramp back to the interior spacing over one base cell -- the
    sigma-mesh analog of the reference's Distance/Threshold background
    field (SizeMin = h/r at the boundary, SizeMax = h at distance h;
    reference meshes/channel_basin.jl:131-147).
    """
    if refinement_factor is None or refinement_factor <= 1:
        return np.linspace(0.0, 1.0, nz + 1)
    r = float(refinement_factor)
    ds = 1.0 / nz  # base (interior) spacing; also the ramp distance

    def g(s):
        # local target spacing: ds/r at the wall, ds past one base cell
        return ds * (1.0 / r + (1.0 - 1.0 / r) * min(s / ds, 1.0))

    # march the half-grid [0, 1/2] with the local spacing, mirror it
    pts = [0.0]
    while pts[-1] < 0.5:
        pts.append(pts[-1] + g(pts[-1]))
    half = np.array(pts) * (0.5 / pts[-1])
    return np.concatenate([half, 1.0 - half[-2::-1]])


def _sigma_composite(h: float, phi2, depth, L: float, W: float,
                     y_ch_top: float, H: float, nz: int | None,
                     refinement_factor=None) -> Mesh:
    """Shared terrain-following core of the channel_basin family.

    Footprint level-set ``phi2(x, y)`` (> 0 inside; None = the whole
    [0, W] x [-L/2, L/2] rectangle), water depth ``depth(x, y)``;
    boundary grid vertices snap onto phi = 0 for a body-fitted
    coastline and columns of sigma layers collapse where the depth
    vanishes.  The x = W plane is identified with x = 0 for
    y <= ``y_ch_top`` (the re-entrant channel seam); prism diagonals
    are chosen through periodic-consistent keys so the seam faces
    match EXACTLY under the translation (conforming periodic gluing
    -- every slave-plane edge has a master, nothing falls back to
    weak coupling).
    """
    # --- footprint grid with coastline snapping ----------------------
    nx = max(4, int(round(W / h)))
    ny = max(8, int(round(L / h)))
    xs = np.linspace(0.0, W, nx + 1)
    ys = np.linspace(-L / 2, L / 2, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    if phi2 is None:
        inside = np.ones(X.shape, dtype=bool)
    else:
        PHI = phi2(X, Y)
        inside = PHI > 1e-12

    # snap outside vertices adjacent to inside ones onto phi = 0
    Xs, Ys = X.copy(), Y.copy()
    snapped = np.zeros_like(inside)
    for axis in (0, 1) if phi2 is not None else ():
        for sgn in (1, -1):
            nb = np.roll(inside, sgn, axis=axis)
            if axis == 0:
                nb[0 if sgn == 1 else -1, :] = False
            else:
                nb[:, 0 if sgn == 1 else -1] = False
            cand = (~inside) & nb & (~snapped)
            ii, jj = np.where(cand)
            for i, j in zip(ii, jj):
                i2, j2 = (i - sgn, j) if axis == 0 else (i, j - sgn)
                # bisect phi=0 along the edge
                a = np.array([X[i2, j2], Y[i2, j2]])
                b = np.array([X[i, j], Y[i, j]])
                for _ in range(40):
                    m = 0.5 * (a + b)
                    if phi2(m[0], m[1]) > 0:
                        a = m
                    else:
                        b = m
                Xs[i, j], Ys[i, j] = 0.5 * (a + b)
                snapped[i, j] = True
    use = inside | snapped

    # base vertices + triangulation of used quads
    vid = -np.ones((nx + 1, ny + 1), dtype=np.int64)
    base_xy = []
    for i in range(nx + 1):
        for j in range(ny + 1):
            if use[i, j]:
                vid[i, j] = len(base_xy)
                base_xy.append((Xs[i, j], Ys[i, j]))
    base_xy = np.array(base_xy)
    tris = []
    for i in range(nx):
        for j in range(ny):
            q = [vid[i, j], vid[i + 1, j], vid[i + 1, j + 1], vid[i, j + 1]]
            qi = [inside[i, j], inside[i + 1, j], inside[i + 1, j + 1], inside[i, j + 1]]
            if all(v >= 0 for v in q) and any(qi):
                tris.append((q[0], q[1], q[2]))
                tris.append((q[0], q[2], q[3]))
            elif sum(v >= 0 for v in q) == 3 and any(qi):
                tri = [v for v in q if v >= 0]
                tris.append(tuple(tri))
    tris = np.array(tris, dtype=np.int64)
    # drop zero-area triangles from snapping
    v = base_xy[tris]
    area2 = np.abs(
        (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1])
        - (v[:, 1, 1] - v[:, 0, 1]) * (v[:, 2, 0] - v[:, 0, 0])
    )
    tris = tris[area2 > 1e-8 * h * h]

    # --- sigma columns -> prisms -> tets -----------------------------
    nb = len(base_xy)
    if nz is None:
        nz = max(2, int(round(H / h)) * 2)
    slev = _graded_sigma(nz, refinement_factor)
    nz = len(slev) - 1
    Hb = np.asarray(depth(base_xy[:, 0], base_xy[:, 1]), dtype=np.float64)
    collapsed = Hb <= 1e-10
    node_id = np.full((nb, nz + 1), -1, dtype=np.int64)
    coords = []
    for i in range(nb):
        if collapsed[i]:
            coords.append((base_xy[i, 0], base_xy[i, 1], 0.0))
            node_id[i, :] = len(coords) - 1
        else:
            for j, s in enumerate(slev):
                coords.append((base_xy[i, 0], base_xy[i, 1], -Hb[i] * (1.0 - s)))
                node_id[i, j] = len(coords) - 1
    coords = np.array(coords)

    # periodic pairs across the channel seam (x = W -> x = 0), needed
    # BEFORE tetrahedralization: the prism-split diagonal keys below
    # identify slave nodes with their masters so seam faces conform
    pairs = []
    for j in range(ny + 1):
        if vid[0, j] >= 0 and vid[nx, j] >= 0 and ys[j] <= y_ch_top + 1e-9:
            c0, c1 = vid[0, j], vid[nx, j]
            if collapsed[c0] != collapsed[c1]:
                continue
            for lev in range(nz + 1):
                pairs.append((node_id[c1, lev], node_id[c0, lev]))
    pairs = (np.unique(np.array(sorted(set(pairs)), dtype=np.int64), axis=0)
             if pairs else None)
    key = np.arange(len(coords), dtype=np.int64)
    if pairs is not None:
        key[pairs[:, 0]] = pairs[:, 1]

    tets = []
    for (a, b, c) in tris:
        for j in range(nz):
            prism = [
                node_id[a, j], node_id[b, j], node_id[c, j],
                node_id[a, j + 1], node_id[b, j + 1], node_id[c, j + 1],
            ]
            if len(set(prism)) < 4:
                continue
            tets.extend(_split_prism(prism, key))
    tets = np.array(tets, dtype=np.int64)
    X3 = coords[tets]
    vol6 = np.einsum(
        "ij,ij->i",
        np.cross(X3[:, 1] - X3[:, 0], X3[:, 2] - X3[:, 0]),
        X3[:, 3] - X3[:, 0],
    )
    tets = tets[np.abs(vol6) > 1e-14]

    # --- tags ---------------------------------------------------------
    bf = boundary_facets(tets)
    z = coords[:, 2]
    x = coords[:, 0]
    y = coords[:, 1]
    on_sfc = np.all(np.abs(z[bf]) < 1e-12, axis=1)
    in_channel = np.all(y[bf] <= y_ch_top + 1e-9, axis=1)
    on_end = in_channel & (
        np.all(np.abs(x[bf]) < 1e-12, axis=1)
        | np.all(np.abs(x[bf] - W) < 1e-12, axis=1)
    )
    surface = bf[on_sfc & ~on_end]
    bottom = bf[~on_sfc & ~on_end]

    tagged = {
        "surface": {2: surface},
        "bottom": {2: bottom},
        "interior": {3: tets},
    }
    if collapsed.any():
        # coastline: surface nodes whose column is collapsed
        coast_nodes = np.unique(node_id[collapsed, 0])
        tagged["coastline"] = {0: coast_nodes.reshape(-1, 1)}
    else:
        # vertical-wall geometries (flat variant): coastline = the
        # surface perimeter edges that are not on the periodic seam
        # (matching the reference's 1D "coastline" curve group,
        # meshes/channel_basin_flat.jl:128)
        edges = {}
        for t in surface:
            for i0, i1 in ((0, 1), (1, 2), (0, 2)):
                e = (min(t[i0], t[i1]), max(t[i0], t[i1]))
                edges[e] = edges.get(e, 0) + 1
        per = np.array([e for e, n in edges.items() if n == 1], np.int64)
        if pairs is not None:
            is_slave = np.zeros(len(coords), bool)
            is_slave[pairs[:, 0]] = True
            is_master = np.zeros(len(coords), bool)
            is_master[pairs[:, 1]] = True
            on_seam = ((is_slave[per[:, 0]] & is_slave[per[:, 1]])
                       | (is_master[per[:, 0]] & is_master[per[:, 1]]))
            per = per[~on_seam]
        tagged["coastline"] = {1: per}
    return Mesh(tdim=3, coords=coords, cells=tets, tagged=tagged,
                periodic_pairs=pairs)


def channel_basin(h: float, alpha: float = 0.125, nz: int | None = None,
                  refinement_factor=None) -> Mesh:
    """3D channel+basin composite: an x-periodic re-entrant channel
    (south) feeding a closed basin (north) with parabolic sidewalls
    and rounded corners -- the reference's production geometry
    (reference meshes/channel_basin.jl:4-110; L=2, W=1, channel length
    L/4, basin flat width W/2, depth H = alpha*W).

    Terrain-following construction: a level-set phi(x, y) describes
    the footprint (full-width channel south of y=-0.5 union a
    rounded-rectangle basin), boundary grid vertices are snapped onto
    phi=0 for a body-fitted coastline, and columns of nz sigma layers
    collapse at the coast exactly like bowl3D.  The periodic seam is
    exactly conforming (see :func:`_sigma_composite`).

    ``refinement_factor`` grades the vertical layers so the spacing at
    the bottom and surface shrinks by that factor -- the sigma-mesh
    equivalent of the reference's near-boundary Distance/Threshold
    refinement (meshes/channel_basin.jl:123-158); in a terrain-following
    mesh the distance to the sloped bottom IS the vertical coordinate,
    so vertical grading refines exactly where the Gmsh field would.

    Tags: "bottom", "surface", "coastline", "interior";
    ``periodic_pairs`` identifies x=1 with x=0 (channel seam).
    """
    L, W = 2.0, 1.0
    H = alpha * W
    L_channel = L / 4.0                 # channel spans y in [-1, -0.5]
    y_ch_top = -L / 2 + L_channel
    L_flat = L_channel / 4.0
    L_curve = (L_channel - L_flat) / 2.0
    y_rise = -L / 2 + L_curve + L_flat  # channel bottom starts rising
    Wc = W / 4.0                        # basin sidewall width (W_curve)
    # basin spine rectangle: x in [Wc, W-Wc], y in [-0.75, L/2 - Wc]
    sx0, sx1 = Wc, W - Wc
    sy0, sy1 = -L / 2 + L_channel / 2.0, L / 2 - Wc

    def spine_dist(x, y):
        dx = np.maximum(np.maximum(sx0 - x, x - sx1), 0.0)
        dy = np.maximum(np.maximum(sy0 - y, y - sy1), 0.0)
        return np.hypot(dx, dy)

    def phi2(x, y):
        # channel region: inside for all x when y <= y_ch_top
        ch = np.where(y <= y_ch_top, Wc, -np.inf)
        basin = Wc - spine_dist(x, y)
        return np.maximum(ch, basin)

    def depth(x, y):
        """Water depth: channel y-profile union basin footprint."""
        # channel: vertical wall at y=-1, flat -H, parabolic rise to 0
        t = np.clip((y_ch_top - y) / (y_ch_top - y_rise), 0.0, 1.0)
        d_ch = np.where(y <= y_ch_top, H * t * (2.0 - t), 0.0)
        # basin: parabolic sidewalls in distance-to-spine
        s = np.clip(1.0 - spine_dist(x, y) / Wc, 0.0, 1.0)
        d_basin = H * s * (2.0 - s)
        return np.maximum(d_ch, d_basin)

    return _sigma_composite(h, phi2, depth, L, W, y_ch_top, H, nz,
                            refinement_factor)


def channel_basin_flat(h: float, alpha: float = 0.125,
                       nz: int | None = None,
                       refinement_factor=None) -> Mesh:
    """Flat-bottom channel_basin variant: constant depth H = alpha*W
    over the full [0, W] x [-L/2, L/2] footprint with vertical walls,
    x-periodic in the channel part y <= -L/2 + L/4 (reference
    meshes/channel_basin_flat.jl).  Coastline = the surface perimeter
    edges off the seam; the walls are tagged "bottom" like the
    reference's wall surfaces (channel_basin_flat.jl:126-131).
    """
    L, W = 2.0, 1.0
    H = alpha * W
    y_ch_top = -L / 2 + L / 4.0
    return _sigma_composite(h, None, lambda x, y: H + 0.0 * x, L, W,
                            y_ch_top, H, nz, refinement_factor)


def channel_basin_no_flat(h: float, alpha: float = 0.125,
                          nz: int | None = None,
                          refinement_factor=None) -> Mesh:
    """channel_basin variant without the flat basin floor: the basin
    cross-section is a single width parabola of max depth H = alpha*W
    at x = W/2, extruded straight to y = L/2 (squared-off end wall) --
    reference meshes/channel_basin_no_flat.jl (basin Bezier through
    (W/2, -2H) gives depth 4H (x/W)(1 - x/W)).
    """
    L, W = 2.0, 1.0
    H = alpha * W
    L_channel = L / 4.0
    y_ch_top = -L / 2 + L_channel
    L_flat = L_channel / 4.0
    L_curve = (L_channel - L_flat) / 2.0
    y_rise = -L / 2 + L_curve + L_flat
    y_basin0 = -L / 2 + L_channel / 2.0   # basin starts at channel center

    def depth(x, y):
        t = np.clip((y_ch_top - y) / (y_ch_top - y_rise), 0.0, 1.0)
        d_ch = np.where(y <= y_ch_top, H * t * (2.0 - t), 0.0)
        s = x / W
        d_basin = np.where(y >= y_basin0, 4.0 * H * s * (1.0 - s), 0.0)
        return np.maximum(d_ch, d_basin)

    return _sigma_composite(h, None, depth, L, W, y_ch_top, H, nz,
                            refinement_factor)


def channel_basin_no_flat_round_end(h: float, alpha: float = 0.125,
                                    nz: int | None = None,
                                    refinement_factor=None) -> Mesh:
    """channel_basin_no_flat with a revolved rounded basin end: for
    y > L/2 - W/2 the depth is H (1 - (2r/W)^2) with r the distance
    to (W/2, L/2 - W/2), and the channel's flat part is 5/8 of its
    length -- reference meshes/channel_basin_no_flat_round_end.jl
    (the revolved Bezier (r=0, -H) -> (W/2, 0) is z = -H (1 - t^2)
    with r = W t / 2).
    """
    L, W = 2.0, 1.0
    H = alpha * W
    L_channel = L / 4.0
    L_flat = 5.0 * L_channel / 8.0
    y_ch_top = -L / 2 + L_channel
    y_rise = -L / 2 + L_flat
    y_basin0 = -L / 2 + L_channel / 2.0
    yc = L / 2 - W / 2                   # round-end revolution center y

    def depth(x, y):
        t = np.clip((y_ch_top - y) / (y_ch_top - y_rise), 0.0, 1.0)
        d_ch = np.where(y <= y_ch_top, H * t * (2.0 - t), 0.0)
        s = x / W
        d_par = np.where((y >= y_basin0) & (y <= yc),
                         4.0 * H * s * (1.0 - s), 0.0)
        r = np.hypot(x - W / 2, np.maximum(y - yc, 0.0))
        d_round = np.where(y > yc,
                           H * np.maximum(1.0 - (2.0 * r / W) ** 2, 0.0), 0.0)
        return np.maximum(np.maximum(d_ch, d_par), d_round)

    def phi2(x, y):
        # full rectangle except beyond the rounded end
        r = np.hypot(x - W / 2, np.maximum(y - yc, 0.0))
        return np.where(y <= yc, W / 2, W / 2 - r)

    return _sigma_composite(h, phi2, depth, L, W, y_ch_top, H, nz,
                            refinement_factor)


def sphere_mesh(n: int = 8, radius: float = 1.0) -> Mesh:
    """Solid ball tet mesh via the cube-to-ball radial map
    (reference meshes/mesh_sphere.jl: gmsh occ sphere with
    "boundary"/"interior" groups).

    ``n``: cells per cube half-axis (resolution ~ radius/n).
    """
    m = box_mesh(2 * n, 2 * n, 2 * n, lo=(-1, -1, -1), hi=(1, 1, 1))
    p = m.coords.copy()
    linf = np.abs(p).max(axis=1)
    l2 = np.linalg.norm(p, axis=1)
    scale = np.where(l2 > 0, linf / np.where(l2 > 0, l2, 1.0), 0.0)
    coords = radius * p * scale[:, None]
    bf = m.tagged["boundary"][2]
    tagged = {
        "boundary": {2: bf},
        "surface": {2: bf},
        "interior": {3: m.cells},
    }
    return Mesh(tdim=3, coords=coords, cells=m.cells.copy(), tagged=tagged)


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


def _strip_columns(ys, depth, h, add_node):
    """Column-strip triangulation helper shared by the x-z/y-z slice
    generators: quasi-uniform vertical chains per abscissa, two-pointer
    strips between neighbors.  Returns (columns, cells)."""
    columns = []
    for y in ys:
        Hy = max(depth(y), 0.0)
        if Hy <= 1e-14:
            columns.append(np.array([add_node(y, 0.0)]))
        else:
            nzi = max(1, int(round(Hy / h)))
            zs = np.linspace(-Hy, 0.0, nzi + 1)
            columns.append(np.array([add_node(y, z) for z in zs]))
    return columns


def channel2D(h: float, alpha: float = 0.5) -> Mesh:
    """2D meridional (y-z) channel section with curved bottom and a
    basin wall, matching the reference channel2D geometry
    (reference meshes/mesh_channel2D.jl:4-42): y in [-1, -0.5], depth
    H = alpha, bottom descends along a quadratic Bezier over
    L_curve = 0.1875 then runs flat to the vertical "basin" wall at
    y = -0.5.  Tags: "bottom", "surface", "basin", "coastline".
    """
    H = alpha
    L_channel = 0.5
    L_flat = L_channel / 4.0
    L_curve = (L_channel - L_flat) / 2.0
    y0, y1 = -1.0, -0.5

    def depth(y):
        if y <= y0 + L_curve:
            t = (y - y0) / L_curve
            return H * t * (2.0 - t)  # quadratic Bezier profile
        return H

    ny = max(4, int(round((y1 - y0) / h)))
    ys = np.linspace(y0, y1, ny + 1)
    coords = []

    def add_node(y, z):
        coords.append((0.0, y, z))
        return len(coords) - 1

    columns = _strip_columns(ys, depth, h, add_node)
    cells = []
    for ci in range(ny):
        A, B = columns[ci], columns[ci + 1]
        a = b = 0
        cs = np.array(coords)
        while a < len(A) - 1 or b < len(B) - 1:
            can_a, can_b = a < len(A) - 1, b < len(B) - 1
            if can_a and can_b:
                da = np.linalg.norm(cs[A[a + 1]] - cs[B[b]])
                db = np.linalg.norm(cs[B[b + 1]] - cs[A[a]])
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
    coords = np.array(coords)

    tops = np.array([c[-1] for c in columns])
    bots = np.array([c[0] for c in columns])
    surface = np.stack([tops[:-1], tops[1:]], axis=1)
    bottom = np.stack([bots[:-1], bots[1:]], axis=1)
    wall = columns[-1]
    basin = np.stack([wall[:-1], wall[1:]], axis=1)
    coast = np.array([[columns[0][0]]])
    tagged = {
        "surface": {1: surface},
        "bottom": {1: bottom},
        "basin": {1: basin},
        "coastline": {0: coast},
        "interior": {2: cells},
    }
    return Mesh(tdim=2, coords=coords, cells=cells, tagged=tagged, plane=(1, 2))


def boundary_facets(cells: np.ndarray) -> np.ndarray:
    """Facets of a simplex mesh appearing in exactly one cell
    (vectorized: sort-rows + run-length uniqueness)."""
    from itertools import combinations

    nvert = cells.shape[1]
    idx = list(combinations(range(nvert), nvert - 1))
    faces = np.sort(np.concatenate([cells[:, i] for i in idx], axis=0), axis=1)
    order = np.lexsort(faces.T[::-1])
    f = faces[order]
    neq = np.any(f[1:] != f[:-1], axis=1)
    once = np.concatenate([[True], neq]) & np.concatenate([neq, [True]])
    return f[once].astype(np.int64)


def channel3D(h: float, W: float = 0.5, D0: float = 0.5, Lx: float = 1.0,
              nz: int | None = None) -> Mesh:
    """Re-entrant (x-periodic) 3D channel: parabolic cross-section
    depth D(y) = D0 (1 - (2y/W)^2), y in [-W/2, W/2], extruded along
    x in [0, Lx] -- the reference's ``channel.msh`` geometry
    (reference meshes/channel.jl:8-25, incl. the setPeriodic x-BC).

    Tags: "bottom", "surface", "coastline", "interior";
    ``mesh.periodic_pairs`` identifies the x = Lx plane with x = 0.
    """
    def depth(y):
        s = 2.0 * y / W
        return D0 * (1.0 - s * s)

    # cross-section strip mesh in (y, z)
    ny = max(4, int(round(W / h)))
    ys = np.linspace(-W / 2, W / 2, ny + 1)
    cs_coords = []

    def add_cs(y, z):
        cs_coords.append((y, z))
        return len(cs_coords) - 1

    columns = _strip_columns(ys, depth, h, add_cs)
    cs_coords = np.array(cs_coords)
    cs = np.array(cs_coords)
    tris = []
    for ci in range(ny):
        A, B = columns[ci], columns[ci + 1]
        a = b = 0
        while a < len(A) - 1 or b < len(B) - 1:
            can_a, can_b = a < len(A) - 1, b < len(B) - 1
            if can_a and can_b:
                da = np.linalg.norm(cs[A[a + 1]] - cs[B[b]])
                db = np.linalg.norm(cs[B[b + 1]] - cs[A[a]])
                use_a = da <= db
            else:
                use_a = can_a
            if use_a:
                tris.append((A[a], B[b], A[a + 1]))
                a += 1
            else:
                tris.append((A[a], B[b], B[b + 1]))
                b += 1
    tris = np.array(tris, dtype=np.int64)
    ncs = len(cs_coords)

    # extrude along x
    nx = max(2, int(round(Lx / h)))
    node_id = np.arange((nx + 1) * ncs).reshape(nx + 1, ncs)
    coords = np.zeros(((nx + 1) * ncs, 3))
    for lev in range(nx + 1):
        coords[node_id[lev], 0] = Lx * lev / nx
        coords[node_id[lev], 1] = cs_coords[:, 0]
        coords[node_id[lev], 2] = cs_coords[:, 1]

    tets = []
    for (a, b, c) in tris:
        for lev in range(nx):
            prism = [
                node_id[lev, a], node_id[lev, b], node_id[lev, c],
                node_id[lev + 1, a], node_id[lev + 1, b], node_id[lev + 1, c],
            ]
            tets.extend(_split_prism(prism))
    tets = np.array(tets, dtype=np.int64)

    # classify boundary facets by plane
    bf = boundary_facets(tets)
    z = coords[:, 2]
    x = coords[:, 0]
    on_sfc = np.all(np.abs(z[bf]) < 1e-12, axis=1)
    on_end = np.all(np.abs(x[bf]) < 1e-12, axis=1) | np.all(
        np.abs(x[bf] - Lx) < 1e-12, axis=1
    )
    surface = bf[on_sfc & ~on_end]
    bottom = bf[~on_sfc & ~on_end]
    # coastline: the two surface side lines y = +-W/2
    coast_rows = [columns[0][0], columns[-1][0]]
    coast = []
    for r in coast_rows:
        ids = node_id[:, r]
        coast.append(np.stack([ids[:-1], ids[1:]], axis=1))
    coast = np.vstack(coast)

    pairs = np.stack([node_id[nx], node_id[0]], axis=1)
    tagged = {
        "surface": {2: surface},
        "bottom": {2: bottom},
        "coastline": {1: coast},
        "interior": {3: tets},
    }
    return Mesh(tdim=3, coords=coords, cells=tets, tagged=tagged,
                periodic_pairs=pairs)


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


@build_step("mesh")
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
