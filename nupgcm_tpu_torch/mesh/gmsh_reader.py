"""Gmsh ``.msh`` v4.1 (ASCII) reader (host-side).

Replaces the reference's GridapGmsh/Gmsh C++ dependency for mesh
*loading* (reference src/meshes.jl:29-38); mesh *generation* stays
offline (use gmsh yourself or the programmatic generators in
``nupgcm_tpu_torch.mesh.generators``).

Supports the subset of the format the reference meshes use
(meshes/bowl*{2,3}D_*.msh): $MeshFormat 4.1, $PhysicalNames,
$Entities, $Nodes, $Elements with element types point(15), line(1),
triangle(2), tet(4).  Physical groups on entities of any dimension are
collected into ``Mesh.tagged[name][dim]`` simplex lists.

2D meshes are expected in the x-z plane (y == 0 for all nodes), the
convention of the reference's 2D bowl/channel meshes.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh

_NODES_PER_TYPE = {15: 1, 1: 2, 2: 3, 4: 4}
_DIM_PER_TYPE = {15: 0, 1: 1, 2: 2, 4: 3}


def _read_blocks(path: str) -> dict[str, list[str]]:
    blocks: dict[str, list[str]] = {}
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("$") and not line.startswith("$End"):
            name = line[1:]
            j = i + 1
            body = []
            end = f"$End{name}"
            while j < len(lines) and lines[j].strip() != end:
                body.append(lines[j])
                j += 1
            blocks[name] = body
            i = j + 1
        else:
            i += 1
    return blocks


def read_msh(path: str) -> Mesh:
    coords, cells, tagged, tdim = read_msh_arrays(path)
    return Mesh(tdim=tdim, coords=coords, cells=cells, tagged=tagged)


def read_msh_arrays(path: str):
    """Parse a .msh into raw arrays (coords, cells, tagged, tdim) in
    FILE order -- no orientation fixing.  ``read_msh`` wraps this in a
    Mesh; reference-interop (io/gridap.py) needs the raw connectivity
    because Gridap's topology numbering is derived from it."""
    blocks = _read_blocks(path)
    if "MeshFormat" not in blocks:
        raise ValueError(f"{path}: not a gmsh msh file")
    version = blocks["MeshFormat"][0].split()[0]
    if not version.startswith("4"):
        raise ValueError(f"{path}: unsupported msh version {version} (need 4.x ASCII)")

    # ---- physical names ---------------------------------------------
    phys_names: dict[tuple[int, int], str] = {}
    if "PhysicalNames" in blocks:
        body = blocks["PhysicalNames"]
        n = int(body[0])
        for k in range(1, n + 1):
            parts = body[k].split(maxsplit=2)
            dim, tag = int(parts[0]), int(parts[1])
            name = parts[2].strip().strip('"')
            phys_names[(dim, tag)] = name

    # ---- entities: map (dim, entity_tag) -> [physical tags] ---------
    ent_phys: dict[tuple[int, int], list[int]] = {}
    if "Entities" in blocks:
        body = blocks["Entities"]
        counts = [int(x) for x in body[0].split()]
        npoints, ncurves, nsurf, nvol = counts
        row = 1
        for _ in range(npoints):
            vals = body[row].split()
            row += 1
            tag = int(vals[0])
            nphys = int(vals[4])
            ent_phys[(0, tag)] = [int(v) for v in vals[5 : 5 + nphys]]
        for dim, ndim in ((1, ncurves), (2, nsurf), (3, nvol)):
            for _ in range(ndim):
                vals = body[row].split()
                row += 1
                tag = int(vals[0])
                nphys = int(vals[7])
                ent_phys[(dim, tag)] = [int(v) for v in vals[8 : 8 + nphys]]

    # ---- nodes -------------------------------------------------------
    body = blocks["Nodes"]
    header = [int(x) for x in body[0].split()]
    num_blocks, num_nodes = header[0], header[1]
    node_ids = np.empty(num_nodes, dtype=np.int64)
    node_xyz = np.empty((num_nodes, 3), dtype=np.float64)
    row, out = 1, 0
    for _ in range(num_blocks):
        _, _, _, n = (int(x) for x in body[row].split())
        row += 1
        for k in range(n):
            node_ids[out + k] = int(body[row + k])
        row += n
        for k in range(n):
            node_xyz[out + k] = [float(v) for v in body[row + k].split()[:3]]
        row += n
        out += n
    # order nodes by gmsh tag (ascending) -- matches Gridap's
    # GmshDiscreteModel vertex numbering; files in the wild list tags
    # contiguously ascending, making this a no-op
    order = np.argsort(node_ids, kind="stable")
    node_ids = node_ids[order]
    node_xyz = node_xyz[order]
    id2idx = np.full(node_ids.max() + 1, -1, dtype=np.int64)
    id2idx[node_ids] = np.arange(num_nodes)

    # ---- elements ----------------------------------------------------
    body = blocks["Elements"]
    header = [int(x) for x in body[0].split()]
    num_blocks = header[0]
    row = 1
    # per (entity_dim, entity_tag): list of (n, nvert) connectivity
    elems_by_entity: dict[tuple[int, int], list[np.ndarray]] = {}
    max_dim = 0
    for _ in range(num_blocks):
        ent_dim, ent_tag, etype, n = (int(x) for x in body[row].split())
        row += 1
        if etype not in _NODES_PER_TYPE:
            raise ValueError(f"{path}: unsupported gmsh element type {etype}")
        nvert = _NODES_PER_TYPE[etype]
        conn = np.empty((n, nvert), dtype=np.int64)
        for k in range(n):
            vals = body[row + k].split()
            conn[k] = [int(v) for v in vals[1 : 1 + nvert]]
        row += n
        conn = id2idx[conn]
        elems_by_entity.setdefault((ent_dim, ent_tag), []).append(conn)
        max_dim = max(max_dim, _DIM_PER_TYPE[etype])

    tdim = max_dim
    cells = np.vstack(
        [np.vstack(v) for (d, _), v in elems_by_entity.items() if d == tdim]
    )

    # ---- physical groups --------------------------------------------
    tagged: dict[str, dict[int, np.ndarray]] = {}
    for (dim, ent_tag), conns in elems_by_entity.items():
        for ptag in ent_phys.get((dim, ent_tag), []):
            name = phys_names.get((dim, ptag), f"phys_{dim}_{ptag}")
            group = tagged.setdefault(name, {})
            arr = np.vstack(conns)
            group[dim] = np.vstack([group[dim], arr]) if dim in group else arr

    return node_xyz, cells, tagged, tdim
