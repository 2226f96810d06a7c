"""Gmsh ``.msh`` v4.1 (ASCII) writer (host-side).

Emits the same format subset the reader consumes (gmsh_reader.py):
$MeshFormat / $PhysicalNames / $Entities / $Nodes / $Elements with
point(15), line(1), triangle(2), tet(4) elements.  Physical groups are
written one entity per (name, dim); top-dimension groups partition the
cell list so a read-back reconstructs exactly one copy of every cell.

This is the counterpart of the reference's offline Gmsh generation
scripts (reference meshes/*.jl write .msh via the gmsh C++ API): it
lets programmatically generated meshes (mesh/generators.py) be cached
to disk and shared with gmsh-ecosystem tools.  Periodic vertex
identifications are not serialized; re-detect with
``detect_periodic_pairs`` after reading.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh

_TYPE_PER_DIM = {0: 15, 1: 1, 2: 2, 3: 4}


def write_msh(mesh: Mesh, path: str):
    coords = mesh.coords
    cells = mesh.cells
    tdim = mesh.tdim
    nv, nc = mesh.n_vertices, mesh.n_cells

    # stable keys for matching top-dim tagged groups to cell rows
    def keys(simplices):
        s = np.sort(simplices, axis=1)
        k = np.zeros(len(s), dtype=np.int64)
        for j in range(s.shape[1]):
            k = k * (nv + 1) + s[:, j]
        return k

    groups = []  # (name, dim, simplices)
    for name, by_dim in mesh.tagged.items():
        for dim, simp in sorted(by_dim.items()):
            groups.append((name, int(dim), np.asarray(simp, np.int64)))

    # partition cells across top-dim groups (first group wins)
    cell_keys = keys(cells)
    order = np.argsort(cell_keys)
    assigned = np.zeros(nc, dtype=bool)
    cell_entities = []  # (phys_tag_or_None, cell_rows)
    phys_names = []  # (dim, tag, name)
    ent_blocks = []  # (dim, ent_tag, phys_tags, simplices)
    next_phys = 1
    next_ent = {0: 1, 1: 1, 2: 1, 3: 1}

    for name, dim, simp in groups:
        ptag = next_phys
        next_phys += 1
        phys_names.append((dim, ptag, name))
        if dim == tdim:
            gk = keys(simp)
            pos = np.clip(np.searchsorted(cell_keys[order], gk), 0, nc - 1)
            idx = order[pos]
            rows = np.unique(idx[cell_keys[idx] == gk])
            rows = rows[~assigned[rows]]
            assigned[rows] = True
            cell_entities.append((ptag, rows))
        else:
            et = next_ent[dim]
            next_ent[dim] += 1
            ent_blocks.append((dim, et, [ptag], simp))
    rest = np.nonzero(~assigned)[0]
    if len(rest):
        cell_entities.append((None, rest))
    for ptag, rows in cell_entities:
        et = next_ent[tdim]
        next_ent[tdim] += 1
        ent_blocks.append((tdim, et, [] if ptag is None else [ptag], cells[rows]))

    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat"]
    if phys_names:
        lines += ["$PhysicalNames", str(len(phys_names))]
        lines += [f'{d} {t} "{n}"' for d, t, n in phys_names]
        lines += ["$EndPhysicalNames"]

    # entities: bounding boxes from the simplices they carry
    by_dim = {0: [], 1: [], 2: [], 3: []}
    for dim, et, ptags, simp in ent_blocks:
        by_dim[dim].append((et, ptags, simp))
    lines += ["$Entities", " ".join(str(len(by_dim[d])) for d in range(4))]
    for d in range(4):
        for et, ptags, simp in by_dim[d]:
            xyz = coords[np.unique(simp)]
            lo, hi = xyz.min(axis=0), xyz.max(axis=0)
            ps = f"{len(ptags)} " + " ".join(map(str, ptags)) if ptags else "0"
            if d == 0:
                lines.append(f"{et} {lo[0]:.16g} {lo[1]:.16g} {lo[2]:.16g} {ps}")
            else:
                lines.append(
                    f"{et} {lo[0]:.16g} {lo[1]:.16g} {lo[2]:.16g} "
                    f"{hi[0]:.16g} {hi[1]:.16g} {hi[2]:.16g} {ps} 0"
                )
    lines += ["$EndEntities"]

    # nodes: one block on the first top-dim entity
    top_tag = by_dim[tdim][0][0]
    lines += ["$Nodes", f"1 {nv} 1 {nv}", f"{tdim} {top_tag} 0 {nv}"]
    lines += [str(i + 1) for i in range(nv)]
    lines += [f"{x:.16g} {y:.16g} {z:.16g}" for x, y, z in coords]
    lines += ["$EndNodes"]

    # elements
    nelem = sum(len(simp) for _, _, _, simp in ent_blocks)
    lines += ["$Elements", f"{len(ent_blocks)} {nelem} 1 {nelem}"]
    tag = 1
    for dim, et, ptags, simp in ent_blocks:
        lines.append(f"{dim} {et} {_TYPE_PER_DIM[dim]} {len(simp)}")
        for row in simp + 1:
            lines.append(f"{tag} " + " ".join(map(str, row)))
            tag += 1
    lines += ["$EndElements", ""]

    with open(path, "w") as f:
        f.write("\n".join(lines))
    return path
