"""Mesh-quality statistics: inner angles and cell volumes.

Parity with the reference's quality tooling
(reference meshes/mesh_quality.jl:16-115): per-cell inner angles
(3 per triangle, 12 per tetrahedron -- one per vertex of each of the
4 triangular faces), cell volumes/areas, and the same summary
statistics (min/max/mean/median/std).  Vectorized NumPy instead of
the reference's per-element loops.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh

_TET_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]


def _tri_angles(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray) -> np.ndarray:
    """(n, 3) inner angles in degrees of triangles (p1, p2, p3)."""

    def ang(a, b, c):
        v1 = a - b
        v2 = c - b
        cosv = np.einsum("ij,ij->i", v1, v2) / (
            np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1))
        return np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0)))

    return np.stack([ang(p2, p1, p3), ang(p1, p2, p3), ang(p2, p3, p1)],
                    axis=1)


def inner_angles(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Sorted inner angles (degrees) of a tri/tet mesh.

    3 angles per triangle; 12 per tet (the reference's convention:
    the inner angles of all four faces, meshes/mesh_quality.jl:56-62).
    """
    X = coords[cells]
    if cells.shape[1] == 3:
        th = _tri_angles(X[:, 0], X[:, 1], X[:, 2])
    else:
        th = np.concatenate(
            [_tri_angles(X[:, i], X[:, j], X[:, k]) for i, j, k in _TET_FACES],
            axis=1)
    return np.sort(th.ravel())


def volumes(coords: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Sorted cell measures: areas for triangles, volumes for tets
    (reference meshes/mesh_quality.jl:87-104)."""
    X = coords[cells]
    if cells.shape[1] == 3:
        n = np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0])
        v = 0.5 * (np.linalg.norm(n, axis=-1) if n.ndim == 2 else np.abs(n))
    else:
        v = np.abs(np.einsum(
            "ij,ij->i",
            np.cross(X[:, 0] - X[:, 3], X[:, 1] - X[:, 3]),
            X[:, 2] - X[:, 3])) / 6.0
    return np.sort(v)


def stats(x: np.ndarray) -> dict:
    """min/max/mean/median/std summary (mesh_quality.jl:106-115)."""
    x = np.asarray(x, dtype=np.float64)
    return {
        "min": float(x.min()),
        "max": float(x.max()),
        "mean": float(x.mean()),
        "median": float(np.median(x)),
        "std": float(x.std()),
    }


def format_stats(title: str, s: dict, variable_name: str = "th") -> str:
    return (
        f"{title}\n"
        f"{s['min']:e} <= {variable_name} <= {s['max']:e}\n"
        f"mean({variable_name}):   {s['mean']:e}\n"
        f"median({variable_name}): {s['median']:e}\n"
        f"std({variable_name}):    {s['std']:e}"
    )


def quality_report(mesh: Mesh) -> dict:
    """Angle + volume statistics for a mesh; the dict also carries the
    formatted text blocks under ``"text"``."""
    th = inner_angles(mesh.coords[:, mesh.plane_axes]
                      if mesh.tdim == 2 else mesh.coords, mesh.cells)
    v = volumes(mesh.coords[:, mesh.plane_axes]
                if mesh.tdim == 2 else mesh.coords, mesh.cells)
    s_th, s_v = stats(th), stats(v)
    text = (format_stats("inner angles (deg)", s_th, "th") + "\n"
            + format_stats("cell measure", s_v, "v"))
    return {"angles": s_th, "volumes": s_v,
            "n_cells": mesh.n_cells, "text": text}
