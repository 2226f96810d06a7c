"""Postprocessing diagnostics: regular-grid resampling, barotropic and
overturning streamfunctions, zonal means, stratification.

Functional parity with the reference's pyvista scripts
(reference postprocess/streamfunctions.py:14-80, postprocess/utils.py:33-100)
but computed directly from the model state via FE point evaluation --
no VTU round-trip or pyvista dependency needed (the VTU files written
by nupgcm_tpu_torch.io.vtk remain compatible with those scripts too).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy.integrate import cumulative_trapezoid, trapezoid

from .utils.misc import to_numpy
from .utils.pointeval import FieldEvaluator


@dataclass
class Grid3:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray

    @classmethod
    def from_mesh(cls, mesh, nx=128, ny=128, nz=64):
        p = mesh.coords
        return cls(
            x=np.linspace(p[:, 0].min(), p[:, 0].max(), nx),
            y=np.linspace(p[:, 1].min(), p[:, 1].max(), ny) if mesh.tdim == 3
            else np.zeros(1),
            z=np.linspace(p[:, 2].min(), p[:, 2].max(), nz),
        )

    @property
    def shape(self):
        return (len(self.x), len(self.y), len(self.z))


def sample_state(model, state, grid: Grid3):
    """Sample u, v, w, b (full buoyancy N^2 z + b') onto the grid.

    Returns dict of (nx, ny, nz) arrays with NaN outside the domain,
    plus 'mask' (1 inside / 0 outside).
    """
    mesh = model.fe.mesh
    ev = FieldEvaluator(mesh)
    xx, yy, zz = np.meshgrid(grid.x, grid.y, grid.z, indexing="ij")
    pts = np.column_stack([xx.ravel(), yy.ravel(), zz.ravel()])
    sp = model.fe.spaces
    u = ev.eval(sp.u_space, to_numpy(state.u), pts)  # (n, 3)
    b = ev.eval(sp.b_space, to_numpy(state.b), pts)
    shape = grid.shape
    out = {
        "u": u[:, 0].reshape(shape),
        "v": u[:, 1].reshape(shape),
        "w": u[:, 2].reshape(shape),
        "b": (model.params.N2 * pts[:, 2] + b).reshape(shape),
        "b_pert": b.reshape(shape),
    }
    out["mask"] = np.isfinite(out["b"]).astype(np.float64)
    return out


def _zeros_outside(a, mask):
    return np.where(mask > 0, np.nan_to_num(a), 0.0)


def depth(samples, grid: Grid3):
    """Water-column depth map H(x, y) from the valid mask
    (reference postprocess/utils.py:82-84)."""
    return trapezoid(samples["mask"], x=grid.z, axis=2)


def zonal_width(samples, grid: Grid3):
    return trapezoid(samples["mask"], x=grid.x, axis=0)


def zonal_mean(field, samples, grid: Grid3):
    w = zonal_width(samples, grid)
    fbar = trapezoid(_zeros_outside(field, samples["mask"]), x=grid.x, axis=0)
    return np.divide(fbar, w, where=w != 0, out=np.full_like(fbar, np.nan))


def barotropic_streamfunction(model, state, grid: Grid3 | None = None):
    """Psi(x, y) = int_y U dy' - cumint_y U with U the depth-integrated
    zonal velocity (reference postprocess/streamfunctions.py:14-45)."""
    if grid is None:
        grid = Grid3.from_mesh(model.fe.mesh)
    s = sample_state(model, state, grid)
    U = trapezoid(_zeros_outside(s["u"], s["mask"]), x=grid.z, axis=2)
    Psi = trapezoid(U, grid.y, axis=1)[:, None] - cumulative_trapezoid(
        U, grid.y, axis=1, initial=0
    )
    H = depth(s, grid)
    U[H == 0] = np.nan
    Psi[H == 0] = np.nan
    return Psi, U, grid


def overturning_streamfunction(model, state, grid: Grid3 | None = None):
    """psi(y, z) = -1/alpha cumint_z (int_x v dx) plus the zonal-mean
    buoyancy (reference postprocess/streamfunctions.py:48-80)."""
    if grid is None:
        grid = Grid3.from_mesh(model.fe.mesh)
    s = sample_state(model, state, grid)
    alpha = model.params.alpha
    v_int = trapezoid(_zeros_outside(s["v"], s["mask"]), x=grid.x, axis=0)
    psi = -1.0 / alpha * cumulative_trapezoid(v_int, grid.z, axis=1, initial=0)
    b_bar = zonal_mean(s["b"], s, grid)
    w = zonal_width(s, grid)
    v_int[w == 0] = np.nan
    psi[w == 0] = np.nan
    return psi, v_int, b_bar, grid


def stratification(model, state, grid: Grid3 | None = None):
    """Horizontally-averaged alpha*db/dz profile (reference
    postprocess/stratification.py:14-43), via finite differences of
    the gridded full buoyancy."""
    if grid is None:
        grid = Grid3.from_mesh(model.fe.mesh)
    s = sample_state(model, state, grid)
    b = s["b"]
    dz = grid.z[1] - grid.z[0]
    bz = np.gradient(b, dz, axis=2)
    alpha = model.params.alpha
    with np.errstate(invalid="ignore"):
        prof = np.nanmean(np.where(s["mask"] > 0, bz, np.nan), axis=(0, 1))
    return alpha * prof, grid.z


def cfl_map(model, state):
    """Per-cell CFL dt = h_K / max|u| at quadrature points (reference
    postprocess/check_cfl.py:23-89 + src/timesteppers.jl:108-119),
    computed on the model's device."""
    c = model.const
    u_q = torch.einsum("qi,cia->cqa", c["phi_u"], state.u[c["cd_u"]])
    speed = to_numpy(torch.linalg.vector_norm(u_q, dim=-1).amax(dim=1))
    nc = model.fe.mesh.n_cells
    h = np.asarray(model.fe.h_cells)[:nc]
    per_cell = h / np.maximum(speed[:nc], 1e-12)
    # report in mesh-canonical cell order (fe tables are RCM-sorted)
    out = np.empty(nc)
    out[np.asarray(model.fe.cell_order)] = per_cell
    return out
