"""Plotting: slices, profiles, simulation bundles, sparsity patterns.

Functional parity with the reference's PyPlot layer (reference
src/plotting.jl): ``plot_slice`` (pcolormesh + buoyancy contours +
optional quiver), ``plot_profiles`` (u, v, w, alpha*dz(b) columns),
``sim_plots`` (per-save bundle), ``plot_sparsity_pattern``.  Uses
matplotlib directly (the reference goes through PyCall to the same
library) and the FE point evaluator for sampling.
"""

from __future__ import annotations

import numpy as np

from .postprocess import Grid3, sample_state
from .utils.misc import to_numpy
from .utils.pointeval import FieldEvaluator


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fill_isolated_nans(F):
    """Fill NaNs that have 4 finite neighbors with their mean
    (reference plot_slice NaN filling, src/plotting.jl:97-111)."""
    nan = np.isnan(F)
    if not nan.any():
        return F
    Fp = np.pad(F, 1, mode="edge")
    nbrs = np.stack([Fp[:-2, 1:-1], Fp[2:, 1:-1], Fp[1:-1, :-2], Fp[1:-1, 2:]])
    fill = nan & np.isfinite(nbrs).all(axis=0)
    F[fill] = nbrs.mean(axis=0)[fill]
    return F


class SliceCache:
    """Precomputed point locations + basis tabulations for one slice
    plane -- the reference's reusable plot cache (src/plotting.jl:84-92):
    per-save bundles re-evaluate fields with one gather + einsum."""

    def __init__(self, model, x=None, y=None, z=None, n=256):
        mesh = model.fe.mesh
        p = mesh.coords
        if z is not None:  # horizontal slice (3D)
            a = np.linspace(p[:, 0].min(), p[:, 0].max(), n)
            b = np.linspace(p[:, 1].min(), p[:, 1].max(), n)
            aa, bb = np.meshgrid(a, b, indexing="ij")
            pts = np.column_stack([aa.ravel(), bb.ravel(),
                                   np.full(n * n, z)])
            self.labels = ("x", "y")
        elif x is not None:  # y-z slice (3D)
            a = np.linspace(p[:, 1].min(), p[:, 1].max(), n)
            b = np.linspace(p[:, 2].min(), p[:, 2].max(), n)
            aa, bb = np.meshgrid(a, b, indexing="ij")
            pts = np.column_stack([np.full(n * n, x), aa.ravel(), bb.ravel()])
            self.labels = ("y", "z")
        else:  # x-z slice at fixed y (default; y ignored on 2D meshes)
            y = 0.0 if y is None else y
            a = np.linspace(p[:, 0].min(), p[:, 0].max(), n)
            b = np.linspace(p[:, 2].min(), p[:, 2].max(), n)
            aa, bb = np.meshgrid(a, b, indexing="ij")
            yy = np.full(n * n, y if mesh.tdim == 3 else 0.0)
            pts = np.column_stack([aa.ravel(), yy, bb.ravel()])
            self.labels = ("x", "z")
        self.n = n
        self.aa, self.bb = aa, bb
        self.pts = pts
        ev = FieldEvaluator(mesh)
        sp = model.fe.spaces
        self.eval_u = ev.prepare(sp.u_space, pts)
        self.eval_b = ev.prepare(sp.b_space, pts)


def plot_slice(model, state, field="b", x=None, y=None, z=None, n=256,
               ofile="slice.png", quiver=False, cmap="RdBu_r", cache=None):
    """Slice plot: pcolormesh of ``field`` with full-buoyancy contours
    and optional in-plane quiver (reference plot_slice,
    src/plotting.jl:60-200).  Slice plane chosen by which of x/y/z is
    given (default: x-z plane at y=0).  Pass the returned ``cache``
    back in to skip point location on subsequent saves."""
    plt = _mpl()
    if cache is None:
        cache = SliceCache(model, x=x, y=y, z=z, n=n)
    n = cache.n
    uvals = cache.eval_u(to_numpy(state.u))
    bvals = cache.eval_b(to_numpy(state.b))
    b_full = model.params.N2 * cache.pts[:, 2] + bvals
    fields = {
        "u": uvals[:, 0], "v": uvals[:, 1], "w": uvals[:, 2],
        "b": b_full, "b_pert": bvals,
    }
    F = _fill_isolated_nans(fields[field].reshape(n, n).copy())
    fig, ax = plt.subplots(figsize=(6, 4))
    vmax = np.nanmax(np.abs(F)) or 1.0
    pc = ax.pcolormesh(cache.aa, cache.bb, F, cmap=cmap, vmin=-vmax,
                       vmax=vmax, shading="auto")
    fig.colorbar(pc, ax=ax, label=field)
    B = _fill_isolated_nans(b_full.reshape(n, n).copy())
    try:
        ax.contour(cache.aa, cache.bb, B, colors="k", linewidths=0.4, levels=12)
    except Exception:
        pass
    if quiver:
        s = max(1, n // 24)
        comp = {"x": "u", "y": "v", "z": "w"}
        qa = fields[comp[cache.labels[0]]].reshape(n, n)
        qb = fields[comp[cache.labels[1]]].reshape(n, n)
        ax.quiver(cache.aa[::s, ::s], cache.bb[::s, ::s],
                  qa[::s, ::s], qb[::s, ::s], color="0.3", width=2e-3)
    ax.set_xlabel(cache.labels[0])
    ax.set_ylabel(cache.labels[1])
    ax.set_title(f"{field} at t = {float(state.t):.3e}")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return cache


def plot_profiles(model, state, x=0.5, y=0.0, n=128, ofile="profiles.png"):
    """Vertical profiles of u, v, w, alpha*dz(b) at (x, y)
    (reference plot_profiles, src/plotting.jl:202-281)."""
    plt = _mpl()
    mesh = model.fe.mesh
    p = mesh.coords
    zs = np.linspace(p[:, 2].min(), 0.0, n)
    pts = np.column_stack([np.full(n, x), np.full(n, y if mesh.tdim == 3 else 0.0), zs])
    ev = FieldEvaluator(mesh)
    sp = model.fe.spaces
    uvals = ev.eval(sp.u_space, to_numpy(state.u), pts)
    bvals = ev.eval(sp.b_space, to_numpy(state.b), pts)
    alpha, N2 = model.params.alpha, model.params.N2
    bz = np.gradient(bvals, zs)
    abz = alpha * (N2 + bz)
    fig, axs = plt.subplots(1, 4, figsize=(10, 4), sharey=True)
    for ax, vals, name in zip(
        axs, [uvals[:, 0], uvals[:, 1], uvals[:, 2], abz],
        ["u", "v", "w", r"$\alpha \partial_z b$"],
    ):
        ax.plot(vals, zs)
        ax.set_xlabel(name)
        ax.grid(alpha=0.3)
    axs[0].set_ylabel("z")
    fig.suptitle(f"profiles at (x, y) = ({x}, {y}), t = {float(state.t):.3e}")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def sim_plots(model, state, out_dir=".", index=0):
    """Per-save plot bundle (reference sim_plots, src/plotting.jl:369-398).
    The slice cache is memoized on the model so repeated saves skip
    point location (the reference's cache-reuse pattern)."""
    cache = getattr(model, "_slice_cache", None)
    files = [f"{out_dir}/b_slice_{index:08d}.png",
             f"{out_dir}/w_slice_{index:08d}.png",
             f"{out_dir}/profiles_{index:08d}.png"]
    cache = plot_slice(model, state, "b", ofile=files[0], cache=cache)
    plot_slice(model, state, "w", ofile=files[1], quiver=True, cache=cache)
    model._slice_cache = cache
    plot_profiles(model, state, ofile=files[2])
    return files


def plot_tri_mesh(model, vals, cb_label="", ofile="tri_mesh.png"):
    """Gouraud-shaded tripcolor of nodal values on the (x, z) plane of
    a 2D mesh (reference plot_tri_mesh, src/plotting.jl:418-441).

    ``vals``: per-vertex values, or a full P2 dof vector (vertex part
    is used -- P2 dofs are vertices then edge midpoints).
    """
    plt = _mpl()
    mesh = model.fe.mesh if hasattr(model, "fe") else model
    p, t = mesh.coords, mesh.cells
    vals = to_numpy(vals)
    if vals.ndim > 1:
        vals = vals.reshape(vals.shape[0], -1)[:, 0]
    vals = vals[: mesh.n_vertices]
    fig, ax = plt.subplots(1)
    vmax = np.nanmax(np.abs(vals)) or 1.0
    img = ax.tripcolor(p[:, 0], p[:, 2], t[:, :3], vals, shading="gouraud",
                       vmin=-vmax, vmax=vmax, cmap="RdBu_r", rasterized=True)
    cb = fig.colorbar(img, ax=ax, label=cb_label)
    cb.ax.ticklabel_format(style="sci", scilimits=(-2, 2), useMathText=True)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_slice_wave(model, u_dofs, b_dofs, N2, k, omega, y=0.0, n=256,
                    ofile="slice_wave.png", cb_label=""):
    """Wave-mode slice: real part of complex eigenmode fields carried
    on e^{ikx} (reference plot_slice_wave, src/plotting.jl:461-543).

    ``u_dofs``/``b_dofs``: complex dof vectors of an eigenmode (from
    tools.eigen); plots Re(w e^{ikx}) with contours of the full
    buoyancy N2 z + Re(b e^{ikx}) on the x-z plane at fixed y.
    """
    plt = _mpl()
    mesh = model.fe.mesh
    sp = model.fe.spaces
    p = mesh.coords
    xs = np.linspace(-np.pi / k, np.pi / k, n)
    zs = np.linspace(p[:, 2].min(), 0.0, n)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    # the mesh lives in its own x range; evaluate at x mod domain
    xm = p[:, 0].min() + np.mod(xx - p[:, 0].min(), np.ptp(p[:, 0]) or 1.0)
    pts = np.column_stack([
        xm.ravel(), np.full(n * n, y if mesh.tdim == 3 else 0.0), zz.ravel()
    ])
    ev = FieldEvaluator(mesh)
    u_dofs, b_dofs = to_numpy(u_dofs), to_numpy(b_dofs)
    ur = ev.eval(sp.u_space, u_dofs.real, pts)
    ui = ev.eval(sp.u_space, u_dofs.imag, pts)
    br = ev.eval(sp.b_space, b_dofs.real, pts)
    bi = ev.eval(sp.b_space, b_dofs.imag, pts)
    carrier = np.exp(1j * k * xx.ravel())
    w = np.real((ur[:, 2] + 1j * ui[:, 2]) * carrier).reshape(n, n)
    b = (N2 * zz.ravel() + np.real((br + 1j * bi) * carrier)).reshape(n, n)
    # fill isolated NaNs with 4-neighbor means (reference :497-511)
    for F in (w, b):
        nan = np.isnan(F)
        if nan.any():
            Fp = np.pad(F, 1, mode="edge")
            nb = np.nanmean(
                np.stack([Fp[:-2, 1:-1], Fp[2:, 1:-1], Fp[1:-1, :-2], Fp[1:-1, 2:]]),
                axis=0,
            )
            F[nan] = nb[nan]
    fig, ax = plt.subplots(1)
    vmax = np.nanmax(np.abs(w)) or 1.0
    pc = ax.pcolormesh(xx, zz, w, cmap="RdBu_r", vmin=-vmax, vmax=vmax,
                       shading="auto", rasterized=True)
    fig.colorbar(pc, ax=ax, label=cb_label or "Re(w)")
    try:
        ax.contour(xx, zz, b, colors="k", linewidths=0.4, levels=12)
    except Exception:
        pass
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_title(f"omega = {omega:.4g}")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_sparsity_pattern(plan, ofile="sparsity.png", markersize=0.1):
    """Sparsity of an assembled operator (reference
    plot_sparsity_pattern, src/plotting.jl:545-578)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(plan.cols, plan.rows, ",", markersize=markersize)
    ax.invert_yaxis()
    ax.set_aspect("equal")
    ax.set_title(f"nnz = {plan.nnz}")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


# ----------------------------------------------------------------------
# publication plot products (parity with reference postprocess/*.py)
# ----------------------------------------------------------------------

def _sym_pcolor(ax, fig, X, Y, F, cmap="RdBu_r", vmax=None, label=""):
    vmax = vmax or (np.nanmax(np.abs(F)) or 1.0)
    im = ax.pcolormesh(X, Y, F, cmap=cmap, vmin=-vmax, vmax=vmax,
                       shading="gouraud", rasterized=True)
    cb = fig.colorbar(im, ax=ax, label=label, fraction=0.05)
    cb.ax.ticklabel_format(style="sci", scilimits=(-2, 2), useMathText=True)
    return vmax


def _b_contours(ax, X, Y, B, alpha=0.25):
    bmin, bmax = np.nanmin(B), np.nanmax(B)
    if not np.isfinite(bmin) or bmax <= bmin:
        return
    db = (bmax - bmin) / 10
    levels = np.linspace(bmin + db, bmax - db, 20)
    try:
        ax.contour(X, Y, B, levels=levels, colors="k", linewidths=0.5,
                   linestyles="-", alpha=alpha)
    except Exception:
        pass


def plot_psi2d(model, state, y=0.0, n=256, ofile="psi2d.png", cache=None):
    """(x, z)-plane streamfunction Psi(x,z) = -cumint_-H^z u dz' with
    full-buoyancy contours (reference postprocess/psi2d.py:14-83;
    their 2D circle/bowl product)."""
    plt = _mpl()
    if cache is None:
        cache = SliceCache(model, y=y, n=n)
    n = cache.n
    u = cache.eval_u(to_numpy(state.u))[:, 0].reshape(n, n)
    b = cache.eval_b(to_numpy(state.b))
    b_full = (model.params.N2 * cache.pts[:, 2] + b).reshape(n, n)
    z1d = cache.bb[0]
    from scipy.integrate import cumulative_trapezoid

    psi = -cumulative_trapezoid(np.nan_to_num(u), z1d, axis=1, initial=0)
    psi[np.isnan(u)] = np.nan
    fig, ax = plt.subplots(1)
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    vmax = _sym_pcolor(ax, fig, cache.aa, cache.bb, psi,
                       label=r"Streamfunction $\Psi$")
    try:
        ax.contour(cache.aa, cache.bb, psi,
                   levels=np.linspace(-0.9 * vmax, 0.9 * vmax, 8),
                   colors="k", linestyles="-", linewidths=0.5)
    except Exception:
        pass
    _b_contours(ax, cache.aa, cache.bb, b_full, alpha=0.3)
    ax.set_xlabel("$x$")
    ax.set_ylabel("$z$")
    ax.set_aspect("equal")
    ax.set_title(f"$t = {float(state.t):.3e}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return cache


def plot_barotropic_streamfunction(model, state, grid=None,
                                   ofile="psi_baro.png", Psimax=None):
    """Psi(x, y) map of the depth-integrated flow (reference
    postprocess/streamfunctions.py:83-117)."""
    from .postprocess import barotropic_streamfunction

    plt = _mpl()
    Psi, U, grid = barotropic_streamfunction(model, state, grid)
    fig, ax = plt.subplots(1)
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    X, Y = np.meshgrid(grid.x, grid.y, indexing="ij")
    vmax = _sym_pcolor(ax, fig, X, Y, Psi, vmax=Psimax, label=r"$\Psi$")
    try:
        ax.contour(X, Y, Psi, levels=np.linspace(-0.9 * vmax, 0.9 * vmax, 8),
                   colors="k", linewidths=0.25)
    except Exception:
        pass
    ax.set_xlabel("$x$")
    ax.set_ylabel("$y$")
    ax.set_aspect("equal")
    ax.set_title(f"$t = {float(state.t):.3e}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_overturning_streamfunction(model, state, grid=None, ofile="psi.png",
                                    rescale_z=False):
    """psi(y, z) overturning cell with zonal-mean-buoyancy contours
    (reference postprocess/streamfunctions.py:156-230)."""
    from .postprocess import overturning_streamfunction

    plt = _mpl()
    psi, v_int, b_bar, grid = overturning_streamfunction(model, state, grid)
    z = grid.z / (2 * np.abs(grid.z).max()) if rescale_z else grid.z
    Y, Z = np.meshgrid(grid.y, z, indexing="ij")
    fig, ax = plt.subplots(1)
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    vmax = _sym_pcolor(ax, fig, Y, Z, psi, label=r"$\psi$")
    try:
        ax.contour(Y, Z, psi, levels=np.linspace(-0.9 * vmax, 0.9 * vmax, 8),
                   colors="k", linewidths=0.25)
    except Exception:
        pass
    _b_contours(ax, Y, Z, b_bar)
    ax.set_xlabel("$y$")
    ax.set_ylabel("$z$" + (" (rescaled)" if rescale_z else ""))
    ax.set_title(f"$t = {float(state.t):.3e}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_zonal_mean(model, state, field="v", grid=None, ofile=None,
                    cb_label=None, rescale_z=False, cmap="RdBu_r"):
    """Zonal-mean field on the (y, z) plane with zonal-mean-buoyancy
    contours (reference postprocess/streamfunctions.py:119-154)."""
    from .postprocess import Grid3, sample_state, zonal_mean

    plt = _mpl()
    if grid is None:
        grid = Grid3.from_mesh(model.fe.mesh)
    s = sample_state(model, state, grid)
    fbar = zonal_mean(s[field], s, grid)
    b_bar = zonal_mean(s["b"], s, grid)
    z = grid.z / (2 * np.abs(grid.z).max()) if rescale_z else grid.z
    Y, Z = np.meshgrid(grid.y, z, indexing="ij")
    fig, ax = plt.subplots(1)
    for sp in ("left", "bottom"):
        ax.spines[sp].set_visible(False)
    _sym_pcolor(ax, fig, Y, Z, fbar, cmap=cmap,
                label=cb_label or rf"$\overline{{{field}}}$")
    _b_contours(ax, Y, Z, b_bar)
    ax.set_xlabel("$y$")
    ax.set_ylabel("$z$" + (" (rescaled)" if rescale_z else ""))
    ax.set_title(f"$t = {float(state.t):.3e}$")
    ofile = ofile or f"zonal_mean_{field}.png"
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def _channel_plane(model, n):
    """(y, z) sampling plane at the 2D channel's x (reference channel2D
    meshes live at x = const; postprocess/channel2D.py:113-125)."""
    p = model.fe.mesh.coords
    x0 = float(p[0, 0])
    y1 = np.linspace(p[:, 1].min(), p[:, 1].max(), n)
    z1 = np.linspace(p[:, 2].min(), p[:, 2].max(), n)
    yy, zz = np.meshgrid(y1, z1, indexing="ij")
    pts = np.column_stack([np.full(n * n, x0), yy.ravel(), zz.ravel()])
    return x0, y1, z1, yy, zz, pts


def plot_channel_psib(model, state, n=256, rescale_z=False, vmax=None,
                      ofile="channel_psi.png"):
    """Channel overturning psi(y,z) = -1/alpha cumint_z v at fixed x,
    with buoyancy contours solid below 0 / dashed above (reference
    postprocess/channel2D.py:108-190)."""
    from scipy.integrate import cumulative_trapezoid

    plt = _mpl()
    _, y1, z1, yy, zz, pts = _channel_plane(model, n)
    ev = FieldEvaluator(model.fe.mesh)
    sp = model.fe.spaces
    v = ev.eval(sp.u_space, to_numpy(state.u), pts)[:, 1].reshape(n, n)
    b = ev.eval(sp.b_space, to_numpy(state.b), pts)
    b_full = (model.params.N2 * pts[:, 2] + b).reshape(n, n)
    alpha = model.params.alpha
    psi = -cumulative_trapezoid(np.nan_to_num(v), z1, axis=1,
                                initial=0) / alpha
    psi[np.isnan(v)] = np.nan
    if rescale_z:
        zz = zz / (2 * alpha)
    fig, ax = plt.subplots(1, figsize=(19 / 6, 19 / 6))
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    vmax = vmax or (np.nanmax(np.abs(psi)) or 1.0)
    im = ax.pcolormesh(yy, zz, psi, vmin=-vmax, vmax=vmax,
                       shading="gouraud", cmap="RdBu_r")
    try:
        ax.contour(yy, zz, psi, levels=np.linspace(-0.9 * vmax, 0.9 * vmax, 8),
                   colors="k", linestyles="-", linewidths=0.25)
        ax.contour(yy, zz, b_full, levels=20, colors="k", alpha=0.25,
                   linestyles="-", linewidths=0.5)
    except Exception:
        pass
    cb = fig.colorbar(im, ax=ax, label=r"$\Psi$", fraction=0.03)
    cb.ax.set_yticks([-vmax, 0, vmax])
    cb.ax.set_yticklabels([r"$-$Max", "$0$", r"$+$Max"])
    ax.annotate(f"Max = {vmax:.3e}", xy=(0.92, 0.98), xycoords="axes fraction")
    ax.set_xlabel("$y$")
    ax.set_ylabel("$z$" + (" (rescaled)" if rescale_z else ""))
    ax.axis("equal")
    ax.set_title(f"$t = {float(state.t):.3e}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_channel_uvwb(model, state, rescale_z=False, ofile="channel_uvwb.png"):
    """Channel section: tripcolor of u with (v, w) quiver and buoyancy
    contours on the 2D triangulation (reference
    postprocess/channel2D.py:60-106)."""
    plt = _mpl()
    mesh = model.fe.mesh
    p, t = mesh.coords, mesh.cells[:, :3]
    nv = mesh.n_vertices
    u = to_numpy(state.u)[:nv]
    b = to_numpy(state.b)[:nv] + model.params.N2 * p[:, 2]
    y, z = p[:, 1], p[:, 2].copy()
    alpha = model.params.alpha
    if rescale_z:
        z = z / (2 * alpha)
    fig, ax = plt.subplots(1, figsize=(19 / 6, 19 / 6))
    vmax = np.max(np.abs(u[:, 0])) or 1.0
    im = ax.tripcolor(y, z, t, u[:, 0], vmin=-vmax, vmax=vmax,
                      shading="gouraud", cmap="RdBu_r")
    try:
        ax.tricontour(y, z, t, b, levels=20, colors="k", alpha=0.25,
                      linestyles="-", linewidths=0.5)
    except Exception:
        pass
    ax.quiver(y, z, u[:, 1], u[:, 2])
    fig.colorbar(im, ax=ax, label="$u$", fraction=0.03)
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    ax.set_xlabel("$y$")
    ax.set_ylabel("$z$" + (" (rescaled)" if rescale_z else ""))
    ax.axis("equal")
    ax.set_title(rf"$\alpha = {alpha:.3f}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_channel_field(model, state, field="v", vals=None, label=None,
                       rescale_z=False, vmax=None, ofile=None):
    """Tripcolor of one field over the 2D channel triangulation with
    buoyancy contours and the mesh overlaid (reference
    postprocess/channel2D.py:13-58).  ``vals`` overrides the field
    lookup with explicit per-dof values (e.g. an effective nu)."""
    plt = _mpl()
    mesh = model.fe.mesh
    p, t = mesh.coords, mesh.cells[:, :3]
    nv = mesh.n_vertices
    if vals is None:
        u = to_numpy(state.u)[:nv]
        fields = {"u": u[:, 0], "v": u[:, 1], "w": u[:, 2],
                  "b": to_numpy(state.b)[:nv] + model.params.N2 * p[:, 2]}
        vals = fields[field]
    else:
        vals = to_numpy(vals).reshape(-1)[:nv]
    b = to_numpy(state.b)[:nv] + model.params.N2 * p[:, 2]
    y, z = p[:, 1], p[:, 2].copy()
    alpha = model.params.alpha
    if rescale_z:
        z = z / (2 * alpha)
    fig, ax = plt.subplots(1, figsize=(19 / 6, 19 / 6))
    vmax = vmax or (np.max(np.abs(vals)) or 1.0)
    im = ax.tripcolor(y, z, t, vals, vmin=-vmax, vmax=vmax,
                      shading="gouraud", cmap="RdBu_r")
    try:
        ax.tricontour(y, z, t, b, levels=20, colors="k", alpha=0.25,
                      linestyles="-", linewidths=0.5)
    except Exception:
        pass
    ax.triplot(y, z, t, "k-", linewidth=0.25, alpha=0.1)
    fig.colorbar(im, ax=ax, label=label or field, fraction=0.03)
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    ax.set_xlabel("$y$")
    ax.set_ylabel("$z$" + (" (rescaled)" if rescale_z else ""))
    ax.axis("equal")
    ax.set_title(rf"$\alpha = {alpha:.3f}$")
    ofile = ofile or f"channel_{field}.png"
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_psi_profile(model, state, y, n=256, ofile="psi_profile.png"):
    """Vertical profile of the channel overturning streamfunction at
    one y (reference postprocess/channel2D.py:192-227)."""
    from scipy.integrate import cumulative_trapezoid

    plt = _mpl()
    p = model.fe.mesh.coords
    x0 = float(p[0, 0])
    z1 = np.linspace(p[:, 2].min(), p[:, 2].max(), n)
    pts = np.column_stack([np.full(n, x0), np.full(n, y), z1])
    ev = FieldEvaluator(model.fe.mesh)
    v = ev.eval(model.fe.spaces.u_space, to_numpy(state.u), pts)[:, 1]
    psi = -cumulative_trapezoid(np.nan_to_num(v), z1,
                                initial=0) / model.params.alpha
    psi[np.isnan(v)] = np.nan
    fig, ax = plt.subplots(1, figsize=(2, 3.2))
    ax.spines["left"].set_visible(False)
    ax.axvline(0, lw=0.5, c="k", ls="-")
    ax.plot(psi, z1)
    ax.set_xlabel(r"$\Psi$")
    ax.set_ylabel("$z$")
    ax.set_title(f"$y = {y:.2f}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_surface_b_flux(model, state, n=256, ofile="sfc_b_flux.png"):
    """Diagnosed surface buoyancy flux F(y) = alpha eps^2 / mu_rho *
    kappa_v_eff * dz(b) |surface, one-sided 2nd-order dz as in the
    reference (postprocess/channel2D.py:229-267, with model parameters
    substituted for its hardcoded Ek/PrBu)."""
    plt = _mpl()
    p = model.fe.mesh.coords
    x0 = float(p[0, 0])
    y1 = np.linspace(p[:, 1].min(), p[:, 1].max(), n)
    zmax, zmin = p[:, 2].max(), p[:, 2].min()
    dz = (zmax - zmin) / (n - 1)
    z3 = zmax - np.array([2 * dz, dz, 0.0])
    ev = FieldEvaluator(model.fe.mesh)
    sp = model.fe.spaces
    pr, fr = model.params, model.forcings
    flux = np.zeros(n)
    pts = np.column_stack([
        np.full(3 * n, x0), np.repeat(y1, 3), np.tile(z3, n)])
    bv = ev.eval(sp.b_space, to_numpy(state.b), pts).reshape(n, 3)
    bz = (0.5 * bv[:, 0] - 2.0 * bv[:, 1] + 1.5 * bv[:, 2]) / dz
    kv = np.array([fr.kappa_v(q) if callable(fr.kappa_v) else fr.kappa_v
                   for q in pts.reshape(n, 3, 3)[:, 2]])
    cp = fr.conv_param
    if cp.is_on and cp.kappa_c:
        abz = pr.alpha * (pr.N2 + bz)
        kv = kv + cp.kappa_c * (1.0 + np.tanh(-abz / cp.N2_min)) / 2.0
    flux = pr.alpha * pr.eps ** 2 / pr.mu_rho * kv * bz
    flux[~np.isfinite(flux)] = 0.0
    fig, ax = plt.subplots(1)
    ax.plot(y1, flux)
    ax.set_xlabel("$y$")
    ax.set_ylabel("$F$")
    ax.spines["bottom"].set_visible(False)
    ax.axhline(0, lw=0.5, c="k", ls="-")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def circulation_plot(model, state, direction="z", location=0.0, n=256,
                     ofile="circulation.png"):
    """Horizontal/vertical circulation phi = cumint flow - int flow
    on a slice (reference postprocess/slice.py:117-176)."""
    from scipy.integrate import cumulative_trapezoid, trapezoid

    plt = _mpl()
    kw = {direction: location}
    cache = SliceCache(model, n=n, **kw)
    u = cache.eval_u(to_numpy(state.u))
    comp = {"x": 2, "y": 2, "z": 1}[direction]  # w, w, v
    flow = u[:, comp].reshape(n, n)
    x1 = cache.aa[:, 0]
    circ = (cumulative_trapezoid(np.nan_to_num(flow), x1, axis=0, initial=0)
            - trapezoid(np.nan_to_num(flow), x1, axis=0)[None, :])
    circ[np.isnan(flow)] = np.nan
    fig, ax = plt.subplots(1)
    for s in ("left", "bottom"):
        ax.spines[s].set_visible(False)
    vmax = _sym_pcolor(ax, fig, cache.aa, cache.bb, circ, label=r"$\phi$")
    try:
        ax.contour(cache.aa, cache.bb, circ,
                   levels=np.linspace(-0.9 * vmax, 0.9 * vmax, 10),
                   colors="k", linestyles="-", linewidths=0.4)
    except Exception:
        pass
    ax.set_xlabel(cache.labels[0])
    ax.set_ylabel(cache.labels[1])
    ax.axis("equal")
    ax.set_title(f"${direction} = {location:.2f}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile


def plot_stratification(model, state, grid=None, ofile="strat.png"):
    """Horizontally-averaged stratification profile alpha dz(b)(z)
    (reference postprocess/stratification.py:95-110)."""
    from .postprocess import stratification

    plt = _mpl()
    prof, z = stratification(model, state, grid)
    fig, ax = plt.subplots(1, figsize=(2.5, 3.2))
    ax.plot(prof, z)
    ax.set_xlabel(r"$\alpha\, \partial_z b$")
    ax.set_ylabel("$z$")
    ax.grid(alpha=0.3)
    ax.set_title(f"$t = {float(state.t):.3e}$")
    fig.savefig(ofile, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return ofile
