"""Plain reference of the planetary-geostrophic step on a tetrahedral mesh.

It judges what the system under test produced, step by step: given the
state before a step and the state the program returned, it evaluates in
float64 the residuals of the two equations that the step solves, from
the weak forms alone (reference model: src/evolution.jl, src/inversion.jl,
src/model.jl of nuPGCM):

* evolution: (b_new - b)/dt-scheme rows
  M b_new + theta (K_h + K_v) b_new = rhs_adv + theta rhs_diff, on the
  free buoyancy nodes (BDF1, or variable-step BDF2 with ratio r);
* inversion: a2e2 nu grad(u):grad(v) [+ the symmetric-gradient term
  where nu varies] + f (zhat x u).v - (div v) p + q div u
  = (1/alpha) b (zhat.v) + alpha tau.v on the surface, on the free
  velocity nodes and every pressure node;
* the closures: convective K_v from the buoyancy before the step, the
  eddy viscosity from the buoyancy of the last rebuild;
* the CFL-adaptive time step.

Everything is computed here from the raw mesh (vertex coordinates,
tetrahedra, tagged boundary simplices) and the configuration's numbers
and expressions: P2/P1 Lagrange bases, a degree-4 Stroud conical-product
quadrature (3 points an axis), affine geometry, boundary node sets.
Operators are applied matrix-free at the quadrature points, cell block
by cell block, so no element matrix is stored.  The program's vectors
are read in its own node order and placed by their node coordinates.

It imports NumPy, SciPy's Gauss-Jacobi roots and PyTorch only.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import roots_jacobi

from ..expr import evaluate

F64 = torch.float64
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))   # local edges of a tetrahedron
TRI_EDGES = ((0, 1), (0, 2), (1, 2))
BLOCK = 32768     # cells a block: bounds the float64 temporaries on the device


def _gauss_jacobi01(n, a):
    """n-point Gauss rule on [0, 1] for the weight (1 - t)^a."""
    x, w = roots_jacobi(n, a, 0.0)
    return 0.5 * (x + 1.0), w / 2.0 ** (a + 1.0)


def tet_rule(n=3):
    """Stroud conical product rule on the unit tetrahedron (exact to
    degree 2n - 1): points (n^3, 3), weights summing to 1/6."""
    (a, wa), (b, wb), (c, wc) = (_gauss_jacobi01(n, k) for k in (0.0, 1.0, 2.0))
    A, B, C = (t.ravel() for t in np.meshgrid(a, b, c, indexing="ij"))
    W = wa[:, None, None] * wb[None, :, None] * wc[None, None, :]
    pts = np.stack([A * (1 - B) * (1 - C), B * (1 - C), C], axis=1)
    return pts, W.ravel()


def tri_rule(n=3):
    """Conical product rule on the unit triangle: (n^2, 2), weights sum 1/2."""
    (a, wa), (b, wb) = _gauss_jacobi01(n, 0.0), _gauss_jacobi01(n, 1.0)
    A, B = np.meshgrid(a, b, indexing="xy")
    pts = np.stack([(A * (1 - B)).ravel(), B.ravel()], axis=1)
    return pts, (wa[None, :] * wb[:, None]).ravel()


def p2_basis(pts, edges):
    """P2 Lagrange values (npts, nv + ne) and reference gradients
    (npts, nv + ne, d) on a simplex: vertices, then edge midpoints."""
    npts, d = pts.shape
    lam = np.concatenate([1.0 - pts.sum(1, keepdims=True), pts], axis=1)
    dlam = np.concatenate([-np.ones((1, d)), np.eye(d)], axis=0)
    nv = d + 1
    phi = np.empty((npts, nv + len(edges)))
    dphi = np.empty((npts, nv + len(edges), d))
    for i in range(nv):
        phi[:, i] = lam[:, i] * (2 * lam[:, i] - 1)
        dphi[:, i] = (4 * lam[:, i] - 1)[:, None] * dlam[i]
    for k, (i, j) in enumerate(edges):
        phi[:, nv + k] = 4 * lam[:, i] * lam[:, j]
        dphi[:, nv + k] = 4 * (lam[:, i, None] * dlam[j] + lam[:, j, None] * dlam[i])
    return phi, dphi


def node_map(ref_xyz, prog_xyz):
    """Index into the program's node order of each reference node,
    matched by coordinates (exact, since both take the same vertex
    coordinates and edge midpoints).  Raises if they do not match."""
    ref_xyz, prog_xyz = np.asarray(ref_xyz), np.asarray(prog_xyz)
    if ref_xyz.shape != prog_xyz.shape:
        raise ValueError(f"node sets differ: {ref_xyz.shape} vs {prog_xyz.shape}")
    r = np.lexsort(ref_xyz.T[::-1])
    p = np.lexsort(prog_xyz.T[::-1])
    gap = np.abs(ref_xyz[r] - prog_xyz[p]).max() if len(r) else 0.0
    if gap > 1e-12:
        raise ValueError(f"program nodes do not match the mesh's (gap {gap:.3e})")
    out = np.empty(len(r), np.int64)
    out[r] = p
    return out


class Reference:
    """The configuration's equations on one mesh, in float64 on ``device``.

    ``coords`` (nv, 3), ``cells`` (nc, 4) and ``tagged`` ({name: {dim:
    simplices}}) are the raw mesh; ``cfg`` the configuration file's
    dict."""

    def __init__(self, coords, cells, tagged, cfg, device):
        self.dev = torch.device(device)
        self.cfg, self.P = cfg, dict(cfg["params"])
        coords = np.asarray(coords, np.float64)
        cells = np.asarray(cells, np.int64)
        self.nv, self.nc = len(coords), len(cells)
        pairs = np.sort(cells[:, list(EDGES)].reshape(-1, 2), axis=1)
        edges, inv = np.unique(pairs, axis=0, return_inverse=True)
        self.edges = edges
        self.n2 = self.nv + len(edges)
        self.cd2 = np.hstack([cells, self.nv + inv.reshape(-1, 6)])
        self.xyz2 = np.vstack([coords, 0.5 * (coords[edges[:, 0]] + coords[edges[:, 1]])])
        self.xyz1 = coords
        T = lambda a, dt=F64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.dev)
        self.X = T(coords[cells])
        self.cd2_t, self.cd1_t = T(self.cd2, torch.int64), T(cells, torch.int64)

        qp, qw = tet_rule(3)
        phi2, dphi2 = p2_basis(qp, EDGES)
        lam = np.concatenate([1.0 - qp.sum(1, keepdims=True), qp], axis=1)
        dlam = np.broadcast_to(np.concatenate([-np.ones((1, 3)), np.eye(3)])[None], (len(qp), 4, 3))
        self.qw, self.phi2, self.dphi2 = T(qw), T(phi2), T(dphi2)
        self.phi1, self.dphi1 = T(lam), T(dlam)
        # physical quadrature points and edge lengths, on the host
        X = coords[cells]
        xq = np.einsum("qi,cid->cqd", lam, X)
        self.h = T(np.max([np.linalg.norm(X[:, i] - X[:, j], axis=1) for i, j in EDGES], axis=0))
        ev = lambda key: T(evaluate(cfg["coefficients"][key], xq[..., 0], xq[..., 1],
                                    xq[..., 2], self.P))
        self.f_q, self.kh_q, self.kv_q, self.nu_q = ev("f"), ev("kappa_h"), ev("kappa_v"), ev("nu")
        self.eddy, self.conv = cfg.get("eddy"), cfg.get("convection")
        self.variable_nu = self.eddy is not None or isinstance(cfg["coefficients"]["nu"], str)
        if self.eddy is not None:
            self.fe_q = T(evaluate(self.eddy["f"], xq[..., 0], xq[..., 1], xq[..., 2], self.P))

        # boundary nodes: closure (vertices and edges) of tagged simplices
        ekey = edges[:, 0] * self.nv + edges[:, 1]

        def closure(names):
            ids = []
            for name in names:
                for d, simp in tagged[name].items():
                    simp = np.asarray(simp, np.int64)
                    if not simp.size:
                        continue
                    ids.append(simp.ravel())
                    if d >= 1:
                        loc = [(0, 1)] if d == 1 else list(TRI_EDGES if d == 2 else EDGES)
                        pr = np.sort(simp[:, loc].reshape(-1, 2), axis=1)
                        ids.append(self.nv + np.searchsorted(ekey, pr[:, 0] * self.nv + pr[:, 1]))
            return np.unique(np.concatenate(ids))

        bc = cfg["boundary"]
        umask = np.zeros((self.n2, 3), bool)
        for name, comps in bc["u_dirichlet"].items():
            umask[np.ix_(closure([name]), np.asarray(comps))] = True
        bmask = np.zeros(self.n2, bool)
        bmask[closure(bc["b_dirichlet"])] = True
        self.umask, self.bmask = T(umask, torch.bool), T(bmask, torch.bool)

        # surface facets (wind stress)
        fac = np.asarray(tagged[bc["surface"]][2], np.int64)
        fpairs = np.sort(fac[:, list(TRI_EDGES)].reshape(-1, 2), axis=1)
        fedge = self.nv + np.searchsorted(ekey, fpairs[:, 0] * self.nv + fpairs[:, 1])
        self.fac_nodes = np.hstack([fac, fedge.reshape(-1, 3)])
        fq, fw = tri_rule(3)
        self.phif, _ = p2_basis(fq, TRI_EDGES)
        F = coords[fac]
        self.fwq = fw[None] * np.linalg.norm(np.cross(F[:, 1] - F[:, 0], F[:, 2] - F[:, 0]), axis=1)[:, None]
        lf = np.concatenate([1.0 - fq.sum(1, keepdims=True), fq], axis=1)
        self.fxq = np.einsum("qi,cid->cqd", lf, F)
        self._s = None

    # -- program vectors in reference order ---------------------------
    def maps(self, prog_xyz_u, prog_xyz_p, prog_xyz_b):
        """Set the program's node orders (its node coordinates)."""
        self.mu = torch.as_tensor(node_map(self.xyz2, prog_xyz_u), device=self.dev)
        self.mp = torch.as_tensor(node_map(self.xyz1, prog_xyz_p), device=self.dev)
        self.mb = torch.as_tensor(node_map(self.xyz2, prog_xyz_b), device=self.dev)

    def u(self, t):
        return t.to(self.dev, F64).reshape(-1, 3)[self.mu]

    def p(self, t):
        return t.to(self.dev, F64)[self.mp]

    def b(self, t):
        return t.to(self.dev, F64)[self.mb]

    # -- geometry, a block of cells at a time ---------------------------
    def _blocks(self):
        for s in range(0, self.nc, BLOCK):
            X = self.X[s:s + BLOCK]
            J = (X[:, 1:] - X[:, :1]).transpose(1, 2)
            invJT = torch.linalg.inv(J).transpose(1, 2)
            wq = self.qw[None] * torch.abs(torch.linalg.det(J))[:, None]
            G2 = torch.einsum("cpr,qir->cqip", invJT, self.dphi2)
            G1 = torch.einsum("cpr,qir->cqip", invJT, self.dphi1)
            yield slice(s, s + X.shape[0]), wq, G2, G1

    def _abz(self, b):
        """alpha (N2 + db/dz) at the quadrature points."""
        out = []
        for sl, _, G2, _ in self._blocks():
            out.append(torch.einsum("cqi,ci->cq", G2[..., 2], b[self.cd2_t[sl]]))
        return self.P["alpha"] * (self.P["N2"] + torch.cat(out))

    def nu_at(self, b_src):
        """Viscosity at the quadrature points: the configuration's, or the
        eddy closure's from the buoyancy of its last rebuild."""
        if self.eddy is None or b_src is None:
            return self.nu_q
        e = self.eddy
        abz = self._abz(b_src)
        nu_e = self.fe_q * (self.fe_q / torch.sqrt(e["N2_min"] ** 2 + abz * abz))
        s = e["smoothing"]
        return torch.logaddexp(torch.full_like(nu_e, s * e["nu_min"]), s * nu_e) / s

    def kv_at(self, b):
        if self.conv is None:
            return self.kv_q
        c = self.conv
        return self.kv_q + c["kappa_c"] * (1.0 + torch.tanh(-self._abz(b) / c["N2_min"])) / 2.0

    # -- the step's equations -----------------------------------------
    def evolution(self, b_new, b, b_prev, u, u_prev, dt, dt_old, step, xs=()):
        """Residual of the buoyancy step over the free nodes: its 2-norm
        and that of the start guess's residual (CG starts from the old
        b), its max norm relative to the rhs's, and the step's operator
        M + theta K applied to each vector of ``xs`` (all rows)."""
        P = self.P
        bdf2 = self.cfg["timestepper"]["scheme"] == "BDF2" and step > 0
        r = dt / dt_old
        tb = dt * P["alpha"] ** 2 * P["eps"] ** 2 / P["mu_rho"]
        if bdf2:
            w = (1 + r) / (1 + 2 * r)
            th, c0, c1, cdt, w2 = w * tb, (1 + r) ** 2 / (1 + 2 * r), r ** 2 / (1 + 2 * r), w * dt, 1 + r
        else:
            th, c0, c1, cdt, w2 = tb, 1.0, 0.0, dt, 1.0
        kv = self.kv_at(b)
        R = torch.zeros(self.n2, dtype=F64, device=self.dev)
        Y, R0 = torch.zeros_like(R), torch.zeros_like(R)
        AX = [torch.zeros_like(R) for _ in xs]
        for sl, wq, G, _ in self._blocks():
            cd = self.cd2_t[sl]
            bn, be, bpe = b_new[cd], b[cd], b_prev[cd]
            ue = w2 * u[cd] - (w2 - 1) * u_prev[cd]
            bx = w2 * be - (w2 - 1) * bpe
            kq = torch.stack([self.kh_q[sl], self.kh_q[sl], kv[sl]], dim=-1)

            def lhs(x):
                gx = torch.einsum("cqid,ci->cqd", G, x)
                return (torch.einsum("cq,qi,cq->ci", wq, self.phi2,
                                     torch.einsum("qi,ci->cq", self.phi2, x))
                        + th * torch.einsum("cq,cqd,cqid->ci", wq, kq * gx, G))
            uq = torch.einsum("qi,cia->cqa", self.phi2, ue)
            adv = (uq * torch.einsum("cqid,ci->cqd", G, bx)).sum(-1) + uq[..., 2] * P["N2"]
            integ = (c0 * torch.einsum("qi,ci->cq", self.phi2, be)
                     - c1 * torch.einsum("qi,ci->cq", self.phi2, bpe) - cdt * adv)
            rhs = (torch.einsum("cq,qi,cq->ci", wq, self.phi2, integ)
                   - th * P["N2"] * torch.einsum("cq,cq,cqi->ci", wq, kv[sl], G[..., 2]))
            R.index_add_(0, cd.reshape(-1), (lhs(bn) - rhs).reshape(-1))
            R0.index_add_(0, cd.reshape(-1), (lhs(be) - rhs).reshape(-1))
            Y.index_add_(0, cd.reshape(-1), rhs.reshape(-1))
            for x, ax in zip(xs, AX):
                ax.index_add_(0, cd.reshape(-1), lhs(x[cd]).reshape(-1))
        free = ~self.bmask
        return _norm(R[free]), _norm(R0[free]), _relmax(R[free], Y[free]), AX

    def _wind(self):
        if self._s is None:
            s = np.zeros((self.n2, 3))
            co = self.cfg["coefficients"]
            fx = self.fxq
            for a, key in ((0, "tau_x"), (1, "tau_y")):
                tq = evaluate(co[key], fx[..., 0], fx[..., 1], fx[..., 2], self.P)
                vals = self.P["alpha"] * np.einsum("cq,cq,qi->ci", self.fwq, tq, self.phif)
                np.add.at(s[:, a], self.fac_nodes.ravel(), vals.ravel())
            self._s = torch.as_tensor(s, dtype=F64, device=self.dev)
        return self._s

    def inversion(self, u, p, b, nu_q, u0, p0):
        """Residual of the flow inversion over the free rows: its 2-norm
        and that of the start guess's residual (FGMRES starts from the
        old flow ``u0``, ``p0``), its max norm relative to the rhs's, and
        the pressure's volume mean over its mean size."""
        r, y, vol = self._inv_residual(u, p, b, nu_q)
        r0, _, _ = self._inv_residual(u0, p0, b, nu_q)
        pm = float(torch.dot(vol, p).abs() / torch.clamp(torch.dot(vol, p.abs()), min=1e-300))
        return _norm(r), _norm(r0), _relmax(r, y), pm

    def _inv_residual(self, u, p, b, nu_q):
        Au, Ap, By, vol = self.inv_apply(u, p, b, nu_q)
        s = self._wind()
        free = ~self.umask
        return (torch.cat([(Au - By - s)[free], Ap]),
                torch.cat([(By + s)[free], torch.zeros_like(Ap)]), vol)

    def inv_apply(self, u, p, b, nu_q):
        """The inversion operator applied to (u, p), all rows: (A_u (n2, 3),
        A_p (nv)), with B b (n2, 3) and the pressure nodes' volumes."""
        P = self.P
        a2e2 = P["alpha"] ** 2 * P["eps"] ** 2
        Ru = torch.zeros((self.n2, 3), dtype=F64, device=self.dev)
        Rp = torch.zeros(self.nv, dtype=F64, device=self.dev)
        Yu = torch.zeros_like(Ru)
        vol = torch.zeros_like(Rp)
        for sl, wq, G2, G1 in self._blocks():
            cd2, cd1 = self.cd2_t[sl], self.cd1_t[sl]
            ue, pe, be = u[cd2], p[cd1], b[cd2]
            gu = torch.einsum("cqid,cia->cqad", G2, ue)          # du_a/dx_d
            uq = torch.einsum("qi,cia->cqa", self.phi2, ue)
            wn = wq * nu_q[sl]
            flux = gu + gu.transpose(-1, -2) if self.variable_nu else gu
            visc = a2e2 * torch.einsum("cq,cqbd,cqjd->cjb", wn, flux, G2)
            fw = wq * self.f_q[sl]
            cor = torch.stack([-uq[..., 1], uq[..., 0], torch.zeros_like(uq[..., 0])], dim=-1)
            corr = torch.einsum("cq,qj,cqb->cjb", fw, self.phi2, cor)
            pq = torch.einsum("qk,ck->cq", self.phi1, pe)
            grad = -torch.einsum("cq,cq,cqjb->cjb", wq, pq, G2)
            bq = torch.einsum("qi,ci->cq", self.phi2, be)
            by = torch.zeros_like(visc)
            by[..., 2] = torch.einsum("cq,cq,qj->cj", wq, bq, self.phi2) / P["alpha"]
            div = torch.einsum("cqaa->cq", gu)
            Ru.index_add_(0, cd2.reshape(-1), (visc + corr + grad).reshape(-1, 3))
            Yu.index_add_(0, cd2.reshape(-1), by.reshape(-1, 3))
            Rp.index_add_(0, cd1.reshape(-1), torch.einsum("cq,qk,cq->ck", wq, self.phi1, div).reshape(-1))
            vol.index_add_(0, cd1.reshape(-1), torch.einsum("cq,qk->ck", wq, self.phi1).reshape(-1))
        return Ru, Rp, Yu, vol

    def cfl_dt(self, u, dt_old):
        """The CFL-adaptive step from the velocity before the step."""
        ts = self.cfg["timestepper"]
        speed = []
        for sl, _, _, _ in self._blocks():
            uq = torch.einsum("qi,cia->cqa", self.phi2, u[self.cd2_t[sl]])
            speed.append(torch.linalg.vector_norm(uq, dim=-1).amax(dim=1))
        dt = ts["CFL_factor"] * float((self.h / torch.clamp(torch.cat(speed), min=0.01)).min())
        return min(dt, 2.0 * dt_old) if ts["scheme"] == "BDF2" else dt

    def initial_b(self, expr, params):
        """The start buoyancy at the nodes, 0 on Dirichlet nodes."""
        x = self.xyz2
        b = torch.as_tensor(evaluate(expr, x[:, 0], x[:, 1], x[:, 2], dict(self.P, **params)),
                            dtype=F64, device=self.dev)
        return torch.where(self.bmask, torch.zeros_like(b), b)


def _norm(r):
    return float(torch.linalg.vector_norm(r))


def _relmax(r, y):
    return float(r.abs().max() / torch.clamp(y.abs().max(), min=1e-300))


def mesh_figures(coords, cells, tagged) -> dict:
    """Figures of a mesh that do not depend on its numbering: counts of
    vertices, tetrahedra, edges and tagged simplices; the volume and the
    sum of squared cell volumes (which tells one split of the prisms from
    another); each tagged group's measure; the sums of squared
    coordinates.  The
    configuration stores them as the JAX package's generator made them,
    so a mesh the program made differently does not pass as its own."""
    coords = np.asarray(coords, np.float64)
    cells = np.asarray(cells, np.int64)
    X = coords[cells]
    vol = np.abs(np.einsum("ij,ij->i", np.cross(X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]),
                           X[:, 3] - X[:, 0])) / 6.0
    pairs = np.unique(np.sort(cells[:, list(EDGES)].reshape(-1, 2), axis=1), axis=0)
    out = {"vertices": len(coords), "cells": len(cells), "edges": len(pairs),
           "volume": float(vol.sum()), "volume_sq": float((vol ** 2).sum()),
           "coord_sq": [float(s) for s in (coords ** 2).sum(axis=0)]}
    for name in sorted(tagged):
        for d, simp in sorted(tagged[name].items()):
            simp = np.asarray(simp, np.int64).reshape(-1, int(d) + 1)
            S = coords[simp]
            if int(d) == 1:
                m = np.linalg.norm(S[:, 1] - S[:, 0], axis=1)
            elif int(d) == 2:
                m = 0.5 * np.linalg.norm(np.cross(S[:, 1] - S[:, 0], S[:, 2] - S[:, 0]), axis=1)
            else:
                m = np.abs(np.einsum("ij,ij->i", np.cross(S[:, 1] - S[:, 0], S[:, 2] - S[:, 0]),
                                     S[:, 3] - S[:, 0])) / 6.0
            out[f"{name}.{d}"] = [len(simp), float(m.sum())]
    return out


def figures_gap(got: dict, want: dict) -> float:
    """The largest relative gap between two sets of figures (1 where a
    figure is missing on one side)."""
    def flat(d):
        out = {}
        for k, v in d.items():
            for i, x in enumerate(v if isinstance(v, list) else [v]):
                out[f"{k}[{i}]"] = float(x)
        return out

    g, w = flat(got), flat(want)
    if set(g) != set(w):
        return 1.0
    return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-300) for k in w)
