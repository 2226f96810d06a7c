"""1D sloped boundary-layer column model.

Python equivalent of the reference's 1D transect experiment
(reference scratch/1D.jl): buoyancy diffuses vertically on a column
over a slope of angle theta (Crank-Nicolson), and the flow is the
rotating frictional balance along the slope with an optional
zero-transport pressure-gradient constraint:

    buoyancy:   db/dt = (eps^2/mu_rho) dz( kappa (1 + Gamma dz b) )
                bottom: 1 + Gamma dz(b) = 0 (no-flux through slope)
                top:    b = 0
    inversion:  -eps^2 Gamma^2 dz(nu dz u) - f v + Px cos(phi) = b tan(theta)
                -eps^2 Gamma   dz(nu dz v) + f u + Px sin(phi) = 0
                bottom: u = v = 0;  top: dz u = dz v = 0
                constraint: int (u cos(phi) + v sin(phi)) dz = 0, or Px = 0
    w = u tan(theta) (upslope tilt), Gamma = 1 + alpha^2 tan(theta)^2.

Systems are O(100) dofs -- host NumPy dense solves are the right tool
(no accelerator value at this size); grids may be nonuniform
(chebyshev_nodes) via Fornberg finite-difference stencils.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..utils.misc import chebyshev_nodes


def fd_stencil(x: np.ndarray, x0: float, m: int) -> np.ndarray:
    """Finite-difference weights of the m-th derivative at x0 on nodes
    x (Fornberg 1988; the reference's mkfdstencil)."""
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    c = np.zeros((n, m + 1))
    c[0, 0] = 1.0
    c1, c4 = 1.0, x[0] - x0
    for i in range(1, n):
        mn = min(i, m)
        c2, c5 = 1.0, c4
        c4 = x[i] - x0
        for j in range(i):
            c3 = x[i] - x[j]
            c2 *= c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    c[i, k] = c1 * (k * c[i - 1, k - 1] - c5 * c[i - 1, k]) / c2
                c[i, 0] = -c1 * c5 * c[i - 1, 0] / c2
            for k in range(mn, 0, -1):
                c[j, k] = (c4 * c[j, k] - k * c[j, k - 1]) / c3
            c[j, 0] = c4 * c[j, 0] / c3
        c1 = c2
    return c[:, m]


@dataclass
class ColumnModel:
    """1D column over a slope (reference scratch/1D.jl experiment)."""

    H: float = 1.0  # column depth
    nz: int = 128
    eps: float = 1e-1
    alpha: float = 1.0
    mu_rho: float = 1.0
    theta: float = 0.0  # slope angle
    phi: float = 0.0  # angle of the zero-transport direction vs x
    f: float = 1.0
    dt: float = 1e-2
    nu: object = 1.0  # callable z -> nu or constant
    kappa: object = 1.0
    horiz_diff: bool = True  # include the alpha^2 tan^2(theta) factor
    no_Px: bool = False  # drop the transport constraint (Px = 0)
    grid: str = "chebyshev"  # or "uniform"
    z: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.grid == "chebyshev":
            self.z = chebyshev_nodes(-self.H, 0.0, self.nz)
        else:
            self.z = np.linspace(-self.H, 0.0, self.nz)
        self.Gamma = (
            1.0 + self.alpha ** 2 * np.tan(self.theta) ** 2
            if self.horiz_diff else 1.0
        )
        self._kap = self._profile(self.kappa)
        self._nu = self._profile(self.nu)
        self._build_b_system()
        self._build_inversion()

    def _profile(self, v) -> np.ndarray:
        return np.asarray(v(self.z)) if callable(v) else np.full(self.nz, float(v))

    # -- buoyancy: Crank-Nicolson (reference build_b) -------------------
    def _build_b_system(self):
        z, kap, G = self.z, self._kap, self.Gamma
        N = self.nz
        a = self.eps ** 2 / self.mu_rho * self.dt / 2.0
        LHS = np.zeros((N, N))
        RHS = np.zeros((N, N))
        rhs = np.zeros(N)
        for j in range(1, N - 1):
            s1 = fd_stencil(z[j - 1:j + 2], z[j], 1)
            s2 = fd_stencil(z[j - 1:j + 2], z[j], 2)
            kz = s1 @ kap[j - 1:j + 2]
            op = a * G * (kz * s1 + kap[j] * s2)  # a dz(G kappa dz .)
            LHS[j, j] += 1.0
            LHS[j, j - 1:j + 2] -= op
            RHS[j, j] += 1.0
            RHS[j, j - 1:j + 2] += op
            rhs[j] = 2.0 * a * kz  # constant-flux part dz(kappa), both sides
        # bottom: 1 + Gamma dz b = 0
        s1 = fd_stencil(z[:3], z[0], 1)
        LHS[0, :3] = s1
        rhs[0] = -1.0 / G
        # top: b = 0
        LHS[-1, -1] = 1.0
        self._bLHS, self._bRHS, self._brhs = LHS, RHS, rhs
        self._bLU = np.linalg.inv(LHS)  # small dense: explicit inverse

    def step_b(self, b: np.ndarray) -> np.ndarray:
        """One Crank-Nicolson buoyancy step."""
        rhs = self._bRHS @ b
        rhs[0] = self._brhs[0]
        rhs[-1] = 0.0
        rhs[1:-1] += self._brhs[1:-1]
        return self._bLU @ rhs

    # -- inversion (reference build_LHS_inversion) ----------------------
    def _build_inversion(self):
        z, nu = self.z, self._nu
        N = self.nz
        G, eps, f, phi = self.Gamma, self.eps, self.f, self.phi
        n = 2 * N + 1
        A = np.zeros((n, n))
        iu, iv, iP = np.arange(N), N + np.arange(N), 2 * N
        for j in range(1, N - 1):
            s1 = fd_stencil(z[j - 1:j + 2], z[j], 1)
            s2 = fd_stencil(z[j - 1:j + 2], z[j], 2)
            nz_ = s1 @ nu[j - 1:j + 2]
            visc = nz_ * s1 + nu[j] * s2  # dz(nu dz .)
            A[iu[j], iu[j - 1]:iu[j + 1] + 1] -= eps ** 2 * G ** 2 * visc
            A[iu[j], iv[j]] = -f
            A[iu[j], iP] = np.cos(phi)
            A[iv[j], iv[j - 1]:iv[j + 1] + 1] -= eps ** 2 * G * visc
            A[iv[j], iu[j]] = f
            A[iv[j], iP] = np.sin(phi)
        # bottom u = v = 0
        A[iu[0], iu[0]] = 1.0
        A[iv[0], iv[0]] = 1.0
        # top dz u = dz v = 0
        s1 = fd_stencil(z[-3:], z[-1], 1)
        A[iu[-1], iu[-3]:iu[-1] + 1] = s1
        A[iv[-1], iv[-3]:iv[-1] + 1] = s1
        # transport constraint / Px pin
        if self.no_Px:
            A[iP, iP] = 1.0
        else:
            dz = np.diff(z)
            w = np.zeros(N)
            w[:-1] += dz / 2.0
            w[1:] += dz / 2.0
            A[iP, iu] = np.cos(phi) * w
            A[iP, iv] = np.sin(phi) * w
        self._Ainv = np.linalg.inv(A)

    def invert(self, b: np.ndarray):
        """Solve the frictional balance for (u, v, w, Px) given b."""
        N = self.nz
        rhs = np.zeros(2 * N + 1)
        rhs[1:N - 1] = b[1:N - 1] * np.tan(self.theta)
        x = self._Ainv @ rhs
        u, v, Px = x[:N], x[N:2 * N], x[-1]
        w = u * np.tan(self.theta)
        return u, v, w, Px

    # -- driver ----------------------------------------------------------
    def run(self, b0=None, t_stop: float = 1.0):
        """Step buoyancy to t_stop, re-inverting the flow each step.
        Returns (b, u, v, w, Px)."""
        b = np.zeros(self.nz) if b0 is None else np.asarray(b0, np.float64).copy()
        n_steps = int(round(t_stop / self.dt))
        for _ in range(n_steps):
            b = self.step_b(b)
        u, v, w, Px = self.invert(b)
        return b, u, v, w, Px

    def bz(self, b: np.ndarray) -> np.ndarray:
        """dz(b) via the interior stencils (for 1 + dz(b) plots)."""
        z = self.z
        out = np.zeros_like(b)
        for j in range(self.nz):
            lo = min(max(j - 1, 0), self.nz - 3)
            out[j] = fd_stencil(z[lo:lo + 3], z[j], 1) @ b[lo:lo + 3]
        return out
