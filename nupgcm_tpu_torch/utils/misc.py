"""Small utilities, parity with reference src/utils.jl:6-93."""

from __future__ import annotations

import numpy as np


def to_numpy(x) -> np.ndarray:
    """A host NumPy array of ``x``: a torch tensor on any device (the
    port's state fields) or anything ``np.asarray`` takes."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def chebyshev_nodes(a: float, b: float, n: int) -> np.ndarray:
    """n Chebyshev (Gauss-Lobatto-like) nodes on [a, b], increasing
    (reference chebyshev_nodes, src/utils.jl:6-13)."""
    k = np.arange(n)
    x = -np.cos(np.pi * k / (n - 1)) if n > 1 else np.zeros(1)
    return a + (b - a) * (x + 1.0) / 2.0


def trapz(y: np.ndarray, x: np.ndarray) -> float:
    """Trapezoidal rule skipping NaN samples (reference src/utils.jl:15-27)."""
    y = np.asarray(y, dtype=float)
    x = np.asarray(x, dtype=float)
    ok = np.isfinite(y)
    if ok.sum() < 2:
        return 0.0
    return float(np.trapezoid(y[ok], x[ok]))


def cumtrapz(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Cumulative trapezoid with NaN samples treated as zero
    contribution (reference src/utils.jl:29-39)."""
    y = np.nan_to_num(np.asarray(y, dtype=float))
    x = np.asarray(x, dtype=float)
    from scipy.integrate import cumulative_trapezoid

    return cumulative_trapezoid(y, x, initial=0.0)


def hrs_mins_secs(seconds: float) -> tuple[int, int, int]:
    """(reference src/utils.jl:41-49)."""
    s = int(seconds)
    return s // 3600, (s % 3600) // 60, s % 60


def nan_max(a) -> float:
    return float(np.nanmax(a))


def nan_min(a) -> float:
    return float(np.nanmin(a))


def sci_notation(x: float, decimals: int = 2) -> str:
    """Latex scientific notation (reference src/utils.jl:80-93 and
    postprocess/utils.py:to_latex_sci)."""
    s = f"{x:.{decimals}e}"
    mant, exp = s.split("e")
    return rf"${mant} \times 10^{{{int(exp)}}}$"


def dimensional_parameters(
    *,
    f0: float = 1e-4,       # Coriolis [1/s]
    N0: float = 1e-3,       # buoyancy frequency [1/s]
    H0: float = 4e3,        # depth scale [m]
    L0: float = 4e6,        # horizontal scale [m]
    nu0: float = 1e-2,      # vertical viscosity [m^2/s]
    kappa0: float = 1e-5,   # vertical diffusivity [m^2/s]
):
    """Map dimensional ocean scales to the nondimensional PG numbers
    (reference scratch/run.jl:26-52, docs nondimensionalization):

      eps   = sqrt(nu0 / (f0 H0^2))
      alpha = H0 / L0
      mu_rho = (nu0/kappa0) * (N0 H0 / (f0 L0))^2

    Returns dict with eps, alpha, mu_rho plus derived time scale
    T = 1/(f0 eps^2) and the suggested nondimensional dt per day.
    """
    eps = float(np.sqrt(nu0 / (f0 * H0 ** 2)))
    alpha = H0 / L0
    prandtl = nu0 / kappa0
    burger = (N0 * H0 / (f0 * L0)) ** 2
    mu_rho = prandtl * burger
    T_dim = 1.0 / f0  # nondim time unit [s]
    return {
        "eps": eps,
        "alpha": alpha,
        "mu_rho": mu_rho,
        "prandtl": prandtl,
        "burger": burger,
        "time_unit_seconds": T_dim,
        "nondim_per_day": 86400.0 / T_dim,
    }
