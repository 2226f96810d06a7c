"""Simplex quadrature rules (host-side, NumPy).

Collapsed Gauss-Jacobi product rules on the reference simplex, built
numerically from scipy's Jacobi-polynomial roots -- no hardcoded point
tables.  A rule of ``degree`` d integrates all polynomials of total
degree <= d exactly (verified in tests/test_quadrature.py by monomial
exactness).

Reference parity: the upstream model integrates all volume and surface
forms with a degree-4 measure (reference src/meshes.jl:29,
``Measure(Omega, degree=4)``).  We default to the same degree but keep
it configurable.

Reference simplices:
  * interval:  {x in [0,1]}
  * triangle:  {x,y >= 0, x+y <= 1}
  * tet:       {x,y,z >= 0, x+y+z <= 1}

The collapsed (Duffy) map from the unit cube:
  triangle: x = xi*(1-eta),            y = eta            | J | = (1-eta)
  tet:      x = xi*(1-eta)*(1-zeta),   y = eta*(1-zeta),
            z = zeta                                      | J | = (1-eta)(1-zeta)^2
Absorbing the Jacobian factors into Gauss-Jacobi weights keeps every
weight positive and gives exactness 2n-1 with n points per axis.
"""

from __future__ import annotations

import numpy as np
from scipy.special import roots_jacobi


def _gauss_jacobi_01(n: int, alpha: float) -> tuple[np.ndarray, np.ndarray]:
    """Nodes/weights on [0,1] for weight function (1-t)^alpha."""
    x, w = roots_jacobi(n, alpha, 0.0)
    t = 0.5 * (x + 1.0)
    # weight transforms: dt = dx/2 and (1-x)^alpha = (2(1-t))^alpha
    w = w / (2.0 ** (alpha + 1.0))
    return t, w


def interval_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    n = degree // 2 + 1
    t, w = _gauss_jacobi_01(n, 0.0)
    return t.reshape(-1, 1), w


def triangle_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Points (nq, 2) and weights (nq,) on the reference triangle."""
    n = degree // 2 + 1
    xi, wxi = _gauss_jacobi_01(n, 0.0)
    eta, weta = _gauss_jacobi_01(n, 1.0)  # absorbs (1-eta)
    X = np.empty((n * n, 2))
    W = np.empty(n * n)
    k = 0
    for j in range(n):
        for i in range(n):
            X[k, 0] = xi[i] * (1.0 - eta[j])
            X[k, 1] = eta[j]
            W[k] = wxi[i] * weta[j]
            k += 1
    return X, W


def tet_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Points (nq, 3) and weights (nq,) on the reference tetrahedron."""
    n = degree // 2 + 1
    xi, wxi = _gauss_jacobi_01(n, 0.0)
    eta, weta = _gauss_jacobi_01(n, 1.0)   # absorbs (1-eta)
    zeta, wzeta = _gauss_jacobi_01(n, 2.0)  # absorbs (1-zeta)^2
    X = np.empty((n ** 3, 3))
    W = np.empty(n ** 3)
    m = 0
    for k in range(n):
        for j in range(n):
            for i in range(n):
                X[m, 0] = xi[i] * (1.0 - eta[j]) * (1.0 - zeta[k])
                X[m, 1] = eta[j] * (1.0 - zeta[k])
                X[m, 2] = zeta[k]
                W[m] = wxi[i] * weta[j] * wzeta[k]
                m += 1
    return X, W


def simplex_rule(tdim: int, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the tdim-dimensional reference simplex."""
    if tdim == 1:
        return interval_rule(degree)
    if tdim == 2:
        return triangle_rule(degree)
    if tdim == 3:
        return tet_rule(degree)
    raise ValueError(f"unsupported simplex dimension {tdim}")


def simplex_volume(tdim: int) -> float:
    """Volume of the reference simplex: 1/tdim!."""
    import math

    return 1.0 / float(math.factorial(tdim))
