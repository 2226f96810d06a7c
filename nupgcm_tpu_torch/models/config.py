"""User-facing configuration types: Parameters, Forcings, surface BCs,
convection/eddy parameterizations.

API parity with the reference's src/inputs.jl (same nouns, Python
naming).  Coefficients may be constants or callables ``f(x)`` where
``x = (x, y, z)`` arrays (y == 0 on 2D x-z meshes), matching the
reference's 3-component ``VectorValue`` convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Parameters:
    """Nondimensional parameters (reference src/inputs.jl:3-15).

    eps:    Ekman number sqrt(nu0 / (f0 H0^2))
    alpha:  aspect ratio H0 / L0
    mu_rho: Prandtl times Burger number
    N2:     background stratification
    f:      Coriolis parameter, callable of x
    H:      depth function, callable of x
    """

    eps: float
    alpha: float
    mu_rho: float
    N2: float
    f: Callable
    H: Callable

    def __post_init__(self):
        # coerce to plain python floats: a NumPy float64 scalar (e.g.
        # eps=np.sqrt(1e-1)) would make every derived constant a NumPy
        # scalar instead of a plain number
        for name in ("eps", "alpha", "mu_rho", "N2"):
            object.__setattr__(self, name, float(getattr(self, name)))

    @property
    def a2e2(self) -> float:
        return self.alpha ** 2 * self.eps ** 2


@dataclass(frozen=True)
class SurfaceDirichletBC:
    """Dirichlet surface buoyancy b = value (reference src/inputs.jl:35)."""

    value: Any  # constant or callable


@dataclass(frozen=True)
class SurfaceFluxBC:
    """Flux surface BC: a2e2/mu_rho kv (N2 + db/dz) = alpha F
    (reference src/inputs.jl:48, src/evolution.jl:283-292)."""

    flux: Any


@dataclass(frozen=True)
class ConvectionParameterization:
    """Extra vertical diffusivity in unstable regions
    (reference src/inputs.jl:63-91):
    kv_eff = kv + kappa_c (1 + tanh(-abz / N2_min)) / 2."""

    kappa_c: float = 0.0
    N2_min: float = 0.0
    is_on: bool = True

    @staticmethod
    def off() -> "ConvectionParameterization":
        return ConvectionParameterization(0.0, 0.0, is_on=False)

    def kappa_v(self, kv, abz):
        return kv + self.kappa_c * (1.0 + torch.tanh(-abz / self.N2_min)) / 2.0


@dataclass(frozen=True)
class EddyParameterization:
    """Stratification-dependent eddy viscosity
    (reference src/inputs.jl:95-137): nu = f^2 / sqrt(N2_min^2 + abz^2),
    smoothly clamped >= nu_min via LogSumExp."""

    f: Any = 0.0  # callable of x or constant
    N2_min: float = 0.0
    is_on: bool = True
    smoothing: float = 10.0
    nu_min: float = 1.0

    @staticmethod
    def off() -> "EddyParameterization":
        return EddyParameterization(0.0, 0.0, is_on=False)

    def nu(self, f_q, abz):
        s, nmin = self.smoothing, self.nu_min
        nu_eddy = f_q * (f_q / torch.sqrt(self.N2_min ** 2 + abz * abz))
        # stable LogSumExp: the naive log(exp(s a)+exp(s b))/s overflows
        # f32 once s*nu_eddy > ~88 (nu_eddy ~ 9 at s=10), which weakly
        # stratified regions reach easily -- the inf then NaNs the
        # whole inversion matrix
        return torch.logaddexp(torch.full_like(nu_eddy, s * nmin), s * nu_eddy) / s


@dataclass(frozen=True)
class Forcings:
    """Forcing bundle (reference src/inputs.jl:141-189)."""

    nu: Any  # viscosity (constant or callable)
    kappa_h: Any
    kappa_v: Any
    tau_x: Any
    tau_y: Any
    b_surface_bc: Any  # SurfaceDirichletBC | SurfaceFluxBC
    conv_param: ConvectionParameterization = field(
        default_factory=ConvectionParameterization.off
    )
    eddy_param: EddyParameterization = field(default_factory=EddyParameterization.off)
