"""BDF1/BDF2 implicit-explicit timesteppers (config + coefficients).

Parity with reference src/timesteppers.jl and the theta coefficients of
src/evolution.jl:187-193:
  theta(BDF1) = dt a^2 e^2 / mu_rho
  theta(BDF2) = (2/3) dt a^2 e^2 / mu_rho
BDF2's first step runs as BDF1 (reference src/model.jl:134-137,
src/evolution.jl:110).

Adaptive CFL stepping works for both orders here: BDF2 uses the
variable-step coefficients (step ratio r = dt_new / dt_old)

    c0 = (1+r)^2/(1+2r),  c1 = r^2/(1+2r),  w = (1+r)/(1+2r)
    theta = w dt a^2 e^2/mu_rho,  extrapolation u* = (1+r) u - r u_prev

which reduce to the fixed-step 4/3, 1/3, 2/3, 2 at r = 1.  The
reference left this as a TODO (src/timesteppers.jl:35) and restricts
adaptivity to BDF1.

Unlike the reference's mutable Ref-based types, these are frozen
configs; the evolving (t, dt) live in the State pytree.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BDF1:
    t_start: float
    t_stop: float
    dt: float
    adaptive: bool = False
    CFL_factor: float = 0.8
    order: int = 1


@dataclass(frozen=True)
class BDF2:
    t_start: float
    t_stop: float
    dt: float
    adaptive: bool = False
    CFL_factor: float = 0.8
    order: int = 2
