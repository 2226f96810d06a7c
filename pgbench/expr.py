"""Coefficient expressions of a configuration file.

A configuration names each coefficient field (Coriolis parameter,
diffusivities, wind stress, ...) as a NumPy expression in the point's
coordinates ``x``, ``y``, ``z`` and the configuration's scalar
parameters, e.g. ``"1e-2 + exp(-(z + alpha*(1 - x**2 - y**2))/(0.1*alpha))"``.
The system under test receives them as callables and the plain
reference evaluates the same strings, so both read one definition.
"""

from __future__ import annotations

import numpy as np

_FUNCS = {"exp": np.exp, "cos": np.cos, "sin": np.sin, "tanh": np.tanh, "sqrt": np.sqrt,
          "pi": np.pi, "abs": np.abs}


def evaluate(expr, x, y, z, params: dict):
    """``expr`` (a number or a string) at points with coordinate arrays
    ``x``, ``y``, ``z``, broadcast to their shape (float64)."""
    x = np.asarray(x, np.float64)
    if not isinstance(expr, str):
        return np.full(x.shape, float(expr))
    names = dict(_FUNCS, **{k: v for k, v in params.items() if isinstance(v, (int, float))},
                 x=x, y=np.asarray(y, np.float64), z=np.asarray(z, np.float64))
    val = eval(compile(expr, "<coefficient>", "eval"), {"__builtins__": {}}, names)
    return np.broadcast_to(np.asarray(val, np.float64), x.shape).copy()


def callable_of(expr, params: dict):
    """``f((x, y, z))`` for the system under test, or the constant
    itself when ``expr`` is a number."""
    if not isinstance(expr, str):
        return float(expr)
    return lambda X: evaluate(expr, X[0], X[1], X[2], params)
