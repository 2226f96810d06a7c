"""Host ms a step in the program's ``invert.precond_setup`` span (the
inversion preconditioner built anew each solve: its operator wrappers,
the coarse solver, the spectral bounds read back), in the program
pass's replays with the program's tracing on."""


def read(rec):
    p = rec.get("program")
    s = (p or {}).get("spans", {}).get("invert.precond_setup")
    return None if s is None else 1e3 * s["total_s"] / p["steps"]
