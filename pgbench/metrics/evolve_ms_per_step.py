"""Host ms a step inside PGModel._evolve_pure (the advection rhs, the
convective K_v where it is on, and the implicit-diffusion CG), between
two synchronises, in the traced window."""


def read(rec):
    s = rec.get("spans_s", {}).get("evolve")
    return None if s is None else 1e3 * s / rec["steps"]
