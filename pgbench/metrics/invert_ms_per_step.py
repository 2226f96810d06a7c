"""Host ms a step inside PGModel._invert_pure (FGMRES with the
block-Stokes preconditioner), between two synchronises, in the traced
window."""


def read(rec):
    s = rec.get("spans_s", {}).get("invert")
    return None if s is None else 1e3 * s / rec["steps"]
