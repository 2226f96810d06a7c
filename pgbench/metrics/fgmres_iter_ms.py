"""Host ms an iteration of the inversion's FGMRES (the program's
``fgmres.iter`` span: the preconditioner, the operator, the CGS2
products and the Hessenberg read), in the program pass's replays with
the program's tracing on."""


def read(rec):
    p = rec.get("program")
    s = (p or {}).get("spans", {}).get("fgmres.iter")
    return None if not s or not s["n"] else 1e3 * s["total_s"] / s["n"]
