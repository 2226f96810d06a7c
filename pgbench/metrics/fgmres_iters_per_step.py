"""Mean FGMRES iterations of the inversion a step (the step's aux)."""


def read(rec):
    a = rec["aux"]
    return sum(x["inv_iters"] for x in a) / len(a) if a else None
