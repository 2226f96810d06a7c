"""Mean CG iterations of the buoyancy step a step (the step's aux)."""


def read(rec):
    a = rec["aux"]
    return sum(x["evo_iters"] for x in a) / len(a) if a else None
