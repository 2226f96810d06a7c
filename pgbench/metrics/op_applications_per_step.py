"""Operator applications a step (the program's ``op.<operator>``
counters, kept by operator in ``rec["program"]["counts"]``), in the
program pass's replays with the program's tracing on."""


def read(rec):
    p = rec.get("program")
    if not p:
        return None
    return sum(n for k, n in p["counts"].items() if k.startswith("op.")) / p["steps"]
