"""Host reads of device values a step (the program's ``sync.*``
counters: the Krylov solvers' stopping tests and Hessenberg columns, the
preconditioner's spectral bounds, the step's diagnostics), in the
program pass's replays with the program's tracing on
(``pgbench/program.py``)."""


def read(rec):
    p = rec.get("program")
    if not p:
        return None
    return sum(n for k, n in p["counts"].items() if k.startswith("sync.")) / p["steps"]
