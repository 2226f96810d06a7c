"""Host ms a step of the eddy rebuilds inside ``PGModel.step`` and of the
preconditioner rebuilds after them (the step's aux ``rebuild_s``, each
timed between two synchronises), over the window's steps; None where the
program's aux has no such key."""


def read(rec):
    a = rec.get("aux") or []
    if not a or "rebuild_s" not in a[0]:
        return None
    return 1e3 * sum(x["rebuild_s"] for x in a) / len(a)
