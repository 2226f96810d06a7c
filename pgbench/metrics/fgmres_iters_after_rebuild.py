"""Mean FGMRES iterations of the steps that follow an eddy rebuild: the
steps of the window whose preceding step in the record has aux
``rebuilt`` = 1 (the record's first step has none).  A replay's first
step follows the last step of the replay before it, which, in a segment
that ends in a rebuild, stands for the rebuild before the restored
start.  None where the program's aux has no such key or no step follows
a rebuild."""


def read(rec):
    a = rec.get("aux") or []
    if not a or "rebuilt" not in a[0]:
        return None
    after = [x["inv_iters"] for prev, x in zip(a, a[1:]) if prev["rebuilt"]]
    return sum(after) / len(after) if after else None
