"""The traced replays' least device time (as kernels_roofline) over their
host wall time, %: the whole step's share of the card's peak."""


def read(rec):
    t = rec.get("trace") or {}
    if not t.get("wall_s") or not t.get("least_s"):
        return None
    return 100.0 * t["least_s"] / t["wall_s"]
