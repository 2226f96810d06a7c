"""100 (1 - busy / wall) of the traced replays: the share of their
host wall time in which no kernel, memcpy or memset ran on the card;
from a trace that lost no launch."""


def read(rec):
    t = rec.get("trace") or {}
    if "busy_s" not in t or not t.get("wall_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
