"""Host calls that made device work (kernel launches, memsets, memcpys)
a step, in the traced replays, from a trace that lost no launch."""


def read(rec):
    t = rec.get("trace") or {}
    return t["launches"] / t["steps"] if "launches" in t else None
