"""Host us a launch: the program's ``step`` span less its blocking reads
(``sync.*``), a step, in the program pass's replays with the program's
tracing on, over the launches a step of the traced replays
(``launches_per_step``'s count of the same run)."""


def read(rec):
    p, t = rec.get("program"), rec.get("trace") or {}
    if not p or "step" not in p["spans"] or not t.get("launches"):
        return None
    sync_s = sum(s["total_s"] for k, s in p["spans"].items() if k.startswith("sync."))
    host_us = 1e6 * (p["spans"]["step"]["total_s"] - sync_s) / p["steps"]
    return host_us / (t["launches"] / t["steps"])
