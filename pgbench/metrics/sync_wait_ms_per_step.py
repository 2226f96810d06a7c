"""Host ms a step blocked in the program's reads of device values (the
``sync.*`` spans: each read's wait for the queue to drain and its copy),
in the program pass's replays with the program's tracing on."""


def read(rec):
    p = rec.get("program")
    if not p:
        return None
    return 1e3 * sum(s["total_s"] for k, s in p["spans"].items()
                     if k.startswith("sync.")) / p["steps"]
