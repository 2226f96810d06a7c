"""Steps per second: every step the window completed over all of its
seconds, the restores between replays included."""


def read(rec):
    return rec["steps"] / rec["window_s"]
