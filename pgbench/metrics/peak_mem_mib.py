"""torch.cuda.max_memory_allocated over the set-up and the window, MiB;
read before the reference runs."""


def read(rec):
    return None if rec["peak_bytes"] is None else rec["peak_bytes"] / 2**20
