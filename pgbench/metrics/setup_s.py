"""Seconds from the start of the process to the end of the warm-up:
imports, CUDA start, the kernels' build or load, the model's build, the
start state and its advance, and one warm replay of the segment."""


def read(rec):
    return rec["setup_s"]
