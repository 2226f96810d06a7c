"""The traced replays' least device time over their kernels' device time,
%: the least time of every operator application (pgbench/work.py: the
operator's assembled values once, x once, y once, at 3.35 TB/s or two
flops a nonzero at 67 TFLOP/s), whatever kernel applied it, over the sum
of every kernel's device time; from a trace that lost no launch."""


def read(rec):
    t = rec.get("trace") or {}
    if not t.get("kernel_s") or not t.get("least_s"):
        return None
    return 100.0 * t["least_s"] / t["kernel_s"]
