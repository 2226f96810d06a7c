"""Device-memory streaming rate by tile size and input count (K4).

PyTorch counterpart of ``tools/profile_stream.py``: one launch of
``stream_probe`` sums ``rows_per_cell x n_cells`` float32 values laid
out in blocks of B cells, one CUDA block per block of cells.

  s3_B128   three inputs per block (the saddle tensors' 900/120/120 rows)
  s1_B128   one input, the same bytes
  s1_B256   one input, blocks twice as large (half the blocks)
  s1_B512   one input, 4x blocks
  s1idx_B%d one input plus eight int32 index rows per block (the
            production kernel's input count)

Every launch gets its own ``w0`` values, as on the TPU.  A block count
is ``n_cells // B`` (cells past the last full block are dropped), and
GB/s counts the bytes streamed.  Each configuration has two times: the
host-clock time of a loop of launches over their count (launch cost
included) and the kernel's device time from a profiler trace.  The
default size, 39 MB, fits in the H100's 50 MB L2; above it the rate is
the device-memory rate.

Usage: python -m nupgcm_tpu_torch.tools.profile_stream [rows_per_cell] [n_cells] [reps]
       defaults 1140 8576 50.  Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from ..ops import kernels as K
from ._common import device_name, device_times, log_print, require_cuda, synchronize

L2_BYTES = 50e6  # H100 L2 cache
CONFIGS = ((3, 128, False), (1, 128, False), (1, 256, False), (1, 512, False),
           (1, 128, True), (1, 512, True))


def config_name(n_inputs: int, B: int, with_idx: bool) -> str:
    return f"s{n_inputs}{'idx' if with_idx else ''}_B{B}"


def run(rows=1140, ncell=8576, reps=50, device="cuda", log=log_print) -> dict:
    """Time each (n_inputs, B, with_idx) of CONFIGS; returns the
    per-configuration ms per launch, GB/s, us per block and blocks."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    total = rows * ncell * 4
    log(f"streaming {total / 1e6:.1f} MB per application "
        f"({'inside' if total <= L2_BYTES else 'above'} the 50 MB L2)")
    results = {}
    for n_inputs, B, with_idx in CONFIGS:
        nb = ncell // B
        if n_inputs == 3:
            shapes = [(nb, r * B // K.LANES, K.LANES) for r in (900, 120, 120)]
        else:
            shapes = [(nb, rows * B // K.LANES, K.LANES)]
        parts = [torch.randn(s, generator=gen, device=device) for s in shapes]
        idx = ([torch.ones((nb, 1, 1280), dtype=torch.int32, device=device)
                for _ in range(8)] if with_idx else None)
        # rep-distinct w0 rows, made before the timed loop
        w0s = torch.arange(reps, dtype=torch.int32, device=device)[:, None].expand(
            reps, nb).contiguous()
        nbytes = sum(p.numel() * 4 for p in parts)

        def loop(n=reps):
            acc = torch.zeros((), device=device)
            for i in range(n):
                o, _ = K.stream_probe(parts, w0s[i], idx)
                acc = acc + o[0, 0]
            return acc

        loop()
        synchronize(device)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            loop()
            synchronize(device)
            ts.append(time.perf_counter() - t0)
        t = statistics.median(ts) / reps
        _, kernel_ms = device_times(loop, reps, device, "stream_probe_kernel")
        name = config_name(n_inputs, B, with_idx)
        results[name] = {"ms": t * 1e3, "gb_s": nbytes / t / 1e9,
                         "us_per_block": t / max(nb, 1) * 1e6, "blocks": nb,
                         "bytes": nbytes, "kernel_ms": kernel_ms,
                         "kernel_gb_s": None if kernel_ms is None else nbytes / kernel_ms / 1e6}
        dev = ("kernel not measured" if kernel_ms is None else
               f"kernel {kernel_ms:.4f} ms = {nbytes / kernel_ms / 1e6:.1f} GB/s")
        log(f"  {name:12s} {t * 1e3:8.4f} ms  {nbytes / t / 1e9:7.1f} GB/s  "
            f"({t / max(nb, 1) * 1e6:6.3f} us/block, {nb} blocks); {dev}")
        del parts, idx
    return {"device": device_name(device), "rows": rows, "ncell": ncell,
            "bytes": total, "in_l2": total <= L2_BYTES, "configs": results}


def main(argv=None):
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    rows = int(argv[0]) if len(argv) > 0 else 1140
    ncell = int(argv[1]) if len(argv) > 1 else 8576
    reps = int(argv[2]) if len(argv) > 2 else 50
    run(rows, ncell, reps)


if __name__ == "__main__":
    main()
