"""Split the saddle matvec's time into streaming and the rest.

PyTorch counterpart of ``tools/profile_matvec.py``.  It times, per
application of the P2-P1 saddle operator of the bowl-mixing model:

  full      the production kernel (K1, ``saddle_matvec`` mode "full")
  uu        the velocity block alone (drops the pressure gathers/scatters)
  stream    K3 (``stream_saddle``): reads exactly K1's element tensors
            and only sums them -- the cost of streaming those bytes
  compute   K1 pinned: every cell reads the tensors of cell c mod 128,
            which stay in cache -- compute, gathers and atomics alone

and prints the tensors' bytes with the floor at 3.35 TB/s.  Each
variant has two times: per application by difference quotient on the
host clock (launch cost included), and its device time from a profiler
trace of n2 applications (busy time, and the variant's own kernel).  The JAX
tool's ``nodedup`` and ``nobucket`` variants time TPU window-plan
options (dedup tables, width buckets) that the port does not have.

Usage:  python -m nupgcm_tpu_torch.tools.profile_matvec [h] [nz]
        defaults h=0.05 nz=8; PROF_ONLY=full,stream selects variants.
        Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..ops import kernels as K
from ._common import (HBM_BYTES_PER_S, bowl_model, device_name, device_times,
                      difference_quotient, log_print, require_cuda)

N1, N2 = 10, 60
VARIANTS = ("full", "uu", "stream", "compute")
KERNEL = {"full": "block_matvec_kernel", "uu": "block_matvec_kernel",
          "stream": "stream_saddle_kernel",
          "compute": "block_matvec_kernel"}  # each variant's own kernel, by name
NOT_APPLICABLE = {v: "not applicable: TPU window-plan variants"
                  for v in ("nodedup", "nobucket")}


def run(h=0.05, nz=8, model=None, device="cuda", dtype=torch.float32, only=None,
        n1=N1, n2=N2, log=log_print) -> dict:
    """Time the variants (``only``: a subset of VARIANTS) on ``model``,
    or on the mixing model of ``bowl3D(h, 0.5, nz)``.  Returns the
    tensors' bytes, the bandwidth floor, ms and GB/s per variant."""
    model = bowl_model(h, nz, device, dtype, model)
    device = model.device
    o, c, fe = model.ops, model.const, model.fe
    uu, up, pu = o["A_uu_e"], o["A_up_e"], o["A_pu_e"]
    cd_u, cd_p = c["cd_u"], c["cd_p"]
    n = fe.spaces.u_space.ndof
    n3 = 3 * n
    nbytes = sum(t.numel() * t.element_size() for t in (uu, up, pu))
    floor_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{fe.summary()}; element tensors {nbytes / 1e6:.1f} MB -> floor at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {floor_ms:.4f} ms")
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal(fe.n_inv),
                         dtype=model.dtype, device=device)

    def loop(body):
        # normalised iterates: each application depends on the last
        def fn(n_app):
            x = x0
            for _ in range(n_app):
                y = body(x)
                x = y / torch.linalg.vector_norm(y)
            return x
        return fn

    def stream_loop(n_app):
        carry = torch.zeros((1, K.LANES), dtype=torch.float32, device=device)
        for _ in range(n_app):
            carry = K.stream_saddle(uu, up, pu, carry)
        return carry

    pin = min(uu.shape[0], K.LANES)
    uu1, up1, pu1 = uu[:pin], up[:pin], pu[:pin]
    n_p = fe.spaces.n_p

    def op(mode, blocks, pinned=False):
        """The model's own launch path on the card (a prepared launch
        over its block tables); the plain version elsewhere."""
        if torch.device(device).type == "cuda":
            return K.saddle_launch(*blocks, c["blk_fine"][mode], mode, n,
                                   0 if mode == "uu" else n_p, pinned=pinned)
        cdp = c["cd_none"] if mode == "uu" else cd_p
        return lambda x: K.saddle_matvec(*blocks, cd_u, cdp, x, mode, n, pinned=pinned)

    full = op("full", (uu, up, pu, None))
    velocity = op("uu", (uu, None, None, None))
    pinned = op("full", (uu1, up1, pu1, None), pinned=True)
    fns = {
        "full": loop(full),
        "uu": loop(lambda x: torch.cat([velocity(x[:n3]), x[n3:]])),
        "stream": stream_loop,
        "compute": loop(pinned),
    }
    ms, gb_s, first_s, device_ms, kernel_ms = {}, {}, {}, {}, {}
    for name in VARIANTS:
        if only is not None and name not in only:
            continue
        sec, first = difference_quotient(fns[name], n1, n2, device)
        ms[name] = sec * 1e3
        gb_s[name] = nbytes / sec / 1e9
        first_s[name] = first
        device_ms[name], kernel_ms[name] = device_times(fns[name], n2, device, KERNEL[name])
        dev = ("device not measured" if kernel_ms[name] is None else
               f"device {device_ms[name]:.4f} ms, kernel {kernel_ms[name]:.4f} ms = "
               f"{nbytes / kernel_ms[name] / 1e6:.1f} GB/s")
        log(f"  {name:10s} {ms[name]:9.4f} ms/app  {gb_s[name]:8.1f} GB/s of K1's bytes; "
            f"{dev}  (first call {first:.2f} s)")
    for name, why in NOT_APPLICABLE.items():
        log(f"  {name:10s} {why}")
    return {"device": device_name(device), "n_dof": fe.n_inv, "n_cells": fe.mesh.n_cells,
            "bytes": nbytes, "floor_ms": floor_ms, "ms": ms, "gb_s": gb_s,
            "device_ms": device_ms, "kernel_ms": kernel_ms, "first_s": first_s,
            "not_applicable": dict(NOT_APPLICABLE)}


def main(argv=None):
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    h = float(argv[0]) if len(argv) > 0 else 0.05
    nz = int(argv[1]) if len(argv) > 1 else 8
    only = os.environ.get("PROF_ONLY")
    res = run(h, nz, only=set(only.split(",")) if only else None)
    print("\nsummary (ms/application):")
    for k, v in res["ms"].items():
        print(f"  {k:10s} {v:8.4f}")


if __name__ == "__main__":
    main()
