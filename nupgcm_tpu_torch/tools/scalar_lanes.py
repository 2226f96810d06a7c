"""The lane count of the vertex-block kernel's "scalar" mode (the P1
pressure mass), measured: the kernel as built (``kScalarGroup`` lanes a
row) against a second build of the same sources with another count, on
one card, at the slice's, production h = 0.04's and the 0.87M-DoF
bowl's mass.

    python -m nupgcm_tpu_torch.tools.scalar_lanes [--other 8] [--out FILE]

The second library is compiled from a copy of ``csrc/`` under
``out/lanes<N>/`` (gitignored).  At each size both launches are held
against the plain version (2e-6 of max|y|, f32), then timed in turns
(built, other, other, built, built, other) with a cold L2 (rotating
copies of the values, as ``kernel_bench.measure_assembled``): CUDA
events around a CUDA-graph replay, and the profiler's device time.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil

import numpy as np
import torch

GROUP = re.compile(r"constexpr int kScalarGroup = (\d+);")


def other_library(lanes: int):
    """The kernel library built from a copy of the sources with
    ``lanes`` lanes a row in "scalar"."""
    from nupgcm_tpu_torch.ops import build

    root = pathlib.Path(build.__file__).resolve().parents[2] / "out" / f"lanes{lanes}"
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for src in build.SOURCES:
        text = src.read_text()
        if src.name == "vertex_block_matvec.cu":
            text, n = GROUP.subn(f"constexpr int kScalarGroup = {lanes};", text)
            assert n == 1, "kScalarGroup not found"
        (root / "csrc" / src.name).write_text(text)
    saved = build.SOURCES, build.BUILD_DIR, build._lib
    build.SOURCES, build.BUILD_DIR, build._lib = sorted((root / "csrc").glob("*.cu")), \
        root / "_build", None
    try:
        return build.load()
    finally:
        build.SOURCES, build.BUILD_DIR, build._lib = saved


def time_both(model, libs, log=print, tag=""):
    """Graph-replay and device ms of the model's mass with each library
    of ``libs`` ({lanes: library}), in turns; the bound."""
    from nupgcm_tpu_torch.ops import build
    from nupgcm_tpu_torch.ops import kernels as K
    from nupgcm_tpu_torch.tools import kernel_bench as kb

    case = next(c for c in kb.assembled_cases(model) if c["mode"] == "scalar")
    vals, pat = kb.vblock_values(case, torch.float32)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(case["n_x"]),
                        dtype=torch.float32, device=model.device)
    y0 = K.vblock_matvec_plain(vals, pat.col, pat.row, x, "scalar", pat.n_rows)
    saved, fns = build._lib, {}
    try:
        for lanes, lib in libs.items():
            build._lib = lib  # VBlockLaunch binds the library it finds loaded
            K._vb_prepared.clear()
            y = K.VBlockLaunch(vals, pat.col, pat.row_ptr, "scalar", pat.sizes)(x)
            err = float((y - y0).abs().max() / y0.abs().max())
            if err > 2e-6:
                raise RuntimeError(f"{tag} {lanes} lanes: {err:.2e} max|y| from plain")

            def make():
                launch = K.VBlockLaunch(vals.clone(), pat.col.clone(), pat.row_ptr.clone(),
                                        "scalar", pat.sizes)
                return lambda: launch(x)

            fns[lanes] = kb.rotating(make, kb.nbytes(vals, pat.col, pat.row_ptr))
    finally:
        build._lib = saved
        K._vb_prepared.clear()
    first, other = list(libs)
    rec = {"rows": pat.n_rows, "blocks": pat.n_blocks, "copies": fns[first].copies,
           **{f"graph_ms_{n}": [] for n in libs}, **{f"device_ms_{n}": [] for n in libs}}
    for lanes in (first, other, other, first, first, other):
        f = fns[lanes]
        rec[f"graph_ms_{lanes}"].append(kb.graph_ms(f, calls=f.copies * -(-20 // f.copies)))
        rec[f"device_ms_{lanes}"].append(kb.device_ms(f))
    rec["bound_ms"] = kb.bound(kb.nbytes(vals, pat.col, pat.row_ptr, x) + 4 * pat.n_rows,
                               2 * vals.numel())[0]
    log(f"[scalar_lanes] {tag}: {pat.n_rows} rows, {pat.n_blocks} blocks "
        f"({pat.n_blocks / pat.n_rows:.2f} a row), cold L2 ({rec['copies']} copies); "
        + "; ".join(f"{n} lanes: graph replay {rec[f'graph_ms_{n}']} ms, device "
                    f"{rec[f'device_ms_{n}']} ms" for n in libs)
        + f"; bound {rec['bound_ms']:.5f} ms")
    return rec


def run(other=8, log=print) -> dict:
    from nupgcm_tpu_torch import generators
    from nupgcm_tpu_torch.ops import build
    from nupgcm_tpu_torch.tools import measure_l2, production
    from nupgcm_tpu_torch.tools._common import card_name_limit, mixing_setup, require_cuda

    require_cuda()
    if other not in (2, 4, 8, 16, 32):
        raise ValueError(f"a row's lanes are a power of two up to a warp, not {other}")
    src = next(s for s in build.SOURCES if s.name == "vertex_block_matvec.cu").read_text()
    built = int(GROUP.search(src).group(1))
    if other == built:
        raise ValueError(f"the kernel is built with {built} lanes already")
    libs = {built: build.load(), other: other_library(other)}
    out = {"card": card_name_limit(), "built": built, "other": other}
    makers = {"slice": lambda: mixing_setup(generators.bowl3D(0.08, 0.5, nz=9)),
              "8b": lambda: production.build_model(0.04, device="cuda",
                                                   dtype=torch.float32)[0],
              "0.87M": lambda: measure_l2.build(0.033, 12, "cuda", torch.float32)[0]}
    for tag, make in makers.items():
        model = make()
        out[tag] = time_both(model, libs, log, tag)
        del model
        torch.cuda.empty_cache()
    log(f"[scalar_lanes] {out['card']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=int, default=8, help="the lane count built beside")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args(argv)
    res = run(args.other, log=lambda *a: print(*a, flush=True))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
