"""K1/K2 at the model's shapes, and the model's step rate, on one card.

For every element-matvec kernel case the model runs (the P2-P1
inversion operator in modes "full" and "up", the P2 velocity block and
viscous smoother in "uu", the P1-P1 coarse saddle in "full_pp" and its
viscous smoother in "uu", the buoyancy evolution matrix and the P1
pressure mass in K2) it measures, in f32, the kernel and one CSR
product ``torch.sparse.mm`` on the same operator assembled here (the
library yardstick, never used by the port):

  ms          wrapper time per call: CUDA events around 20 calls in a
              row, the median of 10 such batches (host cost included
              where it outlasts the device work)
  device_ms   device time per call: the busy time of a torch.profiler
              trace of 20 calls (every kernel, copy and fill the call
              runs on the card)
  host_us     host time per call: time.perf_counter around 1,000 calls,
              read before the synchronise
  bound_ms    the larger of the bytes (each input read once, each output
              written once) over 3.35 TB/s and the multiply-adds over
              67 TFLOP/s (H100 SXM f32 without tensor cores)

the slice's split of K1 "full" into streaming (K3) and the rest
(pinned K1) from ``tools/profile_matvec``, the slice's steps per second
(three windows of 10 BDF2 steps after set_b + invert) with its
device-busy share (5 steps under the profiler), and the production
configuration's seconds per step (h = 0.04, three steps).

The same file measures an older tree of the repository, so that two
versions can be compared in one call on one card, in turns:

    python nupgcm_tpu_torch/tools/kernel_bench.py --root out/parent --out a.json
    python nupgcm_tpu_torch/tools/kernel_bench.py --root . --out b.json

It imports ``nupgcm_tpu_torch`` from ``--root`` and drives a tree
without prepared launches through its module-level wrappers
(``saddle_matvec`` / ``scalar_matvec``), which is how those trees'
operators ran.  ``chip_smoke.py`` uses ``kernel_cases``, ``measure``
and ``operator_csr`` from here.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
USED = {"full": ("uu", "up", "pu"), "full_pp": ("uu", "up", "pu", "pp"),
        "uu": ("uu",), "up": ("up",)}


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def kernel_cases(model, Kv_e=None):
    """Every kernel case of the model's step, as dicts: entry
    ("saddle_matvec" / "scalar_matvec"), mode (None for K2), label,
    blocks (uu, up, pu, pp or (ae,)), cd tables, the block-table key of
    ``model.const`` (None where the tree has none), n_x, n_nodes, n_p.
    ``Kv_e`` replaces the static vertical diffusion in the evolution
    matrix."""
    c, o, sp = model.const, model.ops, model.fe.spaces
    nu, nv = sp.u_space.ndof, sp.p_space.ndof
    theta = 2.0 / 3.0 * float(model.ts.dt) * model.params.a2e2 / model.params.mu_rho
    evo = o["M_e"] + theta * (o["Kh_e"] + (o["Kv_e"] if Kv_e is None else Kv_e))
    tables = "blk_fine" in c

    def saddle(mode, label, blocks, cd_u, cd_p, key, n_nodes, n_p):
        n_x = {"full": 3 * n_nodes + n_p, "full_pp": 3 * n_nodes + n_p,
               "uu": 3 * n_nodes, "up": n_p}[mode]
        return dict(entry="saddle_matvec", mode=mode, label=label, blocks=blocks,
                    cd=(cd_u, cd_p), key=key if tables else None, n_x=n_x,
                    n_nodes=n_nodes, n_p=n_p if mode != "uu" else 0)

    def scalar(label, ae, cd, key, n):
        return dict(entry="scalar_matvec", mode=None, label=label, blocks=(ae,), cd=(cd,),
                    key=key if tables else None, n_x=n, n_nodes=None, n_p=0)

    cases = [
        saddle("full", "P2-P1 inversion operator", (o["A_uu_e"], o["A_up_e"], o["A_pu_e"], None),
               c["cd_u"], c["cd_p"], "blk_fine", nu, sp.n_p),
        saddle("up", "P2-P1 pressure coupling", (None, o["A_up_e"], None, None),
               c["cd_u"], c["cd_p"], "blk_fine", nu, sp.n_p),
        saddle("uu", "P2 velocity block", (o["A_uu_e"], None, None, None),
               c["cd_u"], c["cd_none"], "blk_fine", nu, 0),
        saddle("uu", "P2 viscous smoother", (o["visc_e"], None, None, None),
               c["cd_u"], c["cd_none"], "blk_fine", nu, 0),
    ]
    if "sc_uu" in o:
        cases += [
            saddle("full_pp", "P1-P1 stabilized coarse saddle",
                   (o["sc_uu"], o["sc_up"], o["sc_pu"], o["sc_pp"]), c["cd_p"], c["cd_p"],
                   "blk_coarse", nv, nv),
            saddle("up", "P1-P1 coarse pressure coupling", (None, o["sc_up"], None, None),
                   c["cd_p"], c["cd_p"], "blk_coarse", nv, nv),
            saddle("uu", "P1 coarse velocity block", (o["sc_uu"], None, None, None),
                   c["cd_p"], c["cd_none"], "blk_coarse", nv, 0),
            saddle("uu", "P1 coarse viscous smoother", (o["sc_visc_e"], None, None, None),
                   c["cd_p"], c["cd_none"], "blk_coarse", nv, 0),
        ]
    cases += [
        scalar(f"P{sp.b_order} buoyancy evolution matrix", evo, c["cd_b"], "blk_b", sp.n_b),
        scalar("P1 pressure mass", o["Mp_e"], c["cd_p"], "blk_p", sp.n_p),
    ]
    return cases


def case_fns(model, K, case, dtype):
    """(kernel fn, plain fn, x) of a case in ``dtype``: the tree's own
    launch path (a prepared launch over the model's block tables for
    the mode, or over ``case["tables"]`` where given, in a tree that has
    them; else its module-level wrapper)."""
    conv = lambda t: None if t is None else t.to(dtype).contiguous()
    blocks = tuple(conv(t) for t in case["blocks"])
    cd = case["cd"]
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(case["n_x"]), dtype=dtype,
                        device=model.device)
    if case["mode"] is None:
        plain = lambda: K.scalar_matvec_plain(blocks[0], cd[0], x)
        if case["key"] is None:
            return (lambda: K.scalar_matvec(blocks[0], cd[0], x)), plain, x
        table = case.get("tables") or model.const[case["key"]]
        launch = K.scalar_launch(blocks[0], table, case["n_x"])
        return (lambda: launch(x)), plain, x
    mode, n = case["mode"], case["n_nodes"]
    plain = lambda: K.saddle_matvec_plain(*blocks, *cd, x, mode, n)
    if case["key"] is None:
        return (lambda: K.saddle_matvec(*blocks, *cd, x, mode, n)), plain, x
    tables = case.get("tables") or model.const[case["key"]][mode]
    launch = K.saddle_launch(*blocks, tables, mode, n, case["n_p"])
    return (lambda: launch(x)), plain, x


def operator_csr(case, blocks, n_x):
    """The operator of a kernel case assembled to CSR (COO triples
    summed): the library yardstick's input."""
    mode = case["mode"]
    if mode is None:  # scalar
        ae, (cd,) = blocks[0], case["cd"]
        cdl = cd.long()
        nl = cd.shape[1]
        rows = cdl[:, :, None].expand(-1, nl, nl)
        cols = cdl[:, None, :].expand(-1, nl, nl)
        idx, vals, shape = [(rows, cols)], [ae], (n_x, n_x)
    else:
        uu, up, pu, pp = blocks
        cd_u, cd_p = case["cd"]
        n3 = 3 * case["n_nodes"]
        gu = (3 * cd_u.long()[:, :, None] + torch.arange(3, device=cd_u.device)).flatten(1)
        gp = cd_p.long() + (0 if mode == "up" else n3)
        parts = {"uu": (uu, gu, gu), "up": (up, gu, gp), "pu": (pu, gp, gu),
                 "pp": (pp, gp, gp)}
        idx, vals = [], []
        for k in USED[mode]:
            a, r, cc = parts[k]
            idx.append((r[:, :, None].expand(a.shape), cc[:, None, :].expand(a.shape)))
            vals.append(a)
        shape = (n3 if mode == "up" else n_x, n_x)
    ind = torch.stack([torch.cat([r.reshape(-1) for r, _ in idx]),
                       torch.cat([cc.reshape(-1) for _, cc in idx])])
    with warnings.catch_warnings():  # CSR support is marked beta
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(ind, torch.cat([v.reshape(-1) for v in vals]), shape)
        return coo.coalesce().to_sparse_csr()


def median_ms(fn, reps=10, batch=20, warmup=5):
    """ms per call: CUDA events around ``batch`` calls in a row, the
    median over ``reps`` batches."""
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        for _ in range(batch):
            fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events])) / batch


def host_us(fn, n=1000):
    """Host µs per call: ``n`` calls timed before the synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def device_ms(fn, n=20, tries=3):
    """Device busy ms per call over a profiler trace of ``n`` calls
    (retried when a trace holds no device work, which the profiler
    sometimes returns); None if no try saw any."""
    from nupgcm_tpu_torch.tools._common import device_times

    for _ in range(tries):
        busy, _ = device_times(lambda k: [fn() for _ in range(k)], n, "cuda", "")
        if busy is not None:
            return busy
    return None


def measure_case(model, K, case, log=print, tag="kernels"):
    """f32 times of one case's kernel and of its CSR yardstick, in turns
    (kernel, library, library, kernel); the bound; the plain time."""
    kfn, pfn, x = case_fns(model, K, case, torch.float32)
    blocks = tuple(None if t is None else t.float() for t in case["blocks"])
    csr = operator_csr(case, blocks, case["n_x"])
    lib = lambda: torch.sparse.mm(csr, x[:, None])
    y0 = pfn()
    scale = float(y0.abs().max())
    err = float((kfn() - y0).abs().max())
    lib_err = float((lib()[:, 0] - y0).abs().max())
    turns = [median_ms(f) for f in (kfn, lib, lib, kfn)]
    dev = [device_ms(f) for f in (kfn, lib, lib, kfn)]
    hus = [host_us(f) for f in (kfn, lib, lib, kfn)]
    def mean(v, i, j):  # of the two turns that measured something
        got = [t for t in (v[i], v[j]) if t is not None]
        return sum(got) / len(got) if got else None

    floats = [t for t in blocks if t is not None]
    ints = list(case["cd"])
    out_len = 3 * case["n_nodes"] if case["mode"] == "up" else case["n_x"]
    b_ms, b_by = bound(nbytes(*floats, *ints, x) + 4 * out_len,
                       2 * sum(t.numel() for t in floats))
    rec = dict(entry=case["entry"], mode=case["mode"], label=case["label"],
               shape=list(floats[0].shape[1:]), nc=int(floats[0].shape[0]),
               max_abs_err=err, rel_err=err / scale,
               lib_rel_err=lib_err / scale, ms=mean(turns, 0, 3), library_ms=mean(turns, 1, 2),
               device_ms=mean(dev, 0, 3), library_device_ms=mean(dev, 1, 2),
               host_us=mean(hus, 0, 3), library_host_us=mean(hus, 1, 2),
               plain_ms=median_ms(pfn), bound_ms=b_ms, bound_by=b_by,
               nnz=int(csr.values().numel()))
    name = rec["entry"] + ("" if rec["mode"] is None else f"[{rec['mode']}]")
    fmt = lambda v: "n/m" if v is None else f"{v:.4f}"
    log(f"[{tag}] {name:24s} {rec['label']:34s} f32: kernel {fmt(rec['ms'])} ms "
        f"(device {fmt(rec['device_ms'])}, host {rec['host_us']:.1f} us), CSR "
        f"{fmt(rec['library_ms'])} ms (device {fmt(rec['library_device_ms'])}, host "
        f"{rec['library_host_us']:.1f} us), plain {rec['plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); err {rec['rel_err']:.1e} max|y|")
    del csr
    return rec


def measure(model, K, Kv_e=None, log=print, tag="kernels"):
    return [measure_case(model, K, case, log, tag) for case in kernel_cases(model, Kv_e)]


def step_rate(model, state, n=10):
    """(steps/s over ``n`` steps, state)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = model.step(state)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), state


def busy_share(model, state, n=5):
    """Device-busy share of ``n`` profiled steps, and their wall time."""
    import tempfile

    from nupgcm_tpu_torch.utils.timing import device_trace, trace_summary

    with tempfile.TemporaryDirectory() as d:
        with device_trace(d) as path:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = model.step(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        summ = trace_summary(path)
    return summ["busy_us"] / 1e6 / wall, wall, state


STEPS_8B = 3


def run(what=("slice", "8b"), log=print) -> dict:
    from nupgcm_tpu_torch import generators
    from nupgcm_tpu_torch.ops import kernels as K
    from nupgcm_tpu_torch.tools._common import card_name_limit, initial_b, mixing_setup

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench measures a CUDA device and "
                           "torch.cuda.is_available() is False")
    out = {"card": card_name_limit(), "prepared": hasattr(K, "saddle_launch")}
    if "slice" in what:
        model = mixing_setup(generators.bowl3D(0.08, 0.5, nz=9), "cuda", torch.float32)
        out["slice_cases"] = measure(model, K, log=log, tag="slice")
        from nupgcm_tpu_torch.tools import profile_matvec

        pm = profile_matvec.run(model=model, log=log)
        out["slice_split_kernel_ms"] = pm["kernel_ms"]
        state = model.invert(model.set_b(model.rest_state(), initial_b))
        rates = []
        for _ in range(3):
            r, state = step_rate(model, state)
            rates.append(r)
        share, wall, state = busy_share(model, state)
        out.update(slice_steps_per_s=rates, slice_busy_share=share, slice_profiled_wall_s=wall)
        log(f"[slice] steps/s over 3 windows of 10 steps {[round(r, 3) for r in rates]}; "
            f"device busy {100 * share:.1f}% of 5 profiled steps ({out['card']})")
        del model, state
        torch.cuda.empty_cache()
    if "8b" in what:
        from nupgcm_tpu_torch.fem import assembly as asm
        from nupgcm_tpu_torch.tools import production

        model, _, _ = production.build_model(0.04, device="cuda", dtype=torch.float32)
        state = model.rest_state()
        c = model.const
        kv_q = model.forcings.conv_param.kappa_v(c["kv_q"], model._abz(state.b))
        Kv_e = asm.elem_stiffness(c["wq"], kv_q, c["Gb3"], (2,))
        out["8b_cases"] = measure(model, K, Kv_e=Kv_e, log=log, tag="8b")
        del Kv_e, kv_q
        secs = []
        for _ in range(STEPS_8B):
            r, state = step_rate(model, state, 1)
            secs.append(1.0 / r)
        out["8b_s_per_step"] = secs
        log(f"[8b] s per step {[round(s, 3) for s in secs]} ({out['card']})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="tree whose nupgcm_tpu_torch is measured")
    ap.add_argument("--out", default=None, help="JSON file for the results")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    res = run(log=lambda *a: print(*a, flush=True))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    mid = {k: statistics.median(v) for k, v in res.items()
           if k in ("slice_steps_per_s", "8b_s_per_step")}
    print(json.dumps({"card": res["card"], **mid}), flush=True)


if __name__ == "__main__":
    main()
