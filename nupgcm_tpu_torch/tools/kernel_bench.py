"""K1/K2 and the assembled block kernel at the model's shapes, and the
model's step rate, on one card.

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
              runs on the card), kept only if the trace holds every
              call's device events (counted from traces of one and two
              calls), else not measured (None)
  graph_ms    device time per call without the profiler: CUDA events
              around a CUDA-graph replay of 20 calls, read wherever the
              tree has prepared launches; it also counts the replay's
              gaps between kernels, so it reads at or above device_ms
  host_us     host time per call: time.perf_counter around 1,000 calls,
              read before the synchronise
  bound_ms    the larger of the bytes (each input read once, each output
              written once) over 3.35 TB/s and the multiply-adds over
              67 TFLOP/s (H100 SXM f32 without tensor cores); the CSR
              call's own bound (library_bound_ms) counts its matrix's
              values and indices in place of the element tensors

The model applies some operators through the assembled block kernel
(``ops/assembled.py``, ``csrc/vertex_block_matvec.cu``): the iterative
coarse level's P1-P1 saddle ("full_pp") and pressure coupling ("up"),
the P1 vector velocity blocks of the coarse level ("uu": its velocity
block and viscous smoother, or the two-grid's element coarse level) and
the P2-P1 pressure coupling ("up" on P2 nodes x vertices).
``kernel_cases`` keeps their K1 cases (the DD path's, and the single
device's before the redesign), over K1 tables built here, since the
model holds none for them.  ``assembled_cases`` times each assembled
case beside K1 on the same operator's element tensors and beside the
CSR call, in turns (new, K1, CSR, CSR, K1, new), every reading with a
cold L2: at the 0.87M-DoF bowl the f32 blocks (36.5 MB) fit in the H100's 50 MB L2,
where back-to-back calls would read them at L2 speed, below the HBM
bound, while in the step the L2 is cold (the aggregate level's inverse,
580 MB, and the fine operators pass through it between two coarse
applications).  Each of the three functions runs over copies of its
inputs (``rotating``) taken in turn, enough copies that at least
EVICT_BYTES pass through the L2 between two uses of one copy; the
CUDA-graph replay covers whole turns.

It also reads the slice's split of K1 "full" into streaming (K3) and the rest
(pinned K1) from ``tools/profile_matvec``, the slice's steps per second
(three windows of 10 BDF2 steps after set_b + invert) with its
device-busy share (5 steps under the profiler, from a trace that lost
no device event of the steps), and the production
configuration's seconds per step (h = 0.04, three steps).

The same file measures an older tree of the repository, so that two
versions can be compared in one call on one card, in turns:

    python nupgcm_tpu_torch/tools/kernel_bench.py --root out/parent --out a.json
    python nupgcm_tpu_torch/tools/kernel_bench.py --root . --out b.json

It imports ``nupgcm_tpu_torch`` from ``--root`` and drives a tree
without prepared launches through its module-level wrappers
(``saddle_matvec`` / ``scalar_matvec``), which is how those trees'
operators ran (an older tree has no assembled cases).  ``chip_smoke.py``
uses ``kernel_cases``, ``assembled_cases``, ``measure_case``,
``measure_assembled`` and ``operator_csr`` from here.  Needs a CUDA
device.
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
L2_BYTES = 50 * 2**20      # H100 L2
EVICT_BYTES = 5 * L2_BYTES  # streamed between two uses of one copy (rotating)
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
    """Every K1/K2 case of the model's step, and of its operators that the
    model applies from assembled blocks (their K1 cases), as dicts: entry
    ("saddle_matvec" / "scalar_matvec"), mode (None for K2), label,
    blocks (uu, up, pu, pp or (ae,)), cd tables, the block-table key of
    ``model.const`` (None where the tree has none, or where "tables"
    holds the case's own K1 tables), n_x, n_nodes, n_p.  ``Kv_e``
    replaces the static vertical diffusion in the evolution matrix."""
    c, o, sp = model.const, model.ops, model.fe.spaces
    nu, nv = sp.u_space.ndof, sp.p_space.ndof
    theta = 2.0 / 3.0 * float(model.ts.dt) * model.params.a2e2 / model.params.mu_rho
    evo = o["M_e"] + theta * (o["Kh_e"] + (o["Kv_e"] if Kv_e is None else Kv_e))
    has_tables = "blk_fine" in c

    def saddle(mode, label, blocks, cd_u, cd_p, key, n_nodes, n_p, **kw):
        n_x = {"full": 3 * n_nodes + n_p, "full_pp": 3 * n_nodes + n_p,
               "uu": 3 * n_nodes, "up": n_p}[mode]
        return dict(entry="saddle_matvec", mode=mode, label=label, blocks=blocks,
                    cd=(cd_u, cd_p), key=key if has_tables else None, n_x=n_x,
                    n_nodes=n_nodes, n_p=n_p if mode != "uu" else 0, **kw)

    def scalar(label, ae, cd, key, n):
        return dict(entry="scalar_matvec", mode=None, label=label, blocks=(ae,), cd=(cd,),
                    key=key if has_tables else None, n_x=n, n_nodes=None, n_p=0)

    def k1(modes, fine=False):
        """K1 tables the model does not hold (it applies these operators
        from assembled blocks): DD's path, and the single device's before
        the assembled layout."""
        got = kernel_tables(model, modes, fine) if has_tables else {}
        return {m: got.get(m) for m in modes}

    cases = [
        saddle("full", "P2-P1 inversion operator", (o["A_uu_e"], o["A_up_e"], o["A_pu_e"], None),
               c["cd_u"], c["cd_p"], "blk_fine", nu, sp.n_p),
        saddle("up", "P2-P1 pressure coupling", (None, o["A_up_e"], None, None),
               c["cd_u"], c["cd_p"], None, nu, sp.n_p, tables=k1(("up",), fine=True)["up"]),
        saddle("uu", "P2 velocity block", (o["A_uu_e"], None, None, None),
               c["cd_u"], c["cd_none"], "blk_fine", nu, 0),
        saddle("uu", "P2 viscous smoother", (o["visc_e"], None, None, None),
               c["cd_u"], c["cd_none"], "blk_fine", nu, 0),
    ]
    if "sc_uu" in o:
        t = k1(("full_pp", "up", "uu"))
        cases += [
            saddle("full_pp", "P1-P1 stabilized coarse saddle",
                   (o["sc_uu"], o["sc_up"], o["sc_pu"], o["sc_pp"]), c["cd_p"], c["cd_p"],
                   None, nv, nv, tables=t["full_pp"]),
            saddle("up", "P1-P1 coarse pressure coupling", (None, o["sc_up"], None, None),
                   c["cd_p"], c["cd_p"], None, nv, nv, tables=t["up"]),
            saddle("uu", "P1 coarse velocity block", (o["sc_uu"], None, None, None),
                   c["cd_p"], c["cd_none"], None, nv, 0, tables=t["uu"]),
            saddle("uu", "P1 coarse viscous smoother", (o["sc_visc_e"], None, None, None),
                   c["cd_p"], c["cd_none"], None, nv, 0, tables=t["uu"]),
        ]
    if "coarse_e" in o:  # the u-block two-grid's element coarse level
        cases.append(saddle("uu", "P1 vector two-grid coarse block",
                            (o["coarse_e"], None, None, None), c["cd_p"], c["cd_none"],
                            None, nv, 0, tables=k1(("uu",))["uu"]))
    cases += [
        scalar(f"P{sp.b_order} buoyancy evolution matrix", evo, c["cd_b"], "blk_b", sp.n_b),
        scalar("P1 pressure mass", o["Mp_e"], c["cd_p"], "blk_p", sp.n_p),
    ]
    return cases


def kernel_tables(model, modes, fine=False):
    """K1's block tables in ``modes`` over the P2-P1 dof tables (``fine``)
    or the P1-P1 ones, for the model's dtype and on its device."""
    from nupgcm_tpu_torch.ops import blocks

    fe = model.fe
    item = torch.empty((), dtype=model.dtype).element_size()
    return blocks.operator_tables(fe.cd_u if fine else fe.cd_p, fe.cd_p, modes, item,
                                  model.device)


def assembled_cases(model):
    """The assembled block cases of the model's step, as
    ``kernel_cases``' dicts with entry "vblock_matvec", a name, the
    pattern, the pattern's dof tables and node counts ("pcd": cd_r,
    n_rows, cd_c, n_cols), the element tensors the values are filled
    from ("fill": the coarse saddle's four, or one), in "blocks" the K1
    case's element tensors (the time before the redesign, and the CSR
    yardstick's operator) and "fine" where K1 ran it over the P2-P1
    tables.  Empty where the model (or the tree) applies none."""
    c, o, sp = model.const, model.ops, model.fe.spaces
    held = getattr(model, "_held", {})  # an older tree holds the coarse saddle alone
    nu, nv = sp.u_space.ndof, sp.p_space.ndof

    def case(name, mode, label, pattern, pcd, fill, blocks, cd, n_nodes, n_p, fine=False):
        return dict(entry="vblock_matvec", name=name, mode=mode, label=label, pattern=pattern,
                    pcd=pcd, fill=fill, blocks=blocks, cd=cd, fine=fine,
                    n_x={"full_pp": 4 * n_nodes, "uu": 3 * n_nodes, "up": n_p}[mode],
                    n_nodes=n_nodes, n_p=n_p)

    cases = []
    p1 = (c["cd_p"], nv, c["cd_p"], nv)
    if "vblk_coarse" in c and "sc_uu" in o:
        sc = tuple(o[k] for k in ("sc_uu", "sc_up", "sc_pu", "sc_pp"))
        cases += [case("vblock_matvec[full_pp]", "full_pp", "P1-P1 coarse saddle, assembled",
                       c["vblk_coarse"], p1, sc, sc, (c["cd_p"], c["cd_p"]), nv, nv),
                  case("vblock_matvec[up]", "up", "P1-P1 coarse pressure coupling, assembled",
                       c["vblk_coarse"], p1, sc, (None, sc[1], None, None),
                       (c["cd_p"], c["cd_p"]), nv, nv)]
    for key, label in (("sc_uu", "P1 coarse velocity block, assembled"),
                       ("sc_visc_e", "P1 coarse viscous smoother, assembled"),
                       ("coarse_e", "P1 vector two-grid coarse block, assembled")):
        if key in held:
            cases.append(case("vblock_matvec[uu]", "uu", label, c["vblk_coarse"], p1, (o[key],),
                              (o[key], None, None, None), (c["cd_p"], c["cd_none"]), nv, 0))
    if "A_up_e" in held:
        cases.append(case("vblock_matvec[up P2-P1]", "up", "P2-P1 pressure coupling, assembled",
                          c["vblk_up"], (c["cd_u"], nu, c["cd_p"], sp.n_p), (o["A_up_e"],),
                          (None, o["A_up_e"], None, None), (c["cd_u"], c["cd_p"]), nu, sp.n_p,
                          fine=True))
    return cases


def vblock_values(case, dtype):
    """(values, pattern) of an assembled case in ``dtype``, filled from its
    element tensors: the coarse saddle's blocks ("full_pp") or their
    pressure-gradient columns ("up"), or the one operator's values.
    ``case["perm"]``, where given, reorders the cells first (and the
    pattern is rebuilt from the reordered dof tables)."""
    from nupgcm_tpu_torch.ops import assembled as A

    pat, fill = case["pattern"], [t.to(dtype).contiguous() for t in case["fill"]]
    cd_r, n_r, cd_c, n_c = case["pcd"]
    perm = case.get("perm")
    if perm is not None:
        fill = [t[perm] for t in fill]
        cd_r, cd_c = cd_r[perm], cd_c[perm]
        pat = A.vertex_pattern(cd_r, n_r, cd_c, n_c)
    if len(fill) == 4:
        op = A.AssembledSaddle(pat, cd_r, dtype).fill(*fill)
        return (op.vals if case["mode"] == "full_pp" else op.up_vals), pat
    return A.AssembledBlocks(pat, case["mode"], dtype, cd_r).fill(fill[0]).vals, pat


def vblock_shape(pat):
    """The launch arguments after the mode that a pattern gives: its local
    sizes and column count (none in an older tree, whose launches take
    square patterns alone)."""
    return (pat.sizes, pat.n_cols) if hasattr(pat, "sizes") else ()


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
    if case["entry"] == "vblock_matvec":
        vals, pat = vblock_values(case, dtype)
        mode = case["mode"]
        launch = K.VBlockLaunch(vals, pat.col, pat.row_ptr, mode, *vblock_shape(pat))
        return ((lambda: launch(x)),
                (lambda: K.vblock_matvec_plain(vals, pat.col, pat.row, x, mode, pat.n_rows)), x)
    if case["mode"] is None:
        plain = lambda: K.scalar_matvec_plain(blocks[0], cd[0], x)
        if case["key"] is None:
            return (lambda: K.scalar_matvec(blocks[0], cd[0], x)), plain, x
        table = case.get("tables") or model.const[case["key"]]
        launch = K.scalar_launch(blocks[0], table, case["n_x"])
        return (lambda: launch(x)), plain, x
    mode, n = case["mode"], case["n_nodes"]
    plain = lambda: K.saddle_matvec_plain(*blocks, *cd, x, mode, n)
    tables = case.get("tables")
    if tables is None and case["key"] is None:
        return (lambda: K.saddle_matvec(*blocks, *cd, x, mode, n)), plain, x
    tables = tables or model.const[case["key"]][mode]
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


PAD_LAUNCHES = 64  # spin kernels that open a profiler trace (_pad)


def _pad():
    """PAD_LAUNCHES spin kernels, then a synchronise: they open a trace,
    so that the device events a session loses from its start are theirs."""
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _without_pad(summ):
    """(device busy us, device events) of a trace summary, the pad's
    spin kernels left out."""
    pad = [v for name, v in summ["by_name"].items() if "spin_kernel" in name]
    return (summ["busy_us"] - sum(us for _, us in pad),
            sum(c for c, _ in summ["by_name"].values()) - sum(c for c, _ in pad))


def _trace(fn, k):
    """(device busy us, device events) of a profiler trace of ``k`` calls,
    opened by the pad (left out of both); (0, 0) when any launch of the
    calls lost its device event (``utils.timing.lost_events``): such a
    trace holds no whole call."""
    import tempfile

    from nupgcm_tpu_torch.utils.timing import device_trace, lost_events, trace_summary

    with tempfile.TemporaryDirectory() as d:
        with device_trace(d) as path:
            _pad()
            for _ in range(k):
                fn()
        if any(i >= PAD_LAUNCHES for i in lost_events(path)["lost"]):
            return 0.0, 0
        return _without_pad(trace_summary(path))


DEVICE_READS = 3   # complete traces whose median device_ms reads
SPREAD_BAR = 1.15  # one device_ms's readings further apart than this go to SPREADS
SPREADS = []       # (median, readings) of each such device_ms, for the record


def device_ms(fn, n=20, tries=5, reads=DEVICE_READS):
    """Device busy ms per call: the median over ``reads`` profiler traces
    of ``n`` calls.  A trace that missed calls would read too little
    busy time, so a trace is kept only if every launch of its calls
    found its device event (``_trace``) and it holds the events that
    traces of one and two calls (E1, E2: the most of ``tries`` each) say
    ``n`` calls make, E1 + (n - 1)(E2 - E1); E1 may hold events a trace
    makes once, whatever its length.  Tracing stops at ``reads`` kept
    traces or ``tries`` refused ones; None if none was kept (the median
    of the kept ones otherwise).  Late in a long process a profiler
    session loses device events from the start of its window (a few, or
    all of them) in some sessions and not in others: the pad takes
    those losses.  Traces that held every call can still read far too
    little (on an NVIDIA H100: the vertex-block kernel 27% under its
    CUDA-graph replay, K1 14% under the time its bytes need): the median
    leaves out one such trace of three, and readings that spread beyond
    SPREAD_BAR are kept in SPREADS."""
    e1, e2 = (max(_trace(fn, k)[1] for _ in range(tries)) for k in (1, 2))
    if e2 <= e1:
        return None
    got, refused = [], 0
    while len(got) < reads and refused < tries:
        busy, events = _trace(fn, n)
        if events >= e1 + (n - 1) * (e2 - e1):
            got.append(busy / n / 1e3)
        else:
            refused += 1
    if not got:
        return None
    if max(got) > SPREAD_BAR * min(got):
        SPREADS.append((statistics.median(got), got))
    return statistics.median(got)


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
    # an older tree's one-off wrappers build tables on the host per call,
    # which a graph capture refuses: only prepared launches are replayed
    g_ms = graph_ms(kfn) if hasattr(K, "saddle_launch") else None
    hus = [host_us(f) for f in (kfn, lib, lib, kfn)]
    def mean(v, i, j):  # of the two turns that measured something
        got = [t for t in (v[i], v[j]) if t is not None]
        return sum(got) / len(got) if got else None

    floats = [t for t in blocks if t is not None]
    ints = list(case["cd"])
    out_len = 3 * case["n_nodes"] if case["mode"] == "up" else case["n_x"]
    b_ms, b_by = bound(nbytes(*floats, *ints, x) + 4 * out_len,
                       2 * sum(t.numel() for t in floats))
    # the CSR product reads the assembled matrix, not the element tensors:
    # its own bound (a P1 operator's matrix is a third of its elements' bytes)
    lib_b_ms, _ = bound(nbytes(csr.values(), csr.col_indices(), csr.crow_indices(), x)
                        + 4 * out_len, 2 * csr.values().numel())
    rec = dict(entry=case["entry"], mode=case["mode"], label=case["label"],
               shape=list(floats[0].shape[1:]), nc=int(floats[0].shape[0]),
               max_abs_err=err, rel_err=err / scale,
               lib_rel_err=lib_err / scale, ms=mean(turns, 0, 3), library_ms=mean(turns, 1, 2),
               device_ms=mean(dev, 0, 3), graph_ms=g_ms, library_device_ms=mean(dev, 1, 2),
               host_us=mean(hus, 0, 3), library_host_us=mean(hus, 1, 2),
               plain_ms=median_ms(pfn), bound_ms=b_ms, bound_by=b_by,
               library_bound_ms=lib_b_ms, nnz=int(csr.values().numel()))
    name = rec["entry"] + ("" if rec["mode"] is None else f"[{rec['mode']}]")
    fmt = lambda v: "n/m" if v is None else f"{v:.4f}"
    log(f"[{tag}] {name:24s} {rec['label']:34s} f32: kernel {fmt(rec['ms'])} ms "
        f"(device {fmt(rec['device_ms'])}, graph replay {fmt(g_ms)}, host "
        f"{rec['host_us']:.1f} us), CSR "
        f"{fmt(rec['library_ms'])} ms (device {fmt(rec['library_device_ms'])}, host "
        f"{rec['library_host_us']:.1f} us; its bound {lib_b_ms:.4f} ms), plain "
        f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); err {rec['rel_err']:.1e} "
        f"max|y|")
    del csr
    return rec


def rotating(make, nbytes_one):
    """A function that calls, in turn, each of n functions ``make()``
    builds (each over its own copy of the inputs), with n such that at
    least EVICT_BYTES pass between two calls of one copy: every call
    finds its inputs out of the L2.  ``.copies`` is n."""
    n = max(1, -(-EVICT_BYTES // max(1, nbytes_one)))
    fns = [make() for _ in range(n)]
    turn = [0]

    def call():
        turn[0] += 1
        return fns[turn[0] % n]()

    call.copies = n
    return call


def measure_assembled(model, K, case, log=print, tag="kernels"):
    """f32 times of an assembled case: the block kernel, K1 on the
    same operator's element tensors and the CSR call, in turns (new, K1,
    CSR, CSR, K1, new), each over rotating copies of its inputs (a cold
    L2 on every call); the CUDA-graph replays of the new kernel and K1;
    the bounds; the plain time."""
    mode, n_nodes = case["mode"], case["n_nodes"]
    kfn, pfn, x = case_fns(model, K, case, torch.float32)
    vals, pat = vblock_values(case, torch.float32)
    blocks = tuple(None if t is None else t.float().contiguous() for t in case["blocks"])
    csr = operator_csr(case, blocks, case["n_x"])
    tables = kernel_tables(model, (mode,), case.get("fine", False))[mode]
    y0 = pfn()
    scale = float(y0.abs().max())
    err = float((kfn() - y0).abs().max())
    lib_err = float((torch.sparse.mm(csr, x[:, None])[:, 0] - y0).abs().max())
    new_bytes = nbytes(vals, pat.col, pat.row_ptr)

    def make_new():
        launch = K.VBlockLaunch(vals.clone(), pat.col.clone(), pat.row_ptr.clone(), mode,
                                *vblock_shape(pat))
        return lambda: launch(x)

    def make_k1():
        launch = K.saddle_launch(*(None if t is None else t.clone() for t in blocks), tables,
                                 mode, n_nodes, case["n_p"])
        return lambda: launch(x)

    def make_csr():
        m = torch.sparse_csr_tensor(csr.crow_indices().clone(), csr.col_indices().clone(),
                                    csr.values().clone(), csr.shape)
        return lambda: torch.sparse.mm(m, x[:, None])

    fns = (rotating(make_new, new_bytes), rotating(make_k1, nbytes(*blocks)),
           rotating(make_csr, nbytes(csr.values(), csr.col_indices(), csr.crow_indices())))
    order = (0, 1, 2, 2, 1, 0)
    turns = [median_ms(fns[i]) for i in order]
    dev = [device_ms(fns[i]) for i in order]
    hus = [host_us(fns[i]) for i in order]
    graph = lambda f: graph_ms(f, calls=f.copies * -(-20 // f.copies))
    g_ms = [graph(f) for f in fns[:2]]

    def mean(v, i):  # of the two turns of function i that measured something
        got = [v[t] for t, j in enumerate(order) if j == i and v[t] is not None]
        return sum(got) / len(got) if got else None

    out_len = pat.n_rows * (4 if mode == "full_pp" else 3)
    y_bytes = out_len * vals.element_size()
    b_ms, b_by = bound(new_bytes + nbytes(x) + y_bytes, 2 * vals.numel())
    k1_ms, _ = bound(nbytes(*blocks, *case["cd"], x) + y_bytes,
                     2 * sum(t.numel() for t in blocks if t is not None))
    lib_b_ms, _ = bound(nbytes(csr.values(), csr.col_indices(), csr.crow_indices(), x)
                        + y_bytes, 2 * csr.values().numel())
    rec = dict(entry=case["entry"], mode=mode, label=case["label"],
               shape={"full_pp": [4, 4], "up": [3, 1], "uu": [3, 3]}[mode], nc=pat.n_blocks,
               n_blocks=pat.n_blocks, max_abs_err=err, rel_err=err / scale,
               lib_rel_err=lib_err / scale, ms=mean(turns, 0), library_ms=mean(turns, 2),
               device_ms=mean(dev, 0), graph_ms=g_ms[0], library_device_ms=mean(dev, 2),
               host_us=mean(hus, 0), library_host_us=mean(hus, 2), plain_ms=median_ms(pfn),
               bound_ms=b_ms, bound_by=b_by, library_bound_ms=lib_b_ms,
               nnz=int(csr.values().numel()), k1_ms=mean(turns, 1), k1_device_ms=mean(dev, 1),
               k1_graph_ms=g_ms[1], k1_bound_ms=k1_ms, copies=[f.copies for f in fns],
               cold_l2=True)
    fmt = lambda v: "n/m" if v is None else f"{v:.4f}"
    log(f"[{tag}] {case.get('name', 'vblock_matvec')} {rec['label']:34s} f32, cold L2 (copies "
        f"{rec['copies']}): kernel {fmt(rec['ms'])} ms (device {fmt(rec['device_ms'])}, graph "
        f"replay {fmt(g_ms[0])}, host {rec['host_us']:.1f} us), K1 on the element tensors "
        f"{fmt(rec['k1_ms'])} ms (device {fmt(rec['k1_device_ms'])}, graph replay "
        f"{fmt(g_ms[1])}; its bound {k1_ms:.4f}), CSR {fmt(rec['library_ms'])} ms (device "
        f"{fmt(rec['library_device_ms'])}; its bound {lib_b_ms:.4f} ms), plain "
        f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {pat.n_blocks} blocks; err "
        f"{rec['rel_err']:.1e} max|y|")
    del csr, fns
    return rec


def measure(model, K, Kv_e=None, log=print, tag="kernels"):
    recs = [measure_case(model, K, case, log, tag) for case in kernel_cases(model, Kv_e)]
    return recs + [measure_assembled(model, K, case, log, tag) for case in assembled_cases(model)]


def step_rate(model, state, n=10):
    """(steps/s over ``n`` steps, state)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = model.step(state)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0), state


def graph_ms(fn, calls=20, reps=10):
    """Device ms per call that needs no profiler: CUDA events around a
    CUDA-graph replay of ``calls`` calls (no host gaps between them, but
    the replay's own gap between kernels), the median of ``reps``
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)




def busy_share(model, state, n=5, tries=5):
    """Device-busy share of ``n`` profiled steps from ``state``, their
    wall time, the state after them and, for each try, the launches of
    the steps and of the pad whose device events the trace lost
    (``utils.timing.lost_events``).  A session can lose the device
    events of its first launches (up to 23 seen on an H100, late in a
    long process), so each trace opens with PAD_LAUNCHES spin kernels,
    left out of the busy time; a trace counts only if every launch of
    the steps found its device event.  The same steps are traced again,
    up to ``tries`` times, and the share is None if every trace lost
    some."""
    import tempfile

    from nupgcm_tpu_torch.utils.timing import device_trace, lost_events, trace_summary

    lost = []
    for _ in range(tries):
        st = state
        with tempfile.TemporaryDirectory() as d:
            with device_trace(d) as path:
                _pad()
                t0 = time.perf_counter()
                for _ in range(n):
                    st, _ = model.step(st)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            pos = lost_events(path)["lost"]
            steps_lost = sum(1 for i in pos if i >= PAD_LAUNCHES)
            lost.append((steps_lost, len(pos) - steps_lost))
            summ = trace_summary(path)
        if not steps_lost:
            return _without_pad(summ)[0] / 1e6 / wall, wall, st, lost
    return None, wall, st, lost


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
        share, wall, state, lost = busy_share(model, state)
        out.update(slice_steps_per_s=rates, slice_busy_share=share, slice_profiled_wall_s=wall)
        busy = "not measured" if share is None else f"{100 * share:.1f}%"
        log(f"[slice] steps/s over 3 windows of 10 steps {[round(r, 3) for r in rates]}; "
            f"device busy {busy} of 5 profiled steps (launches lost per trace, of the steps "
            f"and of the pad: {lost}) "
            f"({out['card']})")
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
