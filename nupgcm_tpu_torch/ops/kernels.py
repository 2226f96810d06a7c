"""CUDA kernels of the port: wrappers, plain versions, launch counts.

    y = sum_e P_e^T A_e P_e x

Every Krylov iteration of the model applies operators of this form.
Two entries cover them:

* ``saddle_matvec`` -- the saddle operator ``[uu up; pu pp]`` over the
  node-major velocity (dof = 3*node + comp) and the pressure, in four
  modes: "full" (pp = 0), "full_pp", "uu" (velocity block alone) and
  "up" (velocity rows from a pressure vector).  CUDA kernel
  ``saddle_kernel`` in ``csrc/element_matvec.cu``; it replaces
  ``nupgcm_tpu/ops/window.py::saddle_matvec``.
* ``scalar_matvec`` -- one scalar space, A (nc, nl, nl).  CUDA kernel
  ``scalar_kernel``; it replaces ``window.py::scalar_matvec``.

Three measurement probes (``csrc/stream_probe.cu`` and the pinned
instantiation of ``saddle_kernel``; see that file for their design)
run only in the tools of ``nupgcm_tpu_torch/tools``:

* ``stream_saddle`` (K3) -- streams the saddle operator's element
  tensors into a 128-lane carry; it replaces the Pallas kernel
  ``stream_once`` of ``tools/profile_matvec.py``.  Bound by HBM
  bandwidth (3.35 TB/s on an H100 SXM).
* ``stream_probe`` (K4) -- sums synthetic f32 parts per column; it
  replaces ``run.<locals>.once`` of ``tools/profile_stream.py``.  Bound
  by HBM bandwidth once its bytes exceed the 50 MB L2.
* ``saddle_matvec(..., pinned=True)`` -- mode "full" with every cell
  reading the tensors of cell ``c mod 128``: the "compute" variant of
  ``tools/profile_matvec.py`` (tensors stay in cache; what is left is
  compute, gathers and atomics).

A wrapper runs the plain PyTorch version (gather, batched einsum,
``index_add_``) when ``x`` lies on the CPU and launches the CUDA kernel
when it lies on a CUDA device; for any other device it raises.  A CUDA
launch never falls back: a build or launch failure raises.

``launches`` counts kernel launches per entry and mode and
``plain_calls`` counts plain-version calls made through the wrappers,
so a run can show which path its operators took.
"""

from __future__ import annotations

import torch

from . import build

SADDLE_MODES = ("full", "full_pp", "uu", "up")
LANES = 128  # the TPU kernels' lane width: one grid block of cells

launches = {**{f"saddle_{m}": 0 for m in SADDLE_MODES}, "scalar": 0,
            "saddle_full_pinned": 0, "stream_saddle": 0, "stream_probe": 0}
plain_calls = {"saddle": 0, "scalar": 0, "stream_saddle": 0, "stream_probe": 0}


def reset_counts() -> None:
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

def saddle_matvec_plain(uu, up, pu, pp, cd_u, cd_p, x, mode, n_u_nodes):
    """Plain version of ``saddle_matvec`` (same arguments)."""
    nc, nlu = cd_u.shape
    n3 = 3 * n_u_nodes
    cu = cd_u.long()
    cp = cd_p.long()
    if mode != "up":
        xe_u = x[:n3].reshape(-1, 3)[cu].reshape(nc, 3 * nlu)
    if mode != "uu":
        xe_p = (x if mode == "up" else x[n3:])[cp]
    if mode == "uu":
        ye_u = torch.einsum("cij,cj->ci", uu, xe_u)
    elif mode == "up":
        ye_u = torch.einsum("cij,cj->ci", up, xe_p)
    else:
        ye_u = (torch.einsum("cij,cj->ci", uu, xe_u)
                + torch.einsum("cij,cj->ci", up, xe_p))
        ye_p = torch.einsum("cij,cj->ci", pu, xe_u)
        if mode == "full_pp":
            ye_p = ye_p + torch.einsum("cij,cj->ci", pp, xe_p)
    yu = x.new_zeros((n_u_nodes, 3)).index_add_(
        0, cu.reshape(-1), ye_u.reshape(-1, 3)).reshape(-1)
    if mode in ("uu", "up"):
        return yu
    yp = x.new_zeros(x.shape[0] - n3).index_add_(0, cp.reshape(-1), ye_p.reshape(-1))
    return torch.cat([yu, yp])


def saddle_matvec_pinned_plain(uu, up, pu, cd_u, cd_p, x, n_u_nodes):
    """Plain version of ``saddle_matvec(..., "full", pinned=True)``:
    cell c takes the tensors of cell c mod 128."""
    pin = torch.arange(cd_u.shape[0], device=x.device) % LANES
    return saddle_matvec_plain(uu[pin], up[pin], pu[pin], None, cd_u, cd_p, x,
                               "full", n_u_nodes)


def scalar_matvec_plain(ae, cd, x):
    """Plain version of ``scalar_matvec`` (same arguments)."""
    c = cd.long()
    ye = torch.einsum("cij,cj->ci", ae, x[c])
    return torch.zeros_like(x).index_add_(0, c.reshape(-1), ye.reshape(-1))


def stream_saddle_plain(uu, up, pu, carry):
    """Plain version of ``stream_saddle`` (same arguments)."""
    nc = uu.shape[0]
    cell = uu.reshape(nc, -1).sum(1) + up.reshape(nc, -1).sum(1) + pu.reshape(nc, -1).sum(1)
    lane = torch.arange(nc, device=uu.device) % LANES
    acc = uu.new_zeros(LANES).index_add_(0, lane, cell)
    return (carry.to(uu.dtype) + 1e-30 * acc).float()


def stream_probe_plain(parts, w0, idx=None):
    """Plain version of ``stream_probe`` (same arguments)."""
    o = sum(p.sum((0, 1)) for p in parts) + w0.float().sum()
    chk = None if idx is None else sum(i.long().sum() for i in idx).reshape(1)
    return o.reshape(1, LANES), chk


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn_name: str, x: torch.Tensor, *args) -> None:
    lib = build.load()
    fn = getattr(lib, fn_name + ("_f32" if x.dtype == torch.float32 else "_f64"))
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: {lib.nupgcm_error_string(err).decode()}")


def _check_tensors(x, tensors, ints):
    _check(x.dtype in (torch.float32, torch.float64),
           f"kernels take float32 or float64, got {x.dtype}")
    for t in tensors:
        _check(t.dtype == x.dtype and t.device == x.device and t.is_contiguous(),
               "element tensors must be contiguous and match x in dtype and device")
    for t in ints:
        _check(t.dtype == torch.int32 and t.device == x.device and t.is_contiguous(),
               "cell dof tables must be contiguous int32 on the device of x")
    _check(x.is_contiguous(), "x must be contiguous")


def saddle_matvec(uu, up, pu, pp, cd_u, cd_p, x, mode: str, n_u_nodes: int,
                  pinned: bool = False):
    """y = A x for the element-local saddle operator.

    uu (nc, 3nlu, 3nlu), up (nc, 3nlu, nlp), pu (nc, nlp, 3nlu),
    pp (nc, nlp, nlp); cd_u (nc, nlu) velocity node ids, cd_p (nc, nlp)
    pressure dof ids.  Blocks a mode does not read may be None.
      "full":    x, y = [xu (3 n_u_nodes), xp (n_p)];  pp unused
      "full_pp": as "full", plus the pp block
      "uu":      x, y = xu (3 n_u_nodes)
      "up":      x = xp (n_p), y = yu (3 n_u_nodes)
    ``pinned`` (mode "full" only; a measurement probe): the blocks hold
    the first min(nc, 128) cells' tensors and cell c uses those of cell
    c mod 128.
    """
    _check(mode in SADDLE_MODES, f"unknown saddle mode {mode!r}")
    _check(not pinned or mode == "full", "pinned runs mode 'full' only")
    if x.device.type == "cpu":
        plain_calls["saddle"] += 1
        if pinned:
            return saddle_matvec_pinned_plain(uu, up, pu, cd_u, cd_p, x, n_u_nodes)
        return saddle_matvec_plain(uu, up, pu, pp, cd_u, cd_p, x, mode, n_u_nodes)
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")
    blocks = {"uu": uu, "up": up, "pu": pu, "pp": pp}
    used = {"full": ("uu", "up", "pu"), "full_pp": ("uu", "up", "pu", "pp"),
            "uu": ("uu",), "up": ("up",)}[mode]
    _check(all(blocks[k] is not None for k in used), f"mode {mode!r} needs blocks {used}")
    _check_tensors(x, [blocks[k] for k in used], (cd_u, cd_p))
    nc, nlu = cd_u.shape
    nlp = cd_p.shape[1]
    n3 = 3 * n_u_nodes
    nt = min(nc, LANES) if pinned else nc
    shapes = {"uu": (nt, 3 * nlu, 3 * nlu), "up": (nt, 3 * nlu, nlp),
              "pu": (nt, nlp, 3 * nlu), "pp": (nt, nlp, nlp)}
    _check(cd_p.shape[0] == nc and all(blocks[k].shape == shapes[k] for k in used),
           "element blocks and dof tables disagree in shape")
    _check(x.dim() == 1, "x must be a vector")
    if mode == "up":
        y = x.new_zeros(n3)
        xu, xp, yu, yp = None, x, y, None
    elif mode == "uu":
        _check(x.shape[0] == n3, f"x must have length {n3}")
        y = torch.zeros_like(x)
        xu, xp, yu, yp = x, None, y, None
    else:
        _check(x.shape[0] > n3, "x must hold velocity and pressure")
        y = torch.zeros_like(x)
        xu, xp, yu, yp = x, x[n3:], y, y[n3:]
    ptrs = [_ptr(blocks[k]) if k in used else None for k in ("uu", "up", "pu", "pp")]
    _launch("nupgcm_saddle_matvec", x, *ptrs, cd_u.data_ptr(), cd_p.data_ptr(),
            _ptr(xu), _ptr(xp), _ptr(yu), _ptr(yp), nc, nlu, nlp,
            SADDLE_MODES.index(mode), int(pinned))
    launches["saddle_full_pinned" if pinned else f"saddle_{mode}"] += 1
    return y


def scalar_matvec(ae, cd, x):
    """y = A x for a scalar-space element tensor ae (nc, nl, nl) over
    the cell dof table cd (nc, nl)."""
    if x.device.type == "cpu":
        plain_calls["scalar"] += 1
        return scalar_matvec_plain(ae, cd, x)
    _check(x.device.type == "cuda", f"no kernel for device {x.device}")
    _check_tensors(x, (ae,), (cd,))
    nc, nl = cd.shape
    _check(ae.shape == (nc, nl, nl), "ae must be (nc, nl, nl) over cd")
    _check(x.dim() == 1, "x must be a vector")
    y = torch.zeros_like(x)
    _launch("nupgcm_scalar_matvec", x, ae.data_ptr(), cd.data_ptr(),
            x.data_ptr(), y.data_ptr(), nc, nl)
    launches["scalar"] += 1
    return y


def stream_saddle(uu, up, pu, carry):
    """K3: ``carry + 1e-30 * (per-lane sum of every element tensor value)``.

    uu, up, pu: the saddle operator's element tensors (nc, ...), one
    float type; cell c feeds lane c mod 128.  carry: (1, 128) float32.
    Returns (1, 128) float32, the TPU kernel's output type."""
    if uu.device.type == "cpu":
        plain_calls["stream_saddle"] += 1
        return stream_saddle_plain(uu, up, pu, carry)
    _check(uu.device.type == "cuda", f"no kernel for device {uu.device}")
    _check(uu.dtype in (torch.float32, torch.float64),
           f"kernels take float32 or float64, got {uu.dtype}")
    nc = uu.shape[0]
    n_vec = []
    for t in (uu, up, pu):
        _check(t.dtype == uu.dtype and t.device == uu.device and t.is_contiguous()
               and t.shape[0] == nc, "tensors must be contiguous, of one type, "
               "device and cell count")
        per_cell = t[0].numel() * t.element_size() if nc else 0
        _check(per_cell % 16 == 0 and t.data_ptr() % 16 == 0,
               "each cell's tensor slice must be a 16-byte aligned multiple of 16 bytes")
        n_vec.append(per_cell // 16)
    _check(carry.shape == (1, LANES) and carry.dtype == torch.float32
           and carry.device == uu.device and carry.is_contiguous(),
           "carry must be a contiguous (1, 128) float32 tensor on the device")
    acc = uu.new_zeros(LANES)
    out = torch.empty_like(carry)
    _launch("nupgcm_stream_saddle", uu, uu.data_ptr(), up.data_ptr(), pu.data_ptr(),
            carry.data_ptr(), acc.data_ptr(), out.data_ptr(), nc, *n_vec)
    launches["stream_saddle"] += 1
    return out


def stream_probe(parts, w0, idx=None):
    """K4: ``o[j] = sum over parts, blocks and rows of part[b, r, j]
    + sum(w0)``.

    parts: one to three float32 (nb, rows_i, 128) tensors; w0: (nb,)
    int32; idx: None or eight int32 (nb, 1, L) arrays, which the kernel
    reads and sums.  Returns (o (1, 128) float32, checksum): checksum is
    None without idx, else the int64 sum of idx, shape (1,)."""
    w = parts[0]
    if w.device.type == "cpu":
        plain_calls["stream_probe"] += 1
        return stream_probe_plain(parts, w0, idx)
    _check(w.device.type == "cuda", f"no kernel for device {w.device}")
    _check(1 <= len(parts) <= 3, "one to three parts")
    nb = w.shape[0]
    for p in parts:
        _check(p.dtype == torch.float32 and p.device == w.device and p.is_contiguous()
               and p.dim() == 3 and p.shape[0] == nb and p.shape[2] == LANES
               and p.data_ptr() % 16 == 0,
               "parts must be contiguous float32 (nb, rows, 128) on one device")
    _check(w0.shape == (nb,) and w0.dtype == torch.int32 and w0.device == w.device
           and w0.is_contiguous(), "w0 must be contiguous int32 (nb,) on the device")
    rows = [p.shape[1] for p in parts] + [0] * (3 - len(parts))
    ptrs = [p.data_ptr() for p in parts] + [None] * (3 - len(parts))
    out = torch.zeros((1, LANES), dtype=torch.float32, device=w.device)
    chk, idx_ptrs, idx_len = None, [None] * 8, 0
    if idx is not None:
        _check(len(idx) == 8, "idx holds eight arrays")
        idx_len = idx[0].shape[-1]
        for i in idx:
            _check(i.dtype == torch.int32 and i.device == w.device and i.is_contiguous()
                   and i.shape == (nb, 1, idx_len),
                   "idx arrays must be contiguous int32 (nb, 1, L) on the device")
        idx_ptrs = [i.data_ptr() for i in idx]
        chk = torch.zeros(1, dtype=torch.int64, device=w.device)
    _launch("nupgcm_stream_probe", w, *ptrs, *rows, w0.data_ptr(), *idx_ptrs, idx_len,
            out.data_ptr(), _ptr(chk), nb)
    launches["stream_probe"] += 1
    return out, chk
