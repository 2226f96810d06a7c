"""CUDA kernels of the port: wrappers, plain versions, launch counts.

    y = sum_e P_e^T A_e P_e x

Every Krylov iteration of the model applies operators of this form.
One CUDA kernel, ``block_matvec_kernel`` in ``csrc/element_matvec.cu``
(cell blocks streamed into shared memory, block-local dof tables from
``ops/blocks.py``), covers them through two entries:

* ``saddle_matvec`` (K1) -- the saddle operator ``[uu up; pu pp]`` over
  the node-major velocity (dof = 3*node + comp) and the pressure, in
  four modes: "full" (pp = 0), "full_pp", "uu" (velocity block alone)
  and "up" (velocity rows from a pressure vector).  It replaces
  ``nupgcm_tpu/ops/window.py::saddle_matvec``.
* ``scalar_matvec`` (K2) -- one scalar space, A (nc, nl, nl).  It
  replaces ``window.py::scalar_matvec``.

Operators applied many times hold a ``PreparedLaunch``
(``saddle_launch``, ``scalar_launch``): the tensors, tables and shapes
are checked once, and each call reads the current stream, takes as y a
buffer the previous launch zeroed, allocates the next one and makes one
ctypes call that launches the kernel (which zeroes that next buffer).
The module-level wrappers keep their signatures and prepare a launch
for one call.

Three measurement probes (``csrc/stream_probe.cu`` and the pinned
instantiation of the block kernel; see those files for their design)
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
  compute, gathers and scatters).

A wrapper runs the plain PyTorch version (gather, batched einsum,
``index_add_``) when ``x`` lies on the CPU and launches the CUDA kernel
when it lies on a CUDA device; for any other device it raises.  A CUDA
launch never falls back: a build or launch failure raises.

``launches`` counts kernel launches per entry and mode,
``shape_launches`` per mode and local sizes, and ``plain_calls``
counts plain-version calls made through the wrappers, so a run can
show which path its operators took.
"""

from __future__ import annotations

import ctypes

import torch

from . import blocks, build

SADDLE_MODES = ("full", "full_pp", "uu", "up")
LANES = 128  # the TPU kernels' lane width: one grid block of cells

launches = {**{f"saddle_{m}": 0 for m in SADDLE_MODES}, "scalar": 0,
            "saddle_full_pinned": 0, "stream_saddle": 0, "stream_probe": 0}
plain_calls = {"saddle": 0, "scalar": 0, "stream_saddle": 0, "stream_probe": 0}
# K1/K2 launches per mode and local sizes, e.g. "saddle_uu[4,0]" (the
# P1 coarse velocity block) or "scalar[10]"; keys appear when a launch
# is prepared
shape_launches = {}


def reset_counts() -> None:
    for d in (launches, plain_calls, shape_launches):
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


# ----------------------------------------------------------------------
# K1 / K2: prepared launches of the block kernel
# ----------------------------------------------------------------------

_MODE_ID = {"full": 0, "full_pp": 1, "uu": 2, "up": 3, "scalar": 4}
# local sizes with a compiled instantiation: (nlu, nlp) pairs of the
# P2-P1 and P1-P1 tet and triangle operators; nl of velocity-only and
# scalar operators
SADDLE_PAIRS = ((10, 4), (4, 4), (6, 3), (3, 3))
SINGLE_NL = (10, 6, 4, 3)
_USED = {"full": ("uu", "up", "pu"), "full_pp": ("uu", "up", "pu", "pp"),
         "uu": ("uu",), "up": ("up",)}


class _LaunchParams(ctypes.Structure):
    """Mirror of ``struct EmLaunch`` in csrc/element_matvec.cu."""
    _fields_ = [("a", ctypes.c_void_p * 4),
                *((f, ctypes.c_void_p) for f in ("slot_u", "slot_p", "lists_u", "lists_p")),
                *((f, ctypes.c_longlong) for f in ("nc", "n_tensor", "u_len", "y_len")),
                *((f, ctypes.c_int) for f in ("nblk", "cells", "ls_u", "ls_p", "sp_u",
                                              "sp_p", "mode", "nlu", "nlp", "f64", "pinned",
                                              "device", "grid", "smem")),
                ("launcher", ctypes.c_void_p)]


def _set_tables(p, tu, tp):
    """Point the launch at the block tables (``tp`` None: velocity only)."""
    p.slot_u, p.lists_u = tu.slot_blocks.data_ptr(), tu.lists.data_ptr()
    p.nblk, p.cells, p.ls_u, p.sp_u = tu.nblk, tu.cells, tu.list_stride, tu.slot_stride
    keep = [tu.slot_blocks, tu.lists]
    if tp is not None:
        p.slot_p, p.lists_p = tp.slot_blocks.data_ptr(), tp.lists.data_ptr()
        p.ls_p, p.sp_p = tp.list_stride, tp.slot_stride
        keep += [tp.slot_blocks, tp.lists]
    return keep


_prepared = {}  # (mode, sizes, block shape, device) -> (grid, smem, launcher)


class PreparedLaunch:
    """One K1/K2 application on fixed tensors, checked and prepared
    once.  A call reads the current stream, takes as y the spare buffer
    the previous launch zeroed on that stream (a fresh zero vector the
    first time or after a change of stream), allocates the next spare,
    makes one ctypes call (the launch, which zeroes the spare), and
    counts the launch."""

    __slots__ = ("params", "keep", "dtype", "index", "x_shape", "y_len", "counter",
                 "shape_key", "_fn", "_addr", "_lib", "_spare", "_stream")

    def __init__(self, params: _LaunchParams, keep, dtype, device, x_len: int,
                 counter: str, shape_key: str):
        lib = build.load()
        self.params, self.keep, self.dtype = params, keep, dtype
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        params.device = self.index
        # operators are rebuilt every step: prepare each kernel shape once
        key = (params.mode, params.nlu, params.nlp, params.f64, params.pinned, params.cells,
               params.ls_u, params.ls_p, params.sp_u, params.sp_p, params.nblk, self.index)
        if key not in _prepared:
            with torch.cuda.device(self.index):
                err = lib.nupgcm_em_prepare(ctypes.byref(params))
            if err != 0:
                raise (ValueError if err in (-1, -2) else RuntimeError)(
                    f"{shape_key}: preparing the kernel failed: "
                    f"{lib.nupgcm_error_string(err).decode()}")
            _prepared[key] = (params.grid, params.smem, params.launcher)
        params.grid, params.smem, params.launcher = _prepared[key]
        self.x_shape = (x_len,)
        self.y_len = params.y_len
        self.counter, self.shape_key = counter, shape_key
        self._fn, self._addr, self._lib = lib.nupgcm_em_apply, ctypes.addressof(params), lib
        self._spare, self._stream = None, None
        shape_launches.setdefault(shape_key, 0)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if (x.shape != self.x_shape or x.dtype is not self.dtype
                or x.get_device() != self.index or not x.is_contiguous()):
            raise ValueError(f"{self.shape_key}: x must be a contiguous {self.dtype} vector "
                             f"of shape {self.x_shape} on cuda:{self.index}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        stream = _raw_stream(self.index)
        y = self._spare if stream == self._stream else x.new_zeros(self.y_len)
        spare = x.new_empty(self.y_len)
        err = self._fn(self._addr, x.data_ptr(), y.data_ptr(), spare.data_ptr(), stream)
        if err != 0:
            self._spare = self._stream = None
            raise RuntimeError(f"{self.shape_key} launch failed: "
                               f"{self._lib.nupgcm_error_string(err).decode()}")
        self._spare, self._stream = spare, stream
        launches[self.counter] += 1
        shape_launches[self.shape_key] += 1
        return y


def _raw_stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def _check_float(t, dtype, device, what):
    _check(t.dtype == dtype and t.device == device and t.is_contiguous()
           and t.data_ptr() % 16 == 0,
           f"{what} must be a contiguous, 16-byte aligned {dtype} tensor on {device}")


def _check_table(t, nc, nl, device, what):
    _check(t is not None and t.nc == nc and t.nl == nl and t.device == device,
           f"{what}: the block table does not match the dof table ({nc}, {nl}) on {device}")


def check_saddle(uu, up, pu, pp, cd_u, cd_p, mode: str, pinned: bool = False):
    """Shapes and types of a saddle operator for ``mode``; raises
    ValueError.  Returns (nc, nlu, nlp)."""
    _check(mode in SADDLE_MODES, f"unknown saddle mode {mode!r}")
    _check(not pinned or mode == "full", "pinned runs mode 'full' only")
    parts = {"uu": uu, "up": up, "pu": pu, "pp": pp}
    used = _USED[mode]
    _check(all(parts[k] is not None for k in used), f"mode {mode!r} needs blocks {used}")
    _check(cd_u.dim() == 2 and cd_p.dim() == 2 and cd_p.shape[0] == cd_u.shape[0],
           "cd_u and cd_p must be (nc, nl) tables over the same cells")
    nc, nlu = cd_u.shape
    nlp = cd_p.shape[1]
    nt = min(nc, LANES) if pinned else nc
    shapes = {"uu": (nt, 3 * nlu, 3 * nlu), "up": (nt, 3 * nlu, nlp),
              "pu": (nt, nlp, 3 * nlu), "pp": (nt, nlp, nlp)}
    for k in used:
        _check(tuple(parts[k].shape) == shapes[k],
               f"block {k} has shape {tuple(parts[k].shape)}, expected {shapes[k]}")
        _check(parts[k].dtype == parts[used[0]].dtype and parts[k].is_floating_point(),
               f"element blocks of mode {mode!r} must share one float type")
    return nc, nlu, nlp


def check_scalar(ae, cd):
    """Shapes and type of a scalar-space operator; raises ValueError."""
    _check(cd.dim() == 2 and tuple(ae.shape) == (cd.shape[0], cd.shape[1], cd.shape[1])
           and ae.is_floating_point(), "ae must be a float (nc, nl, nl) tensor over cd")


def saddle_launch(uu, up, pu, pp, tables, mode: str, n_u_nodes: int, n_p: int = 0,
                  pinned: bool = False) -> PreparedLaunch:
    """The prepared K1 launch of ``mode`` on CUDA blocks with block
    tables ``tables`` = (velocity, pressure) (``ops/blocks.py``; the
    pressure table is None in mode "uu").  x has length 3 n_u_nodes +
    n_p ("full", "full_pp"), 3 n_u_nodes ("uu") or n_p ("up")."""
    parts = {"uu": uu, "up": up, "pu": pu, "pp": pp}
    used = _USED[mode]
    ref = parts[used[0]]
    dtype, device = ref.dtype, ref.device
    _check(dtype in (torch.float32, torch.float64),
           f"kernels take float32 or float64, got {dtype}")
    _check(device.type == "cuda", f"no kernel for device {device}")
    tu, tp = tables
    nlu = tu.nl
    nlp = tp.nl if mode != "uu" else 0
    nc = tu.nc
    nt = min(nc, LANES) if pinned else nc
    _check((nlu, nlp) in SADDLE_PAIRS if mode != "uu" else nlu in SINGLE_NL,
           f"no kernel for mode {mode!r} with nlu = {nlu}, nlp = {nlp}")
    for k in used:
        _check_float(parts[k], dtype, device, f"block {k}")
    sh = {"uu": (nt, 3 * nlu, 3 * nlu), "up": (nt, 3 * nlu, nlp), "pu": (nt, nlp, 3 * nlu),
          "pp": (nt, nlp, nlp)}
    _check(all(tuple(parts[k].shape) == sh[k] for k in used),
           "element blocks and block tables disagree in shape")
    _check_table(tu, nc, nlu, device, "velocity")
    if mode != "uu":
        _check_table(tp, nc, nlp, device, "pressure")
        _check(tp.cells == tu.cells, "velocity and pressure tables need one block size")
    n3 = 3 * n_u_nodes
    x_len = {"full": n3 + n_p, "full_pp": n3 + n_p, "uu": n3, "up": n_p}[mode]
    y_len = n3 + n_p if mode in ("full", "full_pp") else n3
    p = _LaunchParams()
    for i, k in enumerate(("uu", "up", "pu", "pp")):
        p.a[i] = parts[k].data_ptr() if k in used else None
    keep = [parts[k] for k in used] + _set_tables(p, tu, None if mode == "uu" else tp)
    p.nc, p.n_tensor, p.u_len, p.y_len = nc, nt, n3, y_len
    p.mode, p.nlu, p.nlp = _MODE_ID[mode], nlu, nlp
    p.f64, p.pinned = int(dtype == torch.float64), int(pinned)
    counter = "saddle_full_pinned" if pinned else f"saddle_{mode}"
    return PreparedLaunch(p, keep, dtype, device, x_len, counter,
                          f"{counter}[{nlu},{nlp}]")


def scalar_launch(ae, table, n: int) -> PreparedLaunch:
    """The prepared K2 launch of A (nc, nl, nl) on a CUDA device over the
    block table ``table`` of its dof table; x and y have length n."""
    dtype, device = ae.dtype, ae.device
    _check(dtype in (torch.float32, torch.float64),
           f"kernels take float32 or float64, got {dtype}")
    _check(device.type == "cuda", f"no kernel for device {device}")
    nc, nl = table.nc, table.nl
    _check(nl in SINGLE_NL, f"no scalar kernel with nl = {nl}")
    _check_float(ae, dtype, device, "ae")
    _check(tuple(ae.shape) == (nc, nl, nl), "ae must be (nc, nl, nl) over the block table")
    _check_table(table, nc, nl, device, "scalar")
    p = _LaunchParams()
    p.a[0] = ae.data_ptr()
    keep = [ae] + _set_tables(p, table, None)
    p.nc, p.n_tensor, p.u_len, p.y_len = nc, nc, n, n
    p.mode, p.nlu, p.f64 = _MODE_ID["scalar"], nl, int(dtype == torch.float64)
    return PreparedLaunch(p, keep, dtype, device, n, "scalar", f"scalar[{nl}]")


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
    c mod 128.  On a CUDA device this builds the block tables and the
    prepared launch for one call; operators that apply many times hold
    a ``saddle_launch`` (``ops/element.py``).
    """
    _check(mode in SADDLE_MODES, f"unknown saddle mode {mode!r}")
    _check(not pinned or mode == "full", "pinned runs mode 'full' only")
    _check(x.device.type in ("cpu", "cuda"), f"no kernel for device {x.device}")
    check_saddle(uu, up, pu, pp, cd_u, cd_p, mode, pinned)
    if x.device.type == "cpu":
        plain_calls["saddle"] += 1
        if pinned:
            return saddle_matvec_pinned_plain(uu, up, pu, cd_u, cd_p, x, n_u_nodes)
        return saddle_matvec_plain(uu, up, pu, pp, cd_u, cd_p, x, mode, n_u_nodes)
    _check(x.dim() == 1, "x must be a vector")
    n3 = 3 * n_u_nodes
    n_p = {"full": x.shape[0] - n3, "full_pp": x.shape[0] - n3, "uu": 0, "up": x.shape[0]}[mode]
    _check(n_p >= 0 and (mode in ("uu", "up") or n_p > 0),
           "x must hold velocity and pressure")
    item = (uu if uu is not None else up).element_size()
    tables = blocks.saddle_tables(cd_u, cd_p, mode, item)
    return saddle_launch(uu, up, pu, pp, tables, mode, n_u_nodes, n_p, pinned)(x)


def scalar_matvec(ae, cd, x):
    """y = A x for a scalar-space element tensor ae (nc, nl, nl) over
    the cell dof table cd (nc, nl)."""
    _check(x.device.type in ("cpu", "cuda"), f"no kernel for device {x.device}")
    check_scalar(ae, cd)
    if x.device.type == "cpu":
        plain_calls["scalar"] += 1
        return scalar_matvec_plain(ae, cd, x)
    _check(x.dim() == 1, "x must be a vector")
    return scalar_launch(ae, blocks.scalar_table(cd, ae.element_size()), x.shape[0])(x)


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
