"""Element-local matvec kernels: wrappers, plain versions, launch counts.

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

launches = {**{f"saddle_{m}": 0 for m in SADDLE_MODES}, "scalar": 0}
plain_calls = {"saddle": 0, "scalar": 0}


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


def scalar_matvec_plain(ae, cd, x):
    """Plain version of ``scalar_matvec`` (same arguments)."""
    c = cd.long()
    ye = torch.einsum("cij,cj->ci", ae, x[c])
    return torch.zeros_like(x).index_add_(0, c.reshape(-1), ye.reshape(-1))


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


def saddle_matvec(uu, up, pu, pp, cd_u, cd_p, x, mode: str, n_u_nodes: int):
    """y = A x for the element-local saddle operator.

    uu (nc, 3nlu, 3nlu), up (nc, 3nlu, nlp), pu (nc, nlp, 3nlu),
    pp (nc, nlp, nlp); cd_u (nc, nlu) velocity node ids, cd_p (nc, nlp)
    pressure dof ids.  Blocks a mode does not read may be None.
      "full":    x, y = [xu (3 n_u_nodes), xp (n_p)];  pp unused
      "full_pp": as "full", plus the pp block
      "uu":      x, y = xu (3 n_u_nodes)
      "up":      x = xp (n_p), y = yu (3 n_u_nodes)
    """
    _check(mode in SADDLE_MODES, f"unknown saddle mode {mode!r}")
    if x.device.type == "cpu":
        plain_calls["saddle"] += 1
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
    shapes = {"uu": (nc, 3 * nlu, 3 * nlu), "up": (nc, 3 * nlu, nlp),
              "pu": (nc, nlp, 3 * nlu), "pp": (nc, nlp, nlp)}
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
            SADDLE_MODES.index(mode))
    launches[f"saddle_{mode}"] += 1
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
