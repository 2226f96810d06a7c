"""Checkpoint / resume (npz), parity with reference src/IO.jl:1-23.

The same keys and checks as ``nupgcm_tpu.io.checkpoint``, so a
checkpoint written by either package loads in the other.  Checkpoints
are self-describing: they carry mesh/dof counts and the time-stepper
clock so a mismatched restore fails loudly instead of silently
scattering values.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_state(model, state, path: str):
    """Write u/p/b + clock (reference save_state, src/IO.jl:1-10)."""
    np.savez_compressed(
        path,
        u=_host(state.u),
        p=_host(state.p),
        b=_host(state.b),
        u_prev=_host(state.u_prev),
        b_prev=_host(state.b_prev),
        t=float(state.t),
        dt=float(state.dt),
        step=int(state.step),
        n_u=model.fe.spaces.n_u,
        n_p=model.fe.spaces.n_p,
        n_b=model.fe.spaces.n_b,
        n_cells=model.fe.mesh.n_cells,
        version=1,
    )


def load_state(model, path: str):
    """Restore a State on the model's device and dtype (reference
    set_state_from_file!, src/IO.jl:12-23)."""
    from ..models.model import State

    d = np.load(path)
    for key, expect in (("n_u", model.fe.spaces.n_u), ("n_p", model.fe.spaces.n_p),
                        ("n_b", model.fe.spaces.n_b), ("n_cells", model.fe.mesh.n_cells)):
        if int(d[key]) != expect:
            raise ValueError(
                f"checkpoint {path}: {key}={int(d[key])} does not match model ({expect})"
            )

    def T(v):
        return torch.as_tensor(np.asarray(v), dtype=model.dtype, device=model.device)

    return State(u=T(d["u"]), p=T(d["p"]), b=T(d["b"]), u_prev=T(d["u_prev"]),
                 b_prev=T(d["b_prev"]), t=T(float(d["t"])), dt=T(float(d["dt"])),
                 step=int(d["step"]))
