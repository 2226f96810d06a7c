"""Reference-checkpoint (JLD2) interop.

PyTorch counterpart of ``nupgcm_tpu.io.jld2``.  The reference saves
states as JLD2 files holding the free-value vectors ``u``, ``p``, ``b``
and the scalar time ``t`` (reference src/IO.jl:1-10).  JLD2 is an HDF5
dialect, and plain Float64 vectors are ordinary HDF5 datasets: h5py
reads and writes them directly.  h5py is imported where a file is
read or written, so the rest of the package runs without it.

The dof ORDER of those vectors is the producer's (the reference's
checkpoints are not self-describing, SURVEY.md section 5): the
reference orders dofs by Gridap's numbering, this package by RCM.
``import_state`` takes optional permutations from the file's order to
the mesh-canonical one; without them it assumes the vectors are in the
canonical (pre-RCM) order ``export_state`` writes, as the JAX package's
does, so files pass between the two packages both ways.
"""

from __future__ import annotations

import numpy as np
import torch


def read_jld2(path: str) -> dict:
    """Read a JLD2/HDF5 file into a dict of NumPy arrays / scalars."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                try:
                    out[name] = obj[()]
                except (TypeError, ValueError, OSError):  # JLD2 types h5py cannot read
                    pass

        f.visititems(visit)
    return out


def export_state(model, state, path: str):
    """Write a reference-style checkpoint: datasets u (flat), p, b, t in
    the canonical (pre-RCM, mesh) dof order, float64."""
    import h5py

    sp = model.fe.spaces
    host = lambda t: t.detach().double().cpu().numpy()
    u = sp.u_space.to_original_order(host(state.u))
    p = sp.p_space.to_original_order(host(state.p))
    b = sp.b_space.to_original_order(host(state.b))
    with h5py.File(path, "w") as f:
        f.create_dataset("u", data=u.reshape(-1))
        f.create_dataset("p", data=p)
        f.create_dataset("b", data=b)
        f.create_dataset("t", data=np.float64(float(state.t)))


def import_state(model, path: str, perm_u=None, perm_p=None, perm_b=None):
    """A ``State`` on the model's device and dtype from a JLD2 checkpoint.

    ``perm_*``: optional index arrays mapping canonical dof k to the
    file's entry perm[k] (for files in another dof order).  The
    velocity vector is flat: 3 components a node, node-major.  The
    previous-step fields repeat the current ones and the step count is
    0, as after ``set_b``."""
    from ..models.model import State

    d = read_jld2(path)
    sp = model.fe.spaces

    def vec(key, perm):
        v = np.asarray(d[key], np.float64)
        return v if perm is None else v[np.asarray(perm)]

    u = sp.u_space.from_original_order(vec("u", perm_u).reshape(-1, 3))
    p = vec("p", perm_p)
    # the reference's zero-mean pressure space drops one dof; pad if so
    if p.shape[0] == sp.n_p - 1:
        p = np.concatenate([p, [0.0]])
    p = sp.p_space.from_original_order(p)
    b = sp.b_space.from_original_order(vec("b", perm_b))
    return _state(model, State, u, p, b, float(np.asarray(d.get("t", 0.0))))


def _state(model, State, u, p, b, t):
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=model.dtype, device=model.device)
    ub, bb = T(u), T(b)
    return State(u=ub, p=T(p), b=bb, u_prev=ub, b_prev=bb, t=T(t), dt=T(model.ts.dt), step=0)
