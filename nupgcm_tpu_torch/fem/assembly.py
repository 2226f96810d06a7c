"""Element-batched FEM assembly: host scatter plans + torch einsums.

Counterpart of ``nupgcm_tpu.fem.assembly``.  Element tensors are
batched ``torch.einsum`` contractions of quadrature tables; assembling
element vectors into a global dof vector is one ``index_add_`` over
the flattened cell dof table.  The operator hot path never assembles a
sparse matrix (see ``ops/element.py``); ``MatrixPlan`` assembles one
for diagnostics, SciPy export and the reference's assembled-matrix
regressions: every element-matrix entry maps to a slot of a sorted-COO
value vector, and assembly is one ``index_add_`` on the tensor's
device.
"""

from __future__ import annotations

import numpy as np
import torch


class VectorPlan:
    """Maps flattened element-vector entries to dof slots."""

    def __init__(self, ndof: int, dofs: np.ndarray):
        self.ndof = ndof
        self.dofs = np.ascontiguousarray(dofs.reshape(-1), dtype=np.int64)
        self._index = {}  # device -> int64 index tensor

    def index(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._index:
            self._index[device] = torch.as_tensor(self.dofs, device=device)
        return self._index[device]

    def assemble(self, elem_vals: torch.Tensor) -> torch.Tensor:
        """(nc, nl) element values -> (ndof,) assembled vector."""
        out = elem_vals.new_zeros(self.ndof)
        return out.index_add_(0, self.index(elem_vals.device), elem_vals.reshape(-1))

    def assemble_rows(self, row_vals: torch.Tensor) -> torch.Tensor:
        """Scatter (n_entries, k) rows -> (ndof, k): one index per row
        of k values (used for node-grouped 3-vector scatters)."""
        k = row_vals.shape[-1]
        out = row_vals.new_zeros((self.ndof, k))
        return out.index_add_(0, self.index(row_vals.device), row_vals.reshape(-1, k))


def build_vector_plan(dofs: np.ndarray, ndof: int) -> VectorPlan:
    return VectorPlan(ndof=ndof, dofs=dofs)


class MatrixPlan:
    """Maps flattened element-matrix entries (c, i, j) to sorted-COO
    slots.  ``rows``/``cols`` (nnz,) int32 are sorted row-major;
    ``gather_perm`` (the sort order of the entries) and ``slot_sorted``
    (the slot of each sorted entry) are the JAX plan's tables, and
    ``slot`` (the slot of each entry in element order) drives the
    ``index_add_``."""

    def __init__(self, n_rows, n_cols, rows, cols, gather_perm, slot_sorted, slot):
        self.n_rows, self.n_cols, self.nnz = n_rows, n_cols, len(rows)
        self.rows, self.cols = rows, cols
        self.gather_perm, self.slot_sorted = gather_perm, slot_sorted
        self.slot = slot
        self._index = {}  # device -> int64 slot tensor

    def index(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._index:
            self._index[device] = torch.as_tensor(self.slot, dtype=torch.int64,
                                                  device=device)
        return self._index[device]

    def assemble(self, elem_vals: torch.Tensor) -> torch.Tensor:
        """Element tensors (nc, nl_r, nl_c) -> (nnz,) values on their device."""
        out = elem_vals.new_zeros(self.nnz)
        return out.index_add_(0, self.index(elem_vals.device), elem_vals.reshape(-1))


def build_matrix_plan(row_dofs: np.ndarray, col_dofs: np.ndarray,
                      n_rows: int, n_cols: int, pad_nnz_to: int = 1) -> MatrixPlan:
    """row_dofs (nc, nl_r), col_dofs (nc, nl_c): one entry per (c,i,j).

    ``pad_nnz_to``: pad the nnz count to a multiple (dummy trailing
    entries at (n_rows-1, n_cols-1) that no element entry adds to), as
    the JAX plan does to shard its value vector evenly.
    """
    nc, nlr = row_dofs.shape
    nlc = col_dofs.shape[1]
    r = np.repeat(row_dofs[:, :, None], nlc, axis=2).reshape(-1)
    c = np.repeat(col_dofs[:, None, :], nlr, axis=1).reshape(-1)
    key = r.astype(np.int64) * np.int64(n_cols) + c
    uniq, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    gather_perm = np.argsort(inv, kind="stable").astype(np.int32)
    rows = (uniq // n_cols).astype(np.int32)
    cols = (uniq % n_cols).astype(np.int32)
    pad = (-len(uniq)) % pad_nnz_to
    if pad:
        rows = np.concatenate([rows, np.full(pad, n_rows - 1, np.int32)])
        cols = np.concatenate([cols, np.full(pad, n_cols - 1, np.int32)])
    return MatrixPlan(n_rows, n_cols, rows, cols, gather_perm,
                      inv[gather_perm].astype(np.int32), inv.astype(np.int32))


# ----------------------------------------------------------------------
# gradient tables
# ----------------------------------------------------------------------

def physical_grads(invJT, dphi, embed):
    """Physical gradients embedded in 3D.

    invJT (nc, tdim, tdim), dphi (nq, nl, tdim) reference grads,
    embed (tdim, 3) plane->3D axis embedding.
    Returns G3 (nc, nq, nl, 3); the y-column is zero for 2D meshes.
    """
    gp = torch.einsum("cpr,qir->cqip", invJT, dphi)  # plane components
    return torch.einsum("cqip,pd->cqid", gp, embed)


# ----------------------------------------------------------------------
# element kernels (volume)
# ----------------------------------------------------------------------

def elem_mass(wq, phi_r, phi_c):
    """M_e[c,i,j] = sum_q w phi_r_i phi_c_j  (reference build_M,
    src/evolution.jl:209-212)."""
    return torch.einsum("cq,qi,qj->cij", wq, phi_r, phi_c)


def elem_weighted_mass(wq, coeff_q, phi_r, phi_c):
    return torch.einsum("cq,cq,qi,qj->cij", wq, coeff_q, phi_r, phi_c)


def elem_stiffness(wq, coeff_q, G3, axes):
    """K_e[c,i,j] = sum_q w k sum_{d in axes} dG_i dG_j.

    axes = (0, 1) gives the horizontal stiffness K_h, axes = (2,) the
    vertical K_v (reference src/evolution.jl:224-246).
    """
    Gs = G3[..., list(axes)]
    return torch.einsum("cq,cq,cqid,cqjd->cij", wq, coeff_q, Gs, Gs)


def elem_rhs_diff(wq, coeff_q, G3, N2):
    """rhs_diff_e[c,i] = sum_q w (-N^2 k) dz(phi_i)
    (reference build_rhs_diff, src/evolution.jl:269-278)."""
    return -N2 * torch.einsum("cq,cq,cqi->ci", wq, coeff_q, G3[..., 2])


def _coriolis_skew(dtype, device):
    """C[b, a] with f (zhat x u).v = f (u_x v_y - u_y v_x)."""
    C = torch.zeros((3, 3), dtype=dtype, device=device)
    C[1, 0], C[0, 1] = 1.0, -1.0
    return C


def elem_inversion_blocks(wq, nu_q, f_q, phi_u, Gu3, phi_p, a2e2,
                          variable_nu: bool):
    """Saddle element blocks (uu, up, pu).

    Local velocity index: node i, component a -> 3*i + a.  Entry order
    elem[c, test, trial].  Forms (reference bilinear_form,
    src/inversion.jl:172-192):
      constant nu:  a2e2 * nu * grad(u) : grad(v)
      variable nu:  2 a2e2 * nu * sym_grad(u) : sym_grad(v)
                    = a2e2 * nu * (delta_ab grad_i.grad_j + d_b phi_i d_a phi_j)
      - (div v) p + q (div u) + f (zhat x u).v
    The zero pp block is never built.
    """
    nc = wq.shape[0]
    nlu = phi_u.shape[1]
    nlp = phi_p.shape[1]
    eye3 = torch.eye(3, dtype=wq.dtype, device=wq.device)

    lap = torch.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, Gu3, Gu3)  # test j, trial i
    visc = a2e2 * torch.einsum("cji,ba->cjbia", lap, eye3)
    if variable_nu:
        visc = visc + a2e2 * torch.einsum("cq,cq,cqib,cqja->cjbia", wq, nu_q, Gu3, Gu3)
    mf = torch.einsum("cq,cq,qj,qi->cji", wq, f_q, phi_u, phi_u)
    C = _coriolis_skew(wq.dtype, wq.device)
    uu = (visc + torch.einsum("cji,ba->cjbia", mf, C)).reshape(nc, 3 * nlu, 3 * nlu)
    # pressure gradient: -(div v) p  -> test (j,b), trial k
    up = -torch.einsum("cq,cqjb,qk->cjbk", wq, Gu3, phi_p).reshape(nc, 3 * nlu, nlp)
    # continuity: q (div u) -> test k, trial (i,a)
    pu = torch.einsum("cq,qk,cqia->ckia", wq, phi_p, Gu3).reshape(nc, nlp, 3 * nlu)
    return uu, up, pu


def elem_inversion(wq, nu_q, f_q, phi_u, Gu3, phi_p, a2e2, variable_nu: bool):
    """Full inversion element matrix over the combined (u, p) space:
    ``elem_inversion_blocks`` with the zero pressure block, as one
    (nc, 3 nlu + nlp, 3 nlu + nlp) tensor.  Local combined index:
    velocity node i, component a -> 3*i + a; pressure node k ->
    3*nlu + k.  For assembled-matrix diagnostics (``MatrixPlan``); the
    step keeps the blocks apart."""
    uu, up, pu = elem_inversion_blocks(wq, nu_q, f_q, phi_u, Gu3, phi_p, a2e2, variable_nu)
    pp = wq.new_zeros((wq.shape[0], pu.shape[1], up.shape[2]))
    return torch.cat([torch.cat([uu, up], dim=2), torch.cat([pu, pp], dim=2)], dim=1)


def elem_buoyancy_to_velocity(wq, phi_u, phi_b, inv_alpha):
    """B element tensor: (1/alpha) b (zhat . v)
    (reference build_B_inversion, src/inversion.jl:199-218).

    Returns (nc, 3*nlu, nlb) with only w-component rows nonzero.
    """
    nc = wq.shape[0]
    nlu = phi_u.shape[1]
    nlb = phi_b.shape[1]
    bw = inv_alpha * torch.einsum("cq,qj,qk->cjk", wq, phi_u, phi_b)
    out = wq.new_zeros((nc, nlu, 3, nlb))
    out[:, :, 2, :] = bw
    return out.reshape(nc, 3 * nlu, nlb)


# ----------------------------------------------------------------------
# element kernels (surface)
# ----------------------------------------------------------------------

def elem_wind_rhs(wq_f, taux_q, tauy_q, phi_uf, alpha):
    """Wind-stress surface rhs: alpha (taux x + tauy y).v dGamma
    (reference build_b_inversion, src/inversion.jl:242).

    Returns (nf, nlu_f, 3): nonzero x/y components.
    """
    nf = wq_f.shape[0]
    nl = phi_uf.shape[1]
    out = wq_f.new_zeros((nf, nl, 3))
    out[:, :, 0] = alpha * torch.einsum("cq,cq,qi->ci", wq_f, taux_q, phi_uf)
    out[:, :, 1] = alpha * torch.einsum("cq,cq,qi->ci", wq_f, tauy_q, phi_uf)
    return out


def elem_flux_rhs(wq_f, flux_q, phi_bf, alpha):
    """Surface buoyancy-flux rhs: alpha F d dGamma
    (reference build_rhs_flux, src/evolution.jl:283-292)."""
    return alpha * torch.einsum("cq,cq,qi->ci", wq_f, flux_q, phi_bf)


# ----------------------------------------------------------------------
# advection right-hand side (the per-step assembly)
# ----------------------------------------------------------------------

def elem_advection_bdf1(wq, phi_b, Gb3, phi_u, u_e, b_e, N2, dt):
    """BDF1 advection rhs: (b - dt (u.grad b + w N^2)) d
    (reference advection_lform, src/model.jl:292-295).

    u_e (nc, nlu, 3) and b_e (nc, nlb) are gathered element dofs.
    """
    u_q = torch.einsum("qi,cia->cqa", phi_u, u_e)
    b_q = torch.einsum("qi,ci->cq", phi_b, b_e)
    gb_q = torch.einsum("cqid,ci->cqd", Gb3, b_e)
    adv = torch.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * N2
    integ = b_q - dt * adv
    return torch.einsum("cq,qi,cq->ci", wq, phi_b, integ)


def elem_advection_bdf2(wq, phi_b, Gb3, phi_u, u_e, u_prev_e, b_e, b_prev_e, N2, dt):
    """BDF2 advection rhs:
    (4/3 b - 1/3 b_prev - 2/3 dt ((2u - u_prev).grad(2b - b_prev)
                                  + (2w - w_prev) N^2)) d
    (reference advection_lform, src/model.jl:297-300)."""
    ue = 2.0 * u_e - u_prev_e
    be = 2.0 * b_e - b_prev_e
    u_q = torch.einsum("qi,cia->cqa", phi_u, ue)
    gb_q = torch.einsum("cqid,ci->cqd", Gb3, be)
    adv = torch.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * N2
    b_q = torch.einsum("qi,ci->cq", phi_b, b_e)
    bp_q = torch.einsum("qi,ci->cq", phi_b, b_prev_e)
    integ = 4.0 / 3.0 * b_q - 1.0 / 3.0 * bp_q - 2.0 / 3.0 * dt * adv
    return torch.einsum("cq,qi,cq->ci", wq, phi_b, integ)
