"""The PG model: state, operators, timestep, run loop.

PyTorch counterpart of ``nupgcm_tpu.models.model`` (reference
src/model.jl ``Model`` / ``run!`` / ``evolve!`` / ``invert!``).  One
timestep:

  1. ``_update_dt``: CFL dt with BDF1/BDF2 coefficients;
  2. ``_evolve_pure``: advection rhs (element einsum + scatter), then
     Jacobi-CG on ``M + theta (Kh + Kv)``;
  3. ``_invert_pure``: FGMRES(20) on the P2-P1 saddle system with the
     block-Stokes preconditioner, then the zero-mean pressure
     projection.

State holds full-length dof vectors (Dirichlet dofs are pinned by
masks, never compacted).  The buoyancy vector carries its Dirichlet
values, so the B-matrix product already contains the reference's
``b_diri`` lift (reference src/inversion.jl:242-243).  Every element
operator application goes through ``ops/kernels.py``: the CUDA kernels
on a CUDA device, their plain versions on the CPU.

Closures (reference src/inputs.jl:63-137): convection rebuilds the
vertical diffusivity from the current b every step; the eddy closure
rebuilds the inversion blocks from the current b every 10 steps
(reference src/model.jl:160-170) and, with ``refresh_on_rebuild`` (the
default), every nu-dependent part of the preconditioner from the same
viscosity right after.  The reference, and the JAX package, keep the
preconditioner built for the old viscosity (``refresh_on_rebuild=False``
here), on which FGMRES can stall at its cap until the caller's next
``refresh_precond``.

Preconditioner branches: the P1-P1 saddle-coarse level (the default;
dense inverse on small meshes; on large ones iterative, its operators
applied from assembled vertex blocks, with an aggregate second level)
or, with ``saddle_coarse=False, twogrid=True``, the u-block two-grid (a
P1-vertex coarse level of the velocity block: dense inverse on small
meshes, inner CG on the assembled P1 operator on large ones).  The
block-triangular preconditioner applies the P2-P1 pressure coupling
from its assembled blocks (P2 nodes x vertices), and every
preconditioner the P1 pressure mass from its vertex blocks.  The model
holds one assembled operator per element tensor it applies so
(``_held``, and ``_sc_op`` for the coarse saddle), refilled when ``ops``
is set and, after the build, by the one path that writes ``ops``, in
place (``_put``).
"""

from __future__ import annotations

import sys
import time
import types
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..fem import assembly as asm
from ..fem.spaces import _eval_coeff
from ..ops import blocks, build
from ..ops.assembled import AssembledBlocks, AssembledSaddle, vertex_pattern
from ..ops.element import ElementOperator, SaddleOperator
from ..ops.sparse import MaskedOperator
from ..solvers import graphed
from ..solvers.cg import cg
from ..solvers.gmres import gmres
from ..solvers.preconditioners import (AggregateCoarseCorrection,
                                       BlockStokesPrecond, CoarseCorrection,
                                       SaddleCoarseCorrection, power_lmax)
from ..utils.precision import precision_ctx, scoped_method
from ..utils.timing import build_span, count, read, span
from .config import Forcings, Parameters, SurfaceFluxBC
from .fedata import FEData
from .timesteppers import BDF2


class BlowUpError(RuntimeError):
    pass


# per-step diagnostics of ``PGModel.step`` (the JAX step's aux keys)
AUX_KEYS = ("evo_iters", "evo_res", "inv_iters", "inv_res", "u_max", "b_max",
            "b_free_min", "b_free_max", "db_dt_max", "cfl_dt")
# beside them in ``step``'s aux, not stacked by ``multi_step``: 1.0 where the
# step ended in an eddy rebuild, and the host seconds of that rebuild and
# of the preconditioner rebuild after it (0.0 on every other step)
REBUILD_KEYS = ("rebuilt", "rebuild_s")


def _aggregate_vertices(cd_p: np.ndarray, nv: int, max_agg: int):
    """Cluster mesh vertices into <= max_agg contiguous aggregates.

    Capped BFS over the vertex-vertex connectivity (from the P1 cell
    dof table), seeded in vertex order -- vertices carry the RCM
    permutation (fem/spaces.py), so consecutive seeds grow
    band-compact aggregates.  The cap is grown until the aggregate
    count fits; stragglers surrounded by full aggregates become small
    aggregates of their own (harmless).  Returns (agg (nv,) int64,
    n_agg)."""
    from scipy import sparse as _sp

    nl = cd_p.shape[1]
    ii = [cd_p[:, a] for a in range(nl) for b in range(nl) if a != b]
    jj = [cd_p[:, b] for a in range(nl) for b in range(nl) if a != b]
    adj = _sp.csr_matrix(
        (np.ones(nl * (nl - 1) * cd_p.shape[0], np.int8),
         (np.concatenate(ii), np.concatenate(jj))), shape=(nv, nv))
    indptr, indices = adj.indptr, adj.indices
    cap = max(2, -(-nv // max_agg))
    while True:
        agg = np.full(nv, -1, np.int64)
        na = 0
        for seed in range(nv):
            if agg[seed] >= 0:
                continue
            agg[seed] = na
            size = 1
            frontier = [seed]
            while frontier and size < cap:
                nxt = []
                for v in frontier:
                    for w in indices[indptr[v]:indptr[v + 1]]:
                        if agg[w] < 0:
                            agg[w] = na
                            size += 1
                            nxt.append(w)
                            if size >= cap:
                                break
                    if size >= cap:
                        break
                frontier = nxt
            na += 1
        if na <= max_agg:
            return agg, na
        cap = int(cap * 1.5) + 1


@dataclass
class State:
    """Prognostic + diagnostic model state (full dof vectors).

    ``b`` and ``b_prev`` may be the same tensor (right after
    ``set_b``); nothing updates state tensors in place."""

    u: torch.Tensor  # (ndof_u, 3)
    p: torch.Tensor  # (n_p,)
    b: torch.Tensor  # (n_b,) including Dirichlet dofs
    u_prev: torch.Tensor
    b_prev: torch.Tensor
    t: torch.Tensor  # 0-dim
    dt: torch.Tensor  # 0-dim
    step: int


def state_from_numpy(d, device) -> State:
    """State from numpy arrays keyed by field name (u, p, b, u_prev,
    b_prev, t, dt, step) -- e.g. a ``nupgcm_tpu`` State's fields."""
    def T(k):
        return torch.as_tensor(np.array(d[k]), device=device)

    return State(u=T("u"), p=T("p"), b=T("b"), u_prev=T("u_prev"),
                 b_prev=T("b_prev"), t=T("t"), dt=T("dt"), step=int(d["step"]))


def ops_from_numpy(d, device) -> dict:
    """Operator dict from numpy arrays keyed as ``PGModel.ops`` -- e.g.
    a ``nupgcm_tpu`` model's ``ops``, so both packages can run on
    identical element tensors."""
    return {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}


def _quad_eval(fn_or_const, xq: np.ndarray) -> np.ndarray:
    """Evaluate a coefficient on physical quadrature points (host f64)."""
    if callable(fn_or_const):
        vals = np.asarray(_eval_coeff(fn_or_const, xq), dtype=np.float64)
        return np.broadcast_to(vals, xq.shape[:-1]).copy()
    return np.full(xq.shape[:-1], float(fn_or_const))


def _hms(seconds: float) -> str:
    s = int(seconds)
    return "%02d:%02d:%02d" % (s // 3600, (s % 3600) // 60, s % 60)


def progress_message(i, i0, n_info, t, dt, t_stop, elapsed, since_last, aux) -> str:
    """The run loop's progress block, field for field the reference's
    (src/model.jl:172-192): step ``i`` (the run began at ``i0``) at time
    ``t``; ``elapsed`` s since the run began, ``since_last`` s since the
    previous block ``n_info`` steps ago; ``aux`` a step's diagnostics."""
    msg = (f"t = {t:.3e}/{t_stop:.3e} (i = {i}, dt = {dt:.3e})\n"
           f"time elapsed: {_hms(elapsed)}\n")
    if i - i0 > n_info:
        t_step = since_last / n_info
        steps_left = max(0.0, (t_stop - t) // max(dt, 1e-30))
        msg += (f"timestep duration ~ {t_step:.3e} s\n"
                f"estimated time remaining: {_hms(t_step * steps_left)}\n")
    return msg + (f"|u|max = {aux['u_max']:.3e}, CFL dt ~ {aux['cfl_dt']:.3e}\n"
                  f"{aux['b_free_min']:.3e} <= b_free <= {aux['b_free_max']:.3e}, "
                  f"|db/dt|max = {aux['db_dt_max']:.3e}\n"
                  f"evo_it = {int(aux['evo_iters'])}, inv_it = {int(aux['inv_iters'])}")


class PGModel:
    """Planetary-geostrophic model on one torch device.

    ``device="cuda"`` (the default) builds the CUDA element-matvec
    kernels (or raises with the compiler's output, or when there is no
    CUDA device) and runs every operator application through them;
    ``device="cpu"`` runs their plain PyTorch versions.  ``dtype`` is
    float32 (the production type) or float64.

    ``matmul_precision="float32"`` (the default) holds every float32
    product of the build and of the entry points (``step``,
    ``multi_step``, ``run``, ``invert``, ``solve_inversion``,
    ``refresh_precond``, ``retune``) at full float32, whatever TF32
    setting the caller's process holds, and restores that setting on
    return (``utils/precision.py``; the JAX model scopes its traces so,
    ``nupgcm_tpu/models/model.py:341-357``).  ``None`` leaves the
    process's setting in force.

    ``refresh_on_rebuild=True`` (the default) follows each in-step eddy
    rebuild with a rebuild of the preconditioner from the same viscosity
    (what ``refresh_precond`` rebuilds after its own eddy rebuild);
    ``False`` keeps the preconditioner frozen between the caller's
    refreshes, as the reference and the JAX package do.

    The inversion's operators and preconditioner are built when ``ops`` is
    set (the build, the refresh after an eddy rebuild, a caller's
    ``model.ops = ...``) and by ``retune``; a solve builds nothing.  On a
    CUDA device the preconditioner with the ``inner_gmres`` smoother and
    dense coarse levels runs from two CUDA graphs (``solvers/graphed.py``:
    the same arithmetic, with one device read an application instead of
    eight), captured on its first application, and again only after
    ``ops`` is set with another tensor or another host-taken number that
    the application reads.
    """

    def __init__(
        self,
        fe: FEData,
        params: Parameters,
        forcings: Forcings,
        timestepper,
        dtype=torch.float32,
        device="cuda",
        inv_atol=1e-6,
        inv_rtol=1e-6,
        inv_itmax=0,
        inv_memory=20,
        evo_atol=1e-6,
        evo_rtol=1e-6,
        evo_itmax=0,
        preconditioner: str = "blockstokes",
        inner_iters_u: Optional[int] = None,
        inner_iters_p: int = 5,
        inner_method: Optional[str] = None,
        cond_ratio: float = 20.0,
        triangular: bool = True,
        twogrid: bool = True,
        saddle_coarse: Optional[bool] = None,
        coarse_dense_max: int = 12288,
        saddle_coarse_inner: Optional[int] = None,
        saddle_coarse_l2: Optional[bool] = None,
        assembly_chunk: int = 8192,
        matmul_precision: Optional[str] = "float32",
        refresh_on_rebuild: bool = True,
    ):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
        self.fe = fe
        self.params = params
        self.forcings = forcings
        self.ts = timestepper
        self.dtype = dtype
        self.device = torch.device(device)
        if self.device.type == "cuda":
            with build_span("kernels"):
                build.load()  # build the kernels now, or raise with nvcc's output
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' asked for, but "
                                   "torch.cuda.is_available() is False")
        # bounded iteration budgets: 25 restart cycles / 1000 CG steps
        # is far beyond any converging configuration
        if inv_itmax == 0:
            inv_itmax = 25 * inv_memory
        if evo_itmax == 0:
            evo_itmax = 1000
        self.inv_opts = dict(atol=inv_atol, rtol=inv_rtol, itmax=inv_itmax, m=inv_memory)
        self.evo_opts = dict(atol=evo_atol, rtol=evo_rtol, itmax=evo_itmax)
        self.precond_kind = preconditioner
        self.cond_ratio = cond_ratio
        self.triangular = triangular
        self.twogrid = twogrid
        self.coarse_dense_max = coarse_dense_max
        # u-block two-grid: below this size the coarse problem is solved
        # by a dense inverse, above it by inner CG on the element-local
        # P1 operator
        self.coarse_dense = 3 * fe.mesh.n_vertices <= coarse_dense_max
        # geostrophic (full-saddle P1-P1) coarse correction, default on:
        # small meshes use a precomputed dense coarse inverse, large ones
        # the element-local coarse operator with an aggregate level
        if saddle_coarse is None:
            saddle_coarse = True
        self.saddle_coarse = saddle_coarse
        self.saddle_coarse_dense = 4 * fe.mesh.n_vertices <= coarse_dense_max
        if saddle_coarse_l2 is None:
            saddle_coarse_l2 = True
        self.saddle_coarse_l2 = (saddle_coarse_l2 and self.saddle_coarse
                                 and not self.saddle_coarse_dense)
        self.saddle_coarse_delta = 1.0
        if self.saddle_coarse:
            self.twogrid = False
        if inner_method is None:
            # rotation-dominance at grid scale: Coriolis vs viscous
            # stiffness, f h^2 / (a2e2 nu).  Beyond ~10 the SPD
            # Chebyshev surrogate cannot damp the rotational fine modes
            # and the full-block inner GMRES smoother takes over.
            xq = fe.geom.xq[: min(len(fe.geom.xq), 4096)]
            f_med = float(np.median(np.abs(_quad_eval(params.f, xq))))
            nu_med = float(np.median(np.abs(_quad_eval(forcings.nu, xq))))
            rot = f_med * fe.h_median ** 2 / (params.a2e2 * max(nu_med, 1e-300))
            inner_method = (
                "inner_gmres" if (self.saddle_coarse and rot > 10.0) else "chebyshev"
            )
        self.inner_method = inner_method
        if saddle_coarse_inner is None:
            # with the aggregate second level the coarse cycle is
            # applied directly (k = 0, no inner Krylov); the
            # rotation-dominated regime keeps a moderate budget
            if self.saddle_coarse_l2:
                saddle_coarse_inner = 8 if self.inner_method == "inner_gmres" else 0
            else:
                saddle_coarse_inner = 40 if self.inner_method == "inner_gmres" else 16
        self.saddle_coarse_inner = saddle_coarse_inner
        if inner_iters_u is None:
            # 2 (saddle V-cycle) / 4 (u-block two-grid) pre+post
            # Chebyshev steps next to a coarse solve
            if self.inner_method == "inner_gmres":
                inner_iters_u = 6
            else:
                inner_iters_u = 2 if self.saddle_coarse else 4 if self.twogrid else 10
        self.inner_iters = (inner_iters_u, inner_iters_p)
        self.assembly_chunk = assembly_chunk
        self.matmul_precision = matmul_precision
        self.refresh_on_rebuild = refresh_on_rebuild
        self._graphed = None  # (what it read, the captured preconditioner)

        self._build_s = {}
        with precision_ctx(matmul_precision):
            with build_span("constants", self._build_s, self._sync):
                self._build_constants()
            with build_span("operators", self._build_s, self._sync):
                self._build_operators()

    @property
    def build_seconds(self):
        """Seconds of this model's build spans (``utils/timing.build_span``,
        recorded as ``build.<key>`` too), read-only: "constants" (within
        them the assembled operators' patterns, "patterns"), "operators"
        (within them the coarse saddle matrix's assembly and inverse,
        "saddle_coarse" or "aggregate_level", which a refresh records
        again, and within the latter the host aggregation of the mesh's
        vertices, "aggregation").  On a CUDA model each span but the host
        aggregation opens and closes with a device synchronise, so it
        covers the device work."""
        return types.MappingProxyType(self._build_s)

    @property
    def preconditioner_branch(self) -> str:
        """Which coarse path the inversion preconditioner takes."""
        if self.precond_kind == "diag":
            return "diagonal"
        if self.twogrid:
            return ("u-block two-grid, dense coarse" if self.coarse_dense
                    else "u-block two-grid, element coarse + CG")
        if not self.saddle_coarse:
            return "block Stokes, no coarse level"
        if self.saddle_coarse_dense:
            return "dense saddle coarse"
        return ("iterative saddle coarse + L2 aggregate level"
                if self.saddle_coarse_l2 else "iterative saddle coarse")

    @property
    def ops(self) -> dict:
        """The operator dict the entry points run on."""
        return self._ops

    @ops.setter
    def ops(self, ops: dict):
        # the held operators follow the dict's tensors (a dict set from
        # outside, a refresh's result, values restored into its tensors),
        # and the inversion is built once for them
        self._ops = ops
        self._refill(ops)
        self._hold_inversion()

    def _refill(self, ops: dict, keys=None):
        """Refill what the model holds from ``ops``' tensors, from those
        of ``keys`` or all, in place: the assembled operators of
        ``self._held`` (one per element tensor) and, from the four coarse
        saddle blocks, ``self._sc_op``."""
        for k, op in self._held.items():
            if k in ops and (keys is None or k in keys):
                op.fill(ops[k])
        sc = ("sc_uu", "sc_up", "sc_pu", "sc_pp")
        if (getattr(self, "_sc_op", None) is not None and all(k in ops for k in sc)
                and (keys is None or any(k in keys for k in sc))):
            self._sc_op.fill(*(ops[k] for k in sc))

    def _put(self, ops: dict, **values):
        """Write ``values`` into ``ops``, each into the tensor ``ops``
        holds at its key where shape, dtype and device agree (a held or
        captured operator reads it by address; a value that already is
        that tensor, written through ``_chunked_cells(out=...)``, is
        left as it is), else set there; then refill what the model holds
        from those keys.  After the build, the only way the model writes
        ``ops``."""
        for k, v in values.items():
            old = ops.get(k)
            if old is v:
                continue
            if (torch.is_tensor(old) and old.shape == v.shape and old.dtype == v.dtype
                    and old.device == v.device):
                old.copy_(v)
            else:
                ops[k] = v
        self._refill(ops, values)

    def _sync(self):
        """Wait for the work queued on a CUDA model's device (so that the
        host clock reads it)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # static tables (host NumPy -> device tensors, once)
    # ------------------------------------------------------------------
    def _T(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _I(self, a) -> torch.Tensor:
        """int32 dof table for the kernels."""
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                               device=self.device)

    def _build_constants(self):
        fe, T = self.fe, self._T
        sp = fe.spaces
        c = {}
        c["wq"] = T(fe.geom.wq)
        c["invJT"] = T(fe.geom.invJT)
        c["embed"] = T(fe.embed)
        c["phi_u"] = T(fe.tab_u.phi)
        c["dphi_u"] = T(fe.tab_u.dphi)
        c["phi_p"] = T(fe.tab_p.phi)
        c["dphi_p"] = T(fe.tab_p.dphi)
        c["phi_b"] = T(fe.tab_b.phi)
        c["dphi_b"] = T(fe.tab_b.dphi)
        c["cd_u"] = self._I(fe.cd_u)
        c["cd_p"] = self._I(fe.cd_p)
        c["cd_b"] = self._I(fe.cd_b)
        c["cd_none"] = self._I(np.zeros((fe.n_cells_padded, 0)))
        # block tables of the element-matvec kernel (ops/blocks.py), one
        # per operator family; the per-step operators reuse them
        item = torch.empty((), dtype=self.dtype).element_size()
        c["blk_fine"] = blocks.operator_tables(fe.cd_u, fe.cd_p, ("full", "uu"), item,
                                               self.device)
        # assembled operators (ops/assembled.py), one per element tensor
        # of ``ops``: the pattern once per mesh, the blocks refilled from
        # the tensors wherever they are written (``_put``).  On the
        # vertex pattern the P1 pressure mass (every preconditioner),
        # the P1 vector velocity operators of the coarse level (the
        # iterative saddle coarse level's uu block and visc surrogate,
        # or the two-grid's element coarse level) and the iterative
        # saddle coarse operator; the P2-P1 pressure coupling of the
        # block-triangular preconditioner on P2 nodes x vertices.
        # Each is named after its tensor ("sc" the coarse saddle).
        with build_span("patterns", self._build_s, self._sync):
            c["vblk_coarse"] = vertex_pattern(c["cd_p"], sp.p_space.ndof)
            self._held = {"Mp_e": AssembledBlocks(c["vblk_coarse"], "scalar", self.dtype,
                                                  c["cd_p"], name="Mp_e")}
            iterative_sc = self.saddle_coarse and not self.saddle_coarse_dense
            if iterative_sc or (self.twogrid and not self.coarse_dense):
                for k in ("sc_uu", "sc_visc_e") if iterative_sc else ("coarse_e",):
                    self._held[k] = AssembledBlocks(c["vblk_coarse"], "uu", self.dtype,
                                                    c["cd_p"], name=k)
            if iterative_sc:
                self._sc_op = AssembledSaddle(c["vblk_coarse"], c["cd_p"], self.dtype,
                                              name="sc")
            if self.triangular and self.precond_kind != "diag":
                c["vblk_up"] = vertex_pattern(c["cd_u"], sp.u_space.ndof, c["cd_p"], sp.n_p)
                self._held["A_up_e"] = AssembledBlocks(c["vblk_up"], "up", self.dtype,
                                                       name="A_up_e")
        c["blk_b"] = blocks.scalar_table(fe.cd_b, item, self.device)
        c["h_cells"] = T(fe.h_cells)
        c["Gb3"] = asm.physical_grads(c["invJT"], c["dphi_b"], c["embed"])
        if self.saddle_coarse:
            h = np.asarray(fe.h_cells, np.float64)
            h2 = np.where(h > 1e9, 0.0, h) ** 2  # zero the pad sentinels
            c["sc_h2"] = T(h2)
            # float64 geometry of the coarse saddle matrices (the dense
            # coarse level, the aggregate level, the pin weights): an
            # f64 model's own tensors, else float64 copies of the host's
            geo = ("wq", "invJT", "embed", "phi_p", "dphi_p", "sc_h2")
            if self.dtype == torch.float64:
                c["sc64"] = {k: c[k] for k in geo}
            else:
                D = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                              device=self.device)
                c["sc64"] = dict(zip(geo, map(D, (fe.geom.wq, fe.geom.invJT, fe.embed,
                                                  fe.tab_p.phi, fe.tab_p.dphi, h2))))

        # coefficients at volume quadrature points (host eval, static)
        xq = fe.geom.xq
        fr, pr = self.forcings, self.params
        c["f_q"] = T(_quad_eval(pr.f, xq))
        c["nu_q"] = T(_quad_eval(fr.nu, xq))
        c["kh_q"] = T(_quad_eval(fr.kappa_h, xq))
        c["kv_q"] = T(_quad_eval(fr.kappa_v, xq))
        self.variable_nu = callable(fr.nu) or fr.eddy_param.is_on
        # eddy parameterization f at quad points
        if fr.eddy_param.is_on:
            c["f_eddy_q"] = T(_quad_eval(fr.eddy_param.f, xq))

        # surface group
        surf = fe.surface
        c["wq_surf"] = T(surf.geom.wq)
        c["phi_u_surf"] = T(surf.phi_u)
        c["phi_b_surf"] = T(surf.phi_b)
        c["taux_q"] = T(_quad_eval(fr.tau_x, surf.geom.xq))
        c["tauy_q"] = T(_quad_eval(fr.tau_y, surf.geom.xq))

        # Dirichlet masks; periodic slave dofs are inactive -> pinned 0
        u_bc, b_bc = sp.u_bc, sp.b_bc
        act_u = sp.u_space.active[:, None]
        free_u = ((~u_bc.mask) & act_u).reshape(-1).astype(np.float64)
        udiri = (u_bc.values * act_u).reshape(-1)
        free_p = sp.p_space.active.astype(np.float64)
        c["free_u"] = T(free_u)
        c["free_b"] = T((~b_bc.mask) & sp.b_space.active)
        c["bdiri"] = T(b_bc.values * sp.b_space.active)
        # combined inversion mask: velocity masks + active pressure
        c["free_inv"] = T(np.concatenate([free_u, free_p]))
        c["xdiri_inv"] = T(np.concatenate([udiri, np.zeros(sp.n_p)]))

        # coarse prolongation: P1 vertex space (pressure numbering) ->
        # P2 velocity nodes.  P2 nodes are vertices then edge midpoints,
        # so the exact inclusion P1 c P2 interpolates: vertex node =
        # coarse value, midpoint = mean of the edge endpoints.
        us, ps, mesh = sp.u_space, sp.p_space, fe.mesh
        nv = mesh.n_vertices
        orig_u = us._perm if hasattr(us, "_perm") else np.arange(us.ndof)
        is_vert = orig_u < nv
        edge_ids = np.clip(orig_u - nv, 0, max(mesh.n_edges - 1, 0))
        epar = mesh.edges[edge_ids] if mesh.n_edges else np.zeros((us.ndof, 2), np.int64)
        parents_orig = np.where(
            is_vert[:, None], np.stack([orig_u, orig_u], axis=1), epar
        )
        c["tg_parents"] = torch.as_tensor(
            ps.map_ids(ps._dof_map_orig[parents_orig]), dtype=torch.int64,
            device=self.device)
        c["tg_weights"] = T(np.where(
            is_vert[:, None], np.array([1.0, 0.0]), np.array([0.5, 0.5])))
        # coarse Dirichlet mask: vertex dof pinned iff the matching fine
        # vertex dof is pinned/inactive (periodic masters only)
        u_free2d = (~u_bc.mask) & act_u
        vids = np.arange(nv)
        own = ps._dof_map_orig[vids] == vids
        u_cur = us.map_ids(us._dof_map_orig[vids[own]])
        p_cur = ps.map_ids(vids[own])
        cf = np.zeros((ps.ndof, 3), dtype=bool)
        cf[p_cur] = u_free2d[u_cur]
        c["tg_coarse_free"] = T(cf.reshape(-1))
        self.const = c

    # ------------------------------------------------------------------
    # operator assembly (device, once at setup)
    # ------------------------------------------------------------------
    def _chunked_cells(self, fn, *cell_arrays, out=None):
        """Apply an element-tensor function to chunks of at most
        ``assembly_chunk`` cells (bounds transient memory).

        ``out`` (a tensor, or a tuple matching ``fn``'s results): write
        each chunk into these existing tensors instead of concatenating
        new ones -- the closures' rebuilds use it, so peak memory holds
        one copy of each element tensor plus one chunk."""
        nc = cell_arrays[0].shape[0]
        step = self.assembly_chunk
        if out is not None:
            dst = out if isinstance(out, tuple) else (out,)
            for s in range(0, nc, step):
                res = fn(*[a[s:s + step] for a in cell_arrays])
                for o, v in zip(dst, res if isinstance(res, tuple) else (res,)):
                    o[s:s + step] = v
            return out
        outs = [fn(*[a[s:s + step] for a in cell_arrays]) for s in range(0, nc, step)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def _assemble_inversion_elems(self, nu_q, out=None):
        """Element tensors of the saddle operator -- kept element-local
        (never scattered to a sparse matrix); into ``out`` when given."""
        c = self.const
        a2e2 = self.params.a2e2

        def build_(wq, nu_q, f_q, invJT):
            Gu3 = asm.physical_grads(invJT, c["dphi_u"], c["embed"])
            return asm.elem_inversion_blocks(
                wq, nu_q, f_q, c["phi_u"], Gu3, c["phi_p"], a2e2, self.variable_nu)

        return self._chunked_cells(build_, c["wq"], nu_q, c["f_q"], c["invJT"], out=out)

    def _visc_elems(self, wq, nu_q, f_q, G3, phi):
        """SPD velocity-block surrogate: viscous + |f| mass, per
        component (the inner Chebyshev smoothing operator)."""
        eye3 = torch.eye(3, dtype=self.dtype, device=self.device)
        lap = torch.einsum("cq,cq,cqid,cqjd->cji", wq, nu_q, G3, G3)
        mf = torch.einsum("cq,cq,qj,qi->cji", wq, torch.abs(f_q), phi, phi)
        elem = torch.einsum("cji,ba->cjbia", self.params.a2e2 * lap + mf, eye3)
        nl = phi.shape[1]
        return elem.reshape(wq.shape[0], 3 * nl, 3 * nl)

    def _assemble_visc_elems(self, nu_q, out=None):
        c = self.const

        def build_(wq, nu_q, f_q, invJT):
            Gu3 = asm.physical_grads(invJT, c["dphi_u"], c["embed"])
            return self._visc_elems(wq, nu_q, f_q, Gu3, c["phi_u"])

        return self._chunked_cells(build_, c["wq"], nu_q, c["f_q"], c["invJT"], out=out)

    def _assemble_smoother(self, ops, nu_q):
        """The velocity smoother's surrogate ``visc_e`` from the viscosity
        ``nu_q`` (quadrature points), with its Jacobi diagonal and
        spectral bound, into ``ops``."""
        self._put(ops, visc_e=self._assemble_visc_elems(nu_q, out=ops.get("visc_e")))
        visc_op = MaskedOperator(self._visc_operator(ops["visc_e"]), self.const["free_u"])
        self._put(ops, visc_dinv=1.0 / visc_op.diagonal())
        self._put(ops, lmax_u=power_lmax(visc_op, ops["visc_dinv"], self.fe.spaces.n_u))

    def _assemble_coarse(self, ops, nu_q=None):
        """Two-grid u-block coarse level: the P1-vertex (Galerkin)
        coarse viscous operator.  Because P1 c P2 is a nested inclusion,
        rediscretizing the same bilinear form with P1 elements IS the
        Galerkin coarse operator P^T A P.

        Small meshes (3 n_vert <= coarse_dense_max): the masked operator
        assembled dense and inverted on the device by a float64 Cholesky
        factorisation, cast to the model's dtype (``coarse_inv``).  Large
        meshes: element tensors (``coarse_e``) for an inner-CG coarse
        solve, with their Jacobi diagonal (``coarse_dinv``).

        ``nu_q`` (volume quadrature points; default the build-time
        ``c["nu_q"]``) lets ``refresh_precond`` rebuild the coarse level
        from the current eddy viscosity."""
        c = self.const
        nu_q = c["nu_q"] if nu_q is None else nu_q

        def build_(wq, nu_q, f_q, invJT):
            Gp3 = asm.physical_grads(invJT, c["dphi_p"], c["embed"])
            return self._visc_elems(wq, nu_q, f_q, Gp3, c["phi_p"])

        if not self.coarse_dense:
            self._put(ops, coarse_e=self._chunked_cells(build_, c["wq"], nu_q, c["f_q"],
                                                        c["invJT"], out=ops.get("coarse_e")))
            cop = MaskedOperator(self._coarse_operator("coarse_e"), c["tg_coarse_free"])
            self._put(ops, coarse_dinv=1.0 / cop.diagonal())
            return

        elem = self._chunked_cells(build_, c["wq"], nu_q, c["f_q"], c["invJT"])
        nlp = c["phi_p"].shape[1]
        Nc = 3 * self.fe.spaces.p_space.ndof
        cd_p = c["cd_p"].long()
        idx = (3 * cd_p[:, :, None] + torch.arange(3, device=self.device)).reshape(-1, 3 * nlp)
        rows = idx[:, :, None].expand(-1, -1, 3 * nlp)
        cols = idx[:, None, :].expand(-1, 3 * nlp, -1)
        lin = (rows * Nc + cols).reshape(-1)
        A = torch.zeros(Nc * Nc, dtype=torch.float64, device=self.device)
        A.index_add_(0, lin, elem.reshape(-1).to(torch.float64))
        A = A.reshape(Nc, Nc)
        free = c["tg_coarse_free"].to(torch.float64)
        A = free[:, None] * A * free[None, :] + torch.diag(1.0 - free)
        self._put(ops, coarse_inv=torch.cholesky_inverse(torch.linalg.cholesky(A)).to(self.dtype))

    def _assemble_saddle_coarse(self, ops, nu_q=None):
        """P1-P1 COARSE SADDLE system (velocity AND pressure) -- the
        geostrophic coarse solve for the rotation-dominated
        (small-Ekman) regime.

        Same forms as the fine system but with P1 velocity (exact
        Galerkin restriction by nestedness); equal-order P1-P1 is not
        inf-sup stable, so the pp block gets Brezzi-Pitkaranta
        stabilization  +delta sum_c h_c^2 (grad p, grad q)  which also
        removes the spurious-mode singularity.  Small meshes
        (4 n_vert <= coarse_dense_max): a dense inverse, assembled and
        inverted in float64 on the model's device.  Larger meshes:
        element-local coarse blocks, solved per application by the
        aggregate-level cycle or an inner FGMRES.

        ``nu_q`` (volume quadrature points; default the build-time
        ``c["nu_q"]``) lets ``refresh_precond`` rebuild the coarse
        level from the current eddy viscosity.
        """
        if self.saddle_coarse_dense:
            with build_span("saddle_coarse", self._build_s, self._sync):
                self._put(ops, saddle_coarse_inv=self._coarse_inverse(
                    self._saddle_coarse_matrix(nu_q)).to(self.dtype))
        else:
            self._assemble_saddle_coarse_elems(ops, nu_q)

    def _sc_elem_blocks(self, g, wq, nu_q, f_q, invJT, h2):
        """Element blocks (uu, up, pu, pp) of the BP-stabilized P1-P1
        coarse saddle operator on a chunk of cells, in the chunk's
        dtype, and its P1 gradients.  ``g`` holds the P1 tables
        (``phi_p``, ``dphi_p``) and ``embed`` in that dtype.

        Sign of the stabilization: with up = -B^T, pu = +B the pressure
        Schur complement is +B A^{-1} B^T + pp, so pp must be POSITIVE
        definite (+delta h^2 grad-grad)."""
        Gp3 = asm.physical_grads(invJT, g["dphi_p"], g["embed"])
        uu, up, pu = asm.elem_inversion_blocks(
            wq, nu_q, f_q, g["phi_p"], Gp3, g["phi_p"], self.params.a2e2, self.variable_nu)
        gg = torch.einsum("cq,cqid,cqjd->cij", wq, Gp3, Gp3)
        return uu, up, pu, self.saddle_coarse_delta * h2[:, None, None] * gg, Gp3

    def _assemble_saddle_coarse_elems(self, ops, nu_q=None):
        """Element tensors of the BP-stabilized P1-P1 coarse saddle
        operator + the coarse visc smoothing surrogate (the scalable
        coarse path), with the pin, the surrogate's Jacobi diagonal and
        spectral bound, and the aggregate level.  A refresh rebuilds
        them into the tensors ``ops`` already holds."""
        c = self.const
        nu_q = c["nu_q"] if nu_q is None else nu_q

        def build_(wq, nu_q, f_q, invJT, h2):
            uu, up, pu, pp, Gp3 = self._sc_elem_blocks(c, wq, nu_q, f_q, invJT, h2)
            return uu, up, pu, pp, self._visc_elems(wq, nu_q, f_q, Gp3, c["phi_p"])

        keys = ("sc_uu", "sc_up", "sc_pu", "sc_pp", "sc_visc_e")
        out = tuple(ops[k] for k in keys) if all(k in ops for k in keys) else None
        self._put(ops, **dict(zip(keys, self._chunked_cells(
            build_, c["wq"], nu_q, c["f_q"], c["invJT"], c["sc_h2"], out=out))))

        # rank-one constant-pressure pin (free-masked volume weights) +
        # spectral bound of the smoothing surrogate (for Chebyshev)
        nv = self.fe.spaces.p_space.ndof
        pw = self._sc_pin_weights() * c["free_inv"][self.fe.spaces.n_u:].to(torch.float64)
        self._put(ops, sc_pin=torch.cat([pw.new_zeros(3 * nv),
                                         pw / torch.linalg.vector_norm(pw)]).to(self.dtype))
        cmask = MaskedOperator(self._sc_op, self._coarse_free())
        self._put(ops, sc_sigma=torch.mean(torch.abs(cmask.diagonal())))
        cvisc = MaskedOperator(self._coarse_operator("sc_visc_e"), c["tg_coarse_free"])
        self._put(ops, sc_visc_dinv=1.0 / cvisc.diagonal())
        self._put(ops, sc_lmax=power_lmax(cvisc, ops["sc_visc_dinv"], 3 * nv))

        if self.saddle_coarse_l2:
            self._assemble_saddle_coarse_l2(ops, nu_q)

    def _coarse_free(self):
        """Free mask of the coarse (3nv velocity, nv pressure) level."""
        c = self.const
        return torch.cat([c["tg_coarse_free"], c["free_inv"][self.fe.spaces.n_u:]])

    def _assemble_saddle_coarse_l2(self, ops, nu_q=None):
        """Second (aggregate) coarse level for the iterative coarse
        path: ``_aggregate_matrix`` inverted once in float64 on the
        model's device and cast to the working dtype."""
        with build_span("aggregate_level", self._build_s, self._sync):
            self._put(ops, sc2_inv=self._coarse_inverse(
                self._aggregate_matrix(ops, nu_q)).to(self.dtype), sc2_agg=self._sc2_tables()[0])

    def _sc2_tables(self):
        """(agg, n_agg, dofmap) of the aggregate level, built once per
        mesh on the host and kept on the model's device: vertices
        clustered into contiguous aggregates by a capped BFS (in the RCM
        vertex order, so aggregates are band-compact), and the coarse
        dof -> aggregate dof map (3nv u then nv p -> 3*aggregate +
        component, then 3na + aggregate).  ``refresh_precond`` reuses
        them."""
        if not hasattr(self, "_sc2_cache"):
            with build_span("aggregation", self._build_s):
                fe = self.fe
                agg, na = _aggregate_vertices(
                    np.asarray(fe.cd_p[: fe.mesh.n_cells], np.int64), fe.spaces.p_space.ndof,
                    max(1, self.coarse_dense_max // 4))
                dofmap = np.concatenate([(3 * agg[:, None] + np.arange(3)).reshape(-1),
                                         3 * na + agg])
                as_dev = lambda a: torch.as_tensor(a, dtype=torch.int64, device=self.device)
                self._sc2_cache = (as_dev(agg), na, as_dev(dofmap))
        return self._sc2_cache

    def _saddle_coarse_solver(self, ops, mp_op):
        """Coarse solve of the iterative path: the coarse-level
        block-triangular Stokes preconditioner (Chebyshev on the P1
        visc surrogate + Mp) followed by the aggregate level, applied
        once (k = 0) or as the preconditioner of a k-step inner FGMRES
        on the masked + pressure-pinned coarse saddle operator.  The
        outer FGMRES is flexible, so an approximate coarse solve is
        admissible."""
        c = self.const
        nv = self.fe.spaces.p_space.ndof
        free_c = self._coarse_free()
        cop = self._sc_op
        cmask = MaskedOperator(cop, free_c)
        w = ops["sc_pin"]
        sigma = ops["sc_sigma"]

        def cmat(x):
            return cmask(x) + sigma * w * torch.dot(w, x)

        tg_free = c["tg_coarse_free"]
        cvisc = MaskedOperator(self._coarse_operator("sc_visc_e"), tg_free)
        # the coarse level inherits the fine regime: rotation-dominated
        # runs smooth the full (nonsymmetric) coarse uu block
        cuu = MaskedOperator(self._coarse_operator("sc_uu"), tg_free)
        Mc = BlockStokesPrecond(
            visc_op=cvisc,
            visc_diag_inv=ops["sc_visc_dinv"],
            mp_op=mp_op,
            mp_diag_inv=ops["mp_dinv"],
            nu_dofs=3 * nv,
            inner_iters_u=6 if self.inner_method == "inner_gmres" else 3,
            inner_iters_p=3,
            method=self.inner_method,
            lmax_u=read(ops["sc_lmax"], "precond.bound", "float"),
            lmax_p=read(ops["lmax_p"], "precond.bound", "float"),
            cond_ratio=self.cond_ratio,
            ublock_op=cuu,
            up_coupling=lambda zp: tg_free * cop.up_matvec(zp),
            name="precond.coarse_block",
        )
        M_in = Mc
        if "sc2_inv" in ops:
            sc2 = AggregateCoarseCorrection(
                inv=ops["sc2_inv"], agg=ops["sc2_agg"].long(),
                n_agg=ops["sc2_inv"].shape[0] // 4, free_c=free_c)
            M_in = lambda r_: sc2(cmat, r_, Mc(r_))
        k = self.saddle_coarse_inner
        if k <= 0:
            return M_in

        def solve(rc):
            zc, _ = gmres(cmat, rc, torch.zeros_like(rc), M=M_in,
                          flexible=True, m=k, itmax=k, atol=0.0, rtol=1e-2, name="coarse.gmres")
            return zc

        return solve

    # ------------------------------------------------------------------
    # the coarse saddle matrices (float64, on the model's device)
    # ------------------------------------------------------------------
    def _sc_blocks64(self, nu_q=None, cells=slice(None)):
        """float64 element blocks (uu, up, pu, stab) of the coarse
        saddle on ``cells``, from the float64 geometry ``const["sc64"]``
        (never from the model's own, float32 in an f32 model: the
        BP-stabilized saddle matrix is too ill-conditioned for float32;
        only its inverse is cast to the working dtype).  ``nu_q`` and
        ``f_q`` are upcast from the model's dtype."""
        c = self.const
        g = c["sc64"]
        nu_q = c["nu_q"] if nu_q is None else nu_q
        f64 = torch.float64
        return self._sc_elem_blocks(g, g["wq"][cells], nu_q[cells].to(f64),
                                    c["f_q"][cells].to(f64), g["invJT"][cells],
                                    g["sc_h2"][cells])[:4]

    def _sc_pin_weights(self) -> torch.Tensor:
        """float64 volume weights int phi_k of the P1 coarse pressure
        dofs (the constant-pressure pin), on the model's device."""
        c = self.const
        g = c["sc64"]
        pv = torch.einsum("cq,qk->ck", g["wq"], g["phi_p"])
        return pv.new_zeros(self.fe.spaces.p_space.ndof).index_add_(
            0, c["cd_p"].reshape(-1).long(), pv.reshape(-1))

    def _sc_scatter(self, nu_q, dofmap, N) -> torch.Tensor:
        """sum_e of the free-masked float64 coarse element blocks into a
        dense (N, N) float64 matrix, coarse dof i -> matrix dof
        ``dofmap[i]``: P^T F A F P, F the coarse free mask.  The element
        blocks are built and scattered (``index_add_``) chunk by chunk
        of ``assembly_chunk`` cells; the global coarse matrix is never
        formed where ``dofmap`` aggregates."""
        c = self.const
        nv = self.fe.spaces.p_space.ndof
        free = self._coarse_free().to(torch.float64)
        cd = c["cd_p"].long()
        idx_u = (3 * cd[:, :, None] + torch.arange(3, device=self.device)).reshape(cd.shape[0], -1)
        idx_p = 3 * nv + cd
        A = torch.zeros(N * N, dtype=torch.float64, device=self.device)
        step = self.assembly_chunk
        for s in range(0, cd.shape[0], step):
            iu, ip = idx_u[s:s + step], idx_p[s:s + step]
            blocks = self._sc_blocks64(nu_q, slice(s, s + step))
            for (rows, cols), v in zip(((iu, iu), (iu, ip), (ip, iu), (ip, ip)), blocks):
                v = v * free[rows][:, :, None] * free[cols][:, None, :]
                lin = dofmap[rows][:, :, None] * N + dofmap[cols][:, None, :]
                A.index_add_(0, lin.reshape(-1), v.reshape(-1))
        return A.view(N, N)

    def _saddle_coarse_matrix(self, nu_q=None) -> torch.Tensor:
        """The dense coarse level's float64 matrix (4nv, 4nv): the
        masked coarse saddle, the identity on pinned dofs, and the
        rank-one pin sigma w w^T of the constant-pressure mode (its
        only nullspace; w the volume weights, sigma the mean |diagonal|;
        the outer solve projects constants away regardless)."""
        nv = self.fe.spaces.p_space.ndof
        N = 4 * nv
        A = self._sc_scatter(nu_q, torch.arange(N, device=self.device), N)
        A.diagonal().add_(1.0 - self._coarse_free().to(torch.float64))
        pv = self._sc_pin_weights()
        w = torch.cat([pv.new_zeros(3 * nv), pv])
        w = w / torch.linalg.vector_norm(w)
        return A.addr_(A.diagonal().abs().mean() * w, w)

    def _aggregate_matrix(self, ops, nu_q=None) -> torch.Tensor:
        """The aggregate level's float64 matrix (4na, 4na): the masked +
        pinned coarse saddle matrix Galerkin-projected onto the
        piecewise-constant aggregate basis (``_sc2_tables``).  The
        pinned dofs' identity projects to P^T (I-F) P, which keeps
        aggregates wholly inside the Dirichlet boundary nonsingular; the
        pin is ``ops["sc_pin"]``'s, sigma w w^T with free-masked
        weights, projected as well."""
        nv = self.fe.spaces.p_space.ndof
        _, na, dofmap = self._sc2_tables()
        N2 = 4 * na
        free = self._coarse_free().to(torch.float64)
        A2 = self._sc_scatter(nu_q, dofmap, N2)
        A2.diagonal().add_(free.new_zeros(N2).index_add_(0, dofmap, 1.0 - free))
        pv = self._sc_pin_weights() * free[3 * nv:]
        w = torch.cat([pv.new_zeros(3 * nv), pv])
        w = w / torch.linalg.vector_norm(w)
        wc = w.new_zeros(N2).index_add_(0, dofmap, w)
        return A2.addr_(ops["sc_sigma"].to(torch.float64) * wc, wc)

    @staticmethod
    def _coarse_inverse(A) -> torch.Tensor:
        """Inverse of a coarse matrix in its dtype and on its device, by
        LU with partial pivoting (the Coriolis skew makes it
        nonsymmetric); a singular matrix raises."""
        inv, info = torch.linalg.inv_ex(A)
        info = read(info, "coarse.info", "int")
        if info:
            raise torch.linalg.LinAlgError(
                f"coarse saddle matrix of order {A.shape[0]} is singular: "
                f"U[{info - 1}, {info - 1}] of its LU is zero")
        return inv

    def _coarse_operator(self, key: str) -> AssembledBlocks:
        """The held vector-P1 operator over vertex nodes (layout
        3*vertex+comp, as the coarse correction vectors) of the element
        tensor ``ops[key]`` ("sc_uu", "sc_visc_e" or "coarse_e"), filled
        from the tensor's last write."""
        return self._held[key]

    def _build_operators(self):
        fe, c = self.fe, self.const
        pr, fr = self.params, self.forcings
        sp = fe.spaces
        ops = {}
        ops["A_uu_e"], ops["A_up_e"], ops["A_pu_e"] = (
            self._assemble_inversion_elems(c["nu_q"]))
        self._assemble_smoother(ops, c["nu_q"])

        def build_small(wq, kh_q, kv_q, Gb3):
            return (
                asm.elem_buoyancy_to_velocity(wq, c["phi_u"], c["phi_b"], 1.0 / pr.alpha),
                asm.elem_mass(wq, c["phi_b"], c["phi_b"]),
                asm.elem_stiffness(wq, kh_q, Gb3, (0, 1)),
                asm.elem_stiffness(wq, kv_q, Gb3, (2,)),
                asm.elem_rhs_diff(wq, kv_q, Gb3, pr.N2),
                asm.elem_mass(wq, c["phi_p"], c["phi_p"]) / pr.a2e2,
                torch.einsum("cq,qk->ck", wq, c["phi_p"]),
            )

        (ops["B_e"], ops["M_e"], ops["Kh_e"], ops["Kv_e"], rd_e,
         Mp_e, pv_e) = self._chunked_cells(
            build_small, c["wq"], c["kh_q"], c["kv_q"], c["Gb3"])
        self._put(ops, Mp_e=Mp_e)

        # wind-stress rhs over the combined (u, p) vector
        wind = asm.elem_wind_rhs(c["wq_surf"], c["taux_q"], c["tauy_q"],
                                 c["phi_u_surf"], pr.alpha)
        s_u = fe.vec_plan_u_surf.assemble(wind)
        ops["s"] = torch.cat([s_u, s_u.new_zeros(sp.n_p)])
        ops["rhs_diff"] = fe.vec_plan_b.assemble(rd_e)
        # pressure volume weights for the zero-mean constraint
        ops["p_volw"] = fe.vec_plan_p.assemble(pv_e)

        # the pressure mass's diagonal and spectral bound (Mp never
        # changes; the smoother's are rebuilt with the viscosity)
        mp_op = MaskedOperator(self._mp_operator(), c["free_inv"][sp.n_u:])
        ops["mp_dinv"] = 1.0 / mp_op.diagonal()
        ops["lmax_p"] = power_lmax(mp_op, ops["mp_dinv"], sp.n_p)

        if self.twogrid:
            self._assemble_coarse(ops)
        if self.saddle_coarse:
            self._assemble_saddle_coarse(ops)

        # surface buoyancy-flux rhs (static; zero under Dirichlet BC)
        if isinstance(fr.b_surface_bc, SurfaceFluxBC):
            flux_q = self._T(_quad_eval(fr.b_surface_bc.flux, fe.surface.geom.xq))
            ops["rhs_flux"] = fe.vec_plan_b_surf.assemble(
                asm.elem_flux_rhs(c["wq_surf"], flux_q, c["phi_b_surf"], pr.alpha))
        else:
            ops["rhs_flux"] = c["wq"].new_zeros(sp.n_b)
        self.ops = ops

    # ------------------------------------------------------------------
    # step functions
    # ------------------------------------------------------------------
    def _inv_matrix(self, ops) -> SaddleOperator:
        c, sp = self.const, self.fe.spaces
        return SaddleOperator(uu=ops["A_uu_e"], up=ops["A_up_e"], pu=ops["A_pu_e"],
                              cd_u=c["cd_u"], cd_p=c["cd_p"],
                              n_u_nodes=sp.u_space.ndof, n_p=sp.n_p, tables=c["blk_fine"],
                              name="inversion")

    def _visc_operator(self, visc_e, name="visc") -> SaddleOperator:
        """The velocity block of ``visc_e`` (the smoother's surrogate,
        "visc", or the full block ``A_uu_e``, "ublock")."""
        c = self.const
        return SaddleOperator(uu=visc_e, up=None, pu=None, cd_u=c["cd_u"],
                              cd_p=c["cd_none"],
                              n_u_nodes=self.fe.spaces.u_space.ndof,
                              tables=c["blk_fine"], name=name)

    def _b_matvec(self, ops, b_full):
        """B b: buoyancy -> vertical momentum rows of the combined
        vector (node-grouped velocity scatter)."""
        fe = self.fe
        ye = torch.einsum("cij,cj->ci", ops["B_e"], b_full[self.const["cd_b"]])
        yu = fe.vec_plan_u_nodes.assemble_rows(ye.reshape(-1, 3)).reshape(-1)
        return torch.cat([yu, yu.new_zeros(fe.spaces.n_p)])

    def _evo_matrix(self, ops, theta, Kv_e=None) -> ElementOperator:
        Kv_e = ops["Kv_e"] if Kv_e is None else Kv_e
        return ElementOperator(Ae=ops["M_e"] + theta * (ops["Kh_e"] + Kv_e),
                               cd=self.const["cd_b"], n=self.fe.spaces.n_b,
                               table=self.const["blk_b"], name="evolution")

    def _mp_operator(self) -> AssembledBlocks:
        """The held P1 pressure mass on its vertex blocks, filled from the
        last write of ``ops["Mp_e"]``."""
        return self._held["Mp_e"]

    def _make_inv_precond(self, ops, A=None):
        """(M, flexible) for the inversion FGMRES, built from ``ops``;
        ``A`` the masked inversion operator where the caller holds one
        (the saddle-coarse step's residuals apply it)."""
        c = self.const
        n_u = self.fe.spaces.n_u
        if self.precond_kind == "diag":
            scale = 1.0 / self.fe.h_median ** self.fe.mesh.tdim
            return (lambda r: r / scale), False
        visc_op = MaskedOperator(self._visc_operator(ops["visc_e"]), c["free_u"])
        mp_op = MaskedOperator(self._mp_operator(), c["free_inv"][n_u:])
        # full (nonsymmetric) velocity block for the inner_gmres method
        ublock_op = MaskedOperator(self._visc_operator(ops["A_uu_e"], "ublock"), c["free_u"])
        iu, ip = self.inner_iters
        up_coupling = None
        if self.triangular:
            # the P2-P1 pressure coupling, from its assembled blocks
            free_u, up_op = c["free_u"], self._held["A_up_e"]
            up_coupling = lambda zp: free_u * up_op.matvec(zp)
        coarse = None
        if "coarse_inv" in ops or "coarse_e" in ops:
            if "coarse_inv" in ops:
                cinv = ops["coarse_inv"]
                solve = lambda rc: cinv @ rc
            else:
                cop = MaskedOperator(self._coarse_operator("coarse_e"), c["tg_coarse_free"])
                cdiag_inv = ops["coarse_dinv"]

                def solve(rc):
                    zc, _ = cg(cop, rc, torch.zeros_like(rc), M_diag_inv=cdiag_inv,
                               atol=0.0, rtol=1e-2, itmax=60, name="coarse.cg")
                    return zc

            coarse = CoarseCorrection(
                solve=solve,
                parents=c["tg_parents"],
                weights=c["tg_weights"],
                coarse_free=c["tg_coarse_free"],
                free_u=c["free_u"],
                n_vert=self.fe.spaces.p_space.ndof,
            )
        saddle_coarse = None
        outer_op = None
        if "saddle_coarse_inv" in ops or "sc_uu" in ops:
            outer_op = A if A is not None else MaskedOperator(self._inv_matrix(ops),
                                                              c["free_inv"])
            if "saddle_coarse_inv" in ops:
                cinv = ops["saddle_coarse_inv"]
                coarse_solve = lambda rc: cinv @ rc
            else:
                coarse_solve = self._saddle_coarse_solver(ops, mp_op)
            saddle_coarse = SaddleCoarseCorrection(
                solve=coarse_solve,
                parents=c["tg_parents"],
                weights=c["tg_weights"],
                coarse_free_u=c["tg_coarse_free"],
                free_fine=c["free_inv"],
                n_vert=self.fe.spaces.p_space.ndof,
                nu_dofs=n_u,
            )
        M = BlockStokesPrecond(
            visc_op=visc_op,
            visc_diag_inv=ops["visc_dinv"],
            mp_op=mp_op,
            mp_diag_inv=ops["mp_dinv"],
            nu_dofs=n_u,
            inner_iters_u=iu,
            inner_iters_p=ip,
            method=self.inner_method,
            lmax_u=read(ops["lmax_u"], "precond.bound", "float"),
            lmax_p=read(ops["lmax_p"], "precond.bound", "float"),
            cond_ratio=self.cond_ratio,
            ublock_op=ublock_op,
            up_coupling=up_coupling,
            coarse=coarse,
            saddle_coarse=saddle_coarse,
            outer_op=outer_op,
        )
        return M, True

    def _captures(self, ops, M) -> bool:
        """Whether the inversion runs ``M``, built from ``ops``, from CUDA
        graphs (``solvers/graphed.py``): on a CUDA device, the block
        preconditioner with the ``inner_gmres`` smoother on one device (no
        reduction hook) and every coarse level a dense inverse (an
        iterative coarse solve reads the device inside an application)."""
        return (self.device.type == "cuda" and isinstance(M, BlockStokesPrecond)
                and M.method == "inner_gmres" and M.reduce is None
                and (M.saddle_coarse is None or "saddle_coarse_inv" in ops)
                and (M.coarse is None or "coarse_inv" in ops))

    def _precond_key(self, ops, M) -> tuple:
        """What a captured application of the block preconditioner ``M``
        holds fixed: the address of every tensor of ``ops`` and of the
        held operators (it reads their values at each replay, so a write
        in place is seen), and the numbers it took on the host: the
        inner iteration counts, the Chebyshev bounds (the velocity one
        only where the two-grid post-smooth reads it)."""
        ts = [(k, v) for k, v in ops.items() if torch.is_tensor(v)]
        ts += [(f"{k}.{a}", getattr(h, a)) for k, h in self._held.items()
               for a in ("vals", "up_vals") if torch.is_tensor(getattr(h, a, None))]
        return (M.inner_iters_u, M.inner_iters_p, M.lmax_p,
                (M.lmax_u, M.cond_ratio) if M.coarse is not None else None,
                *sorted((k, t.data_ptr()) for k, t in ts))

    def _hold_inversion(self):
        """Build what every solve applies, from ``self.ops``: the masked
        inversion operator and (M, flexible) (``_make_inv_precond``, which
        reads the Chebyshev bounds on the host here).  Where ``_captures``
        says so, M runs from CUDA graphs: the model's last captured M is
        kept while the new one's key (``_precond_key``) is the same, so a
        dict set again with the same tensors (after a rebuild, a refresh
        or a restore of its values) captures nothing anew."""
        with span("invert.precond_setup"):
            ops = self._ops
            A = MaskedOperator(self._inv_matrix(ops), self.const["free_inv"])
            M, flexible = self._make_inv_precond(ops, A)
            if self._captures(ops, M):
                key = self._precond_key(ops, M)
                if self._graphed is None or self._graphed[0] != key:
                    self._graphed = (key, graphed.GraphedPrecond(M))
                M = self._graphed[1]
            self._inv = (A, M, flexible)

    def _solve_saddle(self, ops, y_full, x0):
        """FGMRES on A x = y over free dofs (Dirichlet dofs take their
        BC values), then the zero-mean pressure projection (reference:
        Gridap :zeromean constrained space, src/spaces.jl:45).  ``ops`` is
        the model's own: the operator and preconditioner built when it
        was set are applied."""
        c = self.const
        A, M, flexible = self._inv
        xd = c["xdiri_inv"] * (1.0 - c["free_inv"])
        y = torch.where(A.free_bool, y_full - A.mat.matvec(xd), c["xdiri_inv"])
        with span("invert.fgmres"):
            x, stats = gmres(A, y, x0, M=M, flexible=flexible, name="fgmres", **self.inv_opts)
        n_u = self.fe.spaces.n_u
        u, p = x[:n_u].reshape(-1, 3), x[n_u:]
        pw = ops["p_volw"]
        p = p - torch.dot(pw, p) / torch.sum(pw)
        return u, p, stats

    def _invert_pure(self, ops, b_full, x0):
        """Flow inversion: A x = B b + s on free dofs (reference
        invert!, src/inversion.jl:101-110 + sync_flow!,
        src/model.jl:302-317)."""
        with span("invert"):
            with span("invert.rhs"):
                y = self._b_matvec(ops, b_full) + ops["s"]
            return self._solve_saddle(ops, y, x0)

    @scoped_method
    def solve_inversion(self, y_full, x0=None):
        """Solve the saddle system A x = y for an arbitrary full-length
        rhs over the combined (u, p) dof vector (the
        manufactured-solution / diagnostic entry).  Returns
        (u (n_nodes, 3), p (n_p,), stats)."""
        y_full = torch.as_tensor(y_full, dtype=self.dtype, device=self.device)
        return self._solve_saddle(self.ops, y_full,
                                  torch.zeros_like(y_full) if x0 is None else x0)

    def _evolve_pure(self, ops, state: State, r):
        """Buoyancy step (reference evolve!, src/model.jl:213-285).

        ``r``: step ratio dt_new/dt_old for the variable-step BDF2
        coefficients."""
        with span("evolve"):
            c = self.const
            fe, pr, fr = self.fe, self.params, self.forcings
            dt_ = state.dt

            # convection: rebuild Kv and rhs_diff from the current b
            if fr.conv_param.is_on:
                with span("closures"):
                    kv_q = fr.conv_param.kappa_v(c["kv_q"], self._abz(state.b))
                    Kv_e = asm.elem_stiffness(c["wq"], kv_q, c["Gb3"], (2,))
                    rhs_diff = fe.vec_plan_b.assemble(
                        asm.elem_rhs_diff(c["wq"], kv_q, c["Gb3"], pr.N2))
            else:
                Kv_e, rhs_diff = ops["Kv_e"], ops["rhs_diff"]

            # BDF coefficients; BDF2 runs its first step as BDF1.
            # Variable-step BDF2 (ratio r): c0=(1+r)^2/(1+2r), c1=r^2/(1+2r),
            # implicit/advection weight w=(1+r)/(1+2r); fixed step r=1
            # recovers the reference's 4/3, 1/3, 2/3 (src/evolution.jl:187-193).
            use2 = isinstance(self.ts, BDF2) and state.step > 0
            base_theta = dt_ * pr.a2e2 / pr.mu_rho
            if use2:
                w = (1.0 + r) / (1.0 + 2.0 * r)
                theta = w * base_theta
                c0 = (1.0 + r) ** 2 / (1.0 + 2.0 * r)
                c1 = r ** 2 / (1.0 + 2.0 * r)
                cdt = w * dt_
                w2 = 1.0 + r
            else:
                theta, c0, c1, cdt, w2 = base_theta, 1.0, 0.0, dt_, 1.0

            Afull = self._evo_matrix(ops, theta, Kv_e)
            A = MaskedOperator(Afull, c["free_b"])

            # advection rhs (per-step element assembly)
            with span("evolve.rhs"):
                u_e = state.u[c["cd_u"]]
                up_e = state.u_prev[c["cd_u"]]
                b_e = state.b[c["cd_b"]]
                bp_e = state.b_prev[c["cd_b"]]
                ue = w2 * u_e - (w2 - 1.0) * up_e
                be = w2 * b_e - (w2 - 1.0) * bp_e
                u_q = torch.einsum("qi,cia->cqa", c["phi_u"], ue)
                gb_q = torch.einsum("cqid,ci->cqd", c["Gb3"], be)
                adv = torch.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * pr.N2
                b_q = torch.einsum("qi,ci->cq", c["phi_b"], b_e)
                bp_q = torch.einsum("qi,ci->cq", c["phi_b"], bp_e)
                integ = c0 * b_q - c1 * bp_q - cdt * adv
                rhs_adv = fe.vec_plan_b.assemble(
                    torch.einsum("cq,qi,cq->ci", c["wq"], c["phi_b"], integ))

                y_full = rhs_adv + theta * rhs_diff + dt_ * ops["rhs_flux"]
                xd = c["bdiri"] * (1.0 - c["free_b"])
                y = torch.where(A.free_bool, y_full - Afull.matvec(xd), c["bdiri"])
            with span("evolve.cg"):
                return cg(A, y, state.b, M_diag_inv=1.0 / A.diagonal(), name="cg",
                          **self.evo_opts)

    def _update_dt(self, state: State):
        """CFL-adaptive dt (reference update_Dt!,
        src/timesteppers.jl:108-119; both orders here -- BDF2 growth is
        clamped to r <= 2 for variable-step zero-stability)."""
        if not getattr(self.ts, "adaptive", False):
            return state.dt
        c = self.const
        u_q = torch.einsum("qi,cia->cqa", c["phi_u"], state.u[c["cd_u"]])
        speed = torch.linalg.vector_norm(u_q, dim=-1).amax(dim=1)
        ratios = c["h_cells"] / torch.clamp(speed, min=0.01)
        dt_new = self.ts.CFL_factor * ratios.min()
        if isinstance(self.ts, BDF2):
            dt_new = torch.minimum(dt_new, 2.0 * state.dt)
        return dt_new

    def _abz(self, b):
        """alpha (N2 + db/dz) at volume quadrature points: the
        stratification both closures read."""
        c, pr = self.const, self.params
        return pr.alpha * (pr.N2 + torch.einsum("cqi,ci->cq", c["Gb3"][..., 2], b[c["cd_b"]]))

    @scoped_method
    def refresh_precond(self, ops, state: State):
        """Preconditioner refresh from the CURRENT eddy viscosity;
        returns a new ops dict (``ops`` itself when the eddy closure is
        off): the eddy rebuild of the inversion blocks from
        ``state.b`` (the values the next in-step rebuild would produce)
        and ``_rebuild_precond`` from the same viscosity.

        The reference rebuilds the inversion matrix every 10 steps but
        keeps its preconditioner frozen (src/model.jl:160-170); as nu
        drifts from the build-time field (up to f^2/N2_min in
        destratified boundary layers) the frozen spectral bounds and
        coarse operators go stale and the outer iteration count grows.
        With ``refresh_on_rebuild`` the step does this after each of
        its eddy rebuilds; ``run(n_precond_refresh=...)`` calls it on a
        cadence besides (the only refresh with ``refresh_on_rebuild``
        off).  Call between steps, and set the result as the model's
        ``ops``: that builds the inversion's preconditioner from it.
        Every tensor is rebuilt in place (``_put``), so the returned dict
        holds the same tensors as ``ops`` (one copy in memory)."""
        if not self.forcings.eddy_param.is_on:
            return ops
        with span("refresh"):
            ops = dict(ops)
            return self._rebuild_precond(ops, self._eddy_rebuild(ops, state))

    def _rebuild_precond(self, ops, nu_q):
        """Rebuild every nu-dependent preconditioner operator of ``ops``
        from the eddy viscosity ``nu_q`` (quadrature points), in ``ops``
        itself, and return it: the smoother block with its diagonal and
        spectral bound, the two-grid coarse level (its element tensors
        and diagonal, or its dense inverse), the saddle-coarse tensors
        with their diagonal, pin, bound and aggregate-level inverse (or
        the dense coarse inverse).  Every shape is kept, and every
        tensor's address: all is written through ``_put``.  (The JAX
        package's two-grid refresh reads ``coarse_e`` on the dense
        branch too, which never sets it, and raises ``KeyError``; here
        the dense branch rebuilds ``coarse_inv``.)

        Memory: the element tensors (``visc_e``, ``coarse_e``, ``sc_*``)
        are rebuilt chunk by chunk INTO the tensors ``ops`` holds, so
        peak device memory holds one copy; every other tensor is computed
        anew and copied into the one ``ops`` holds.  A caller that keeps
        the old values passes a copy of them."""
        count("precond.refresh")
        self._assemble_smoother(ops, nu_q)
        if self.twogrid:
            self._assemble_coarse(ops, nu_q)
        if self.saddle_coarse:
            self._assemble_saddle_coarse(ops, nu_q)
        return ops

    def _eddy_rebuild(self, ops, state: State):
        """Eddy-viscosity inversion-matrix rebuild (reference
        src/model.jl:160-170), written into ``ops``' own inversion
        blocks (one copy in memory, ``_put``), with the assembled P2-P1
        coupling refilled from them.  The preconditioner is left to the caller
        (``_rebuild_precond``).  Returns the viscosity at the quadrature
        points."""
        with span("closures"):
            count("closures.rebuild")
            nu_q = self.forcings.eddy_param.nu(self.const["f_eddy_q"], self._abz(state.b))
            keys = ("A_uu_e", "A_up_e", "A_pu_e")
            self._put(ops, **dict(zip(keys, self._assemble_inversion_elems(
                nu_q, out=tuple(ops[k] for k in keys)))))
        return nu_q

    # ------------------------------------------------------------------
    # host-level API
    # ------------------------------------------------------------------
    @scoped_method
    def step(self, state: State):
        """One timestep: (new_state, aux) with solver iteration counts
        and the progress-line diagnostics (Python numbers).  With the
        eddy closure on, every 10th step rebuilds the inversion blocks
        of ``self.ops`` from the new buoyancy and, with
        ``refresh_on_rebuild``, the preconditioner from the same
        viscosity, written into the tensors of ``self.ops`` and set as
        ``self.ops`` again, which builds the preconditioner from them.  ``aux`` also holds ``REBUILD_KEYS``:
        ``rebuilt`` (1.0 on such a step) and ``rebuild_s``, the host
        seconds of both rebuilds between two device synchronises (0.0
        on every other step)."""
        with span("step", state.step):
            dt_old = state.dt
            dt_ = self._update_dt(state)
            state = State(u=state.u, p=state.p, b=state.b, u_prev=state.u_prev,
                          b_prev=state.b_prev, t=state.t, dt=dt_, step=state.step)
            b_new, evo_stats = self._evolve_pure(self.ops, state, dt_ / dt_old)
            x0 = torch.cat([state.u.reshape(-1), state.p])
            u_new, p_new, inv_stats = self._invert_pure(self.ops, b_new, x0)
            new_state = State(u=u_new, p=p_new, b=b_new, u_prev=state.u, b_prev=state.b,
                              t=state.t + dt_, dt=dt_, step=state.step + 1)
            rebuilt, rebuild_s = 0.0, 0.0
            if self.forcings.eddy_param.is_on and new_state.step % 10 == 0:
                self._sync()
                t0 = time.perf_counter()
                nu_q = self._eddy_rebuild(self.ops, new_state)
                if self.refresh_on_rebuild:
                    with span("refresh"):
                        self.ops = self._rebuild_precond(self.ops, nu_q)
                self._sync()
                rebuilt, rebuild_s = 1.0, time.perf_counter() - t0
            with span("step.aux"):
                freeb = self.const["free_b"].bool()
                u_max = torch.abs(u_new).max()
                inf = torch.tensor(float("inf"), dtype=b_new.dtype, device=b_new.device)
                diag = read(torch.stack([
                    u_max,
                    torch.abs(b_new).max(),
                    torch.where(freeb, b_new, inf).min(),
                    torch.where(freeb, b_new, -inf).max(),
                    torch.where(freeb, torch.abs(b_new - state.b), 0.0).max() / dt_,
                    self.const["h_cells"].min() / torch.clamp(u_max, min=1e-30),
                ]), "step.aux", "list")
            aux = dict(zip(AUX_KEYS[4:], diag))
            aux.update(evo_iters=evo_stats.iterations, evo_res=evo_stats.residual,
                       inv_iters=inv_stats.iterations, inv_res=inv_stats.residual,
                       rebuilt=rebuilt, rebuild_s=rebuild_s)
            return new_state, aux

    @scoped_method
    def multi_step(self, state: State, n: int):
        """``n`` timesteps: (state, auxs), ``auxs[key]`` a length-n numpy
        array of the per-step aux values, as the JAX package's
        ``multi_step`` stacks them (a ``lax.scan``).  Here it is a loop
        over ``step``, so the eddy rebuilds land in ``self.ops`` as they
        ride in the scan carry there; capturing it in a CUDA graph is
        later work."""
        auxs = {k: [] for k in AUX_KEYS}
        for _ in range(n):
            state, aux = self.step(state)
            for k in AUX_KEYS:
                auxs[k].append(aux[k])
        return state, {k: np.asarray(v) for k, v in auxs.items()}

    @scoped_method
    def retune(
        self,
        saddle_coarse_inner: Optional[int] = None,
        inner_iters_u: Optional[int] = None,
        inner_iters_p: Optional[int] = None,
        cond_ratio: Optional[float] = None,
        inv_rtol: Optional[float] = None,
        inv_atol: Optional[float] = None,
        inv_memory: Optional[int] = None,
        evo_rtol: Optional[float] = None,
        evo_atol: Optional[float] = None,
    ):
        """Re-tune the solver budgets without re-assembling operators;
        returns ``self``.  Keywords and semantics as the JAX package's
        ``retune``: None keeps a budget, and a new ``inv_memory`` also
        sets the FGMRES cap to 25 restart cycles.

        The JAX model rebuilds its jitted closures here.  This port
        rebuilds the inversion's preconditioner from ``self.ops`` with the
        new budgets (``_hold_inversion``, as when ``ops`` is set; a new
        inner budget makes a captured preconditioner capture anew).  No
        operator is re-assembled and ``self.ops`` is not touched."""
        if saddle_coarse_inner is not None:
            self.saddle_coarse_inner = saddle_coarse_inner
        iu, ip = self.inner_iters
        if inner_iters_u is not None:
            iu = inner_iters_u
        if inner_iters_p is not None:
            ip = inner_iters_p
        self.inner_iters = (iu, ip)
        if cond_ratio is not None:
            self.cond_ratio = cond_ratio
        for k, v in (("rtol", inv_rtol), ("atol", inv_atol), ("m", inv_memory)):
            if v is not None:
                self.inv_opts[k] = v
        if inv_memory is not None:
            self.inv_opts["itmax"] = 25 * inv_memory
        for k, v in (("rtol", evo_rtol), ("atol", evo_atol)):
            if v is not None:
                self.evo_opts[k] = v
        self._hold_inversion()
        return self

    def rest_state(self) -> State:
        sp = self.fe.spaces
        c = self.const
        zb = torch.where(c["free_b"].bool(), torch.zeros_like(c["bdiri"]), c["bdiri"])
        zu = c["wq"].new_zeros((sp.u_space.ndof, 3))
        return State(u=zu, p=c["wq"].new_zeros(sp.n_p), b=zb, u_prev=zu, b_prev=zb,
                     t=self._T(self.ts.t_start), dt=self._T(self.ts.dt), step=0)

    def set_b(self, state: State, f) -> State:
        """Set buoyancy from a callable or array; Dirichlet dofs keep
        their BC values (reference set_b!, src/model.jl:77-88)."""
        if callable(f):
            vals = self.fe.spaces.b_space.interpolate(f)
        else:
            vals = np.asarray(f)
        c = self.const
        b = torch.where(c["free_b"].bool(), self._T(vals), c["bdiri"])
        return State(u=state.u, p=state.p, b=b, u_prev=state.u_prev, b_prev=b,
                     t=state.t, dt=state.dt, step=state.step)

    @scoped_method
    def invert(self, state: State, return_stats: bool = False):
        """Diagnose the flow (u, p) from the state's buoyancy, starting
        FGMRES from the state's flow.  With ``return_stats``, (state,
        FGMRES stats) as the JAX ``invert_jit``'s aux carries them."""
        x0 = torch.cat([state.u.reshape(-1), state.p])
        u, p, stats = self._invert_pure(self.ops, state.b, x0)
        out = State(u=u, p=p, b=state.b, u_prev=state.u_prev, b_prev=state.b_prev,
                    t=state.t, dt=state.dt, step=state.step)
        return (out, stats) if return_stats else out

    @scoped_method
    def run(self, state: State, n_info: int = 10, n_save: Optional[int] = None,
            save_callback: Optional[Callable] = None, n_plot: Optional[int] = None,
            plot_callback: Optional[Callable] = None, max_steps: Optional[int] = None,
            steps_per_block: int = 1, n_precond_refresh: Optional[int] = None,
            log: Callable = print) -> State:
        """Advance until t >= t_stop (reference run!, src/model.jl:90-211),
        raising ``BlowUpError`` when |u| or |b| exceeds 1e3 or is NaN.

        The progress block matches the reference's field-for-field
        (src/model.jl:172-192).  ``save_callback(model, state, i)`` and
        ``plot_callback(model, state, i)`` run every ``n_save`` /
        ``n_plot`` steps.  ``steps_per_block > 1`` advances blocks of
        steps through ``multi_step``; logging, saving and the refresh
        cadence then apply at block granularity.  ``n_precond_refresh``
        calls ``refresh_precond`` once that many steps have passed since
        the last refresh (eddy closure only): with ``refresh_on_rebuild``
        these refreshes come on top of the step's own after each eddy
        rebuild."""
        t_stop = float(self.ts.t_stop)
        t0 = t_last_info = time.time()
        i0 = i = last_refresh = state.step
        while float(state.t) < t_stop:
            if steps_per_block > 1:
                state, auxs = self.multi_step(state, steps_per_block)
                aux = {k: v[-1].item() for k, v in auxs.items()}
                i += steps_per_block
            else:
                state, aux = self.step(state)
                i += 1
            u_max, b_max = aux["u_max"], aux["b_max"]
            if max(u_max, b_max) > 1e3 or np.isnan(u_max) or np.isnan(b_max):
                raise BlowUpError(
                    f"Blow-up detected at step {i}: |u|max={u_max:.3e} |b|max={b_max:.3e}")
            if n_info and i % n_info == 0:
                t1 = time.time()
                log(progress_message(i, i0, n_info, float(state.t), float(state.dt), t_stop,
                                     t1 - t0, t1 - t_last_info, aux))
                t_last_info = t1
                sys.stdout.flush()
            if n_save and i % n_save == 0 and save_callback is not None:
                save_callback(self, state, i)
            if n_plot and i % n_plot == 0 and plot_callback is not None:
                plot_callback(self, state, i)
            # steps since the last refresh, not a modulo: with
            # steps_per_block > 1, i only hits multiples of the block
            # size, and a cadence the block does not divide would
            # otherwise never fire
            if (n_precond_refresh and i - last_refresh >= n_precond_refresh
                    and self.forcings.eddy_param.is_on):
                self.ops = self.refresh_precond(self.ops, state)
                last_refresh = i
            if max_steps is not None and i >= int(max_steps):
                break
        return state
