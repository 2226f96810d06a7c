"""Multi-process dryrun of the sharded-state PG step.

PyTorch counterpart of ``nupgcm_tpu.tools.multihost_dryrun``: the
domain-decomposed step (``parallel/dd.py``) runs over a process group,
every process holds ``--local-shards`` shards, and the halo shifts and
reductions ride ``torch.distributed`` (gloo on the CPU, NCCL on the
cards, one rank per card).

Run one process per rank, on the CPU::

    python -m nupgcm_tpu_torch.tools.multihost_dryrun --device cpu \\
        --nproc 2 --pid 0 --port 9954 &
    python -m nupgcm_tpu_torch.tools.multihost_dryrun --device cpu \\
        --nproc 2 --pid 1 --port 9954

or with ``--init-method env://`` (MASTER_ADDR, MASTER_PORT) or
``file:///path``.  The default device is the card (rank r on card
r % device_count).  Each process prints one JSON line with the
replicated post-step state norms: the same on every process, and the
same as a one-process run with the same total shard count
(tests/test_torch_multihost.py checks both).
"""

from __future__ import annotations

import argparse
import datetime
import json

import numpy as np
import torch


def build_model(device="cuda", dtype=torch.float64):
    """The JAX tool's configuration: bowl3D(0.4, 0.5, nz=2), wind,
    block-Stokes FGMRES without a coarse level."""
    import nupgcm_tpu_torch as npg

    eps, alpha, mu = 2e-1, 0.5, 1e1
    params = npg.Parameters(
        eps=eps, alpha=alpha, mu_rho=mu, N2=1 / alpha,
        f=lambda x: 1.0 + 0.5 * x[1],
        H=lambda x: alpha * (1 - x[0] ** 2 - x[1] ** 2))
    kap = lambda x: 1e-2 + np.exp(-(x[2] + alpha * (1 - x[0] ** 2 - x[1] ** 2)) / (0.1 * alpha))
    forc = npg.Forcings(
        nu=1.0, kappa_h=kap, kappa_v=kap,
        tau_x=lambda x: -0.05 * np.cos(np.pi / 2 * x[1]), tau_y=0.0,
        b_surface_bc=npg.SurfaceDirichletBC(0.0))
    mesh = npg.generators.bowl3D(0.4, alpha, nz=2)
    spaces = npg.Spaces(
        mesh, u_diri_tags=["bottom", "coastline", "surface"],
        u_diri_vals=[(0, 0, 0)] * 3,
        u_diri_masks=[(True, True, True), (True, True, True), (False, False, True)],
        b_diri_tags=["coastline", "surface"], b_diri_vals=[0.0, 0.0])
    fe = npg.FEData(mesh, spaces)
    dt = 1e-4 * mu / (alpha * eps) ** 2
    ts = npg.BDF2(t_start=0, t_stop=50 * dt, dt=dt)
    return npg.PGModel(fe, params, forc, ts, dtype=dtype, device=device, inv_itmax=300,
                       evo_itmax=300, saddle_coarse=False, twogrid=False,
                       inner_method="chebyshev", inner_iters_u=10)


def run(n_steps: int = 1, n_shards: int = 8, device="cuda", process_group=None) -> dict:
    """``n_steps`` DD steps of ``build_model`` over ``n_shards`` shards
    (this process alone, or the ranks of ``process_group``)."""
    from nupgcm_tpu_torch.parallel.comm import ShardGroup
    from nupgcm_tpu_torch.parallel.dd import DDModel

    model = build_model(device)
    group = ShardGroup(n_shards, process_group)
    dd = DDModel(model, n_shards, group)
    state = model.set_b(model.rest_state(), lambda x: 0.05 * np.exp(2.0 * x[2]))
    sv = dd.to_dd(state)
    aux = None
    for _ in range(n_steps):
        sv, aux = dd.step(sv)
    out = dd.norms(sv)
    out.update(u_max=aux["u_max"], b_max=aux["b_max"], inv_iters=int(aux["inv_iters"]),
               n_devices=n_shards, n_processes=group.world, process_id=group.rank,
               halo_K=[dd.part_u.K, dd.part_p.K, dd.part_b.K])
    return out


def main(argv=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--port", type=int, default=9954)
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (default tcp://127.0.0.1:<port>; env://, file://...)")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--local-shards", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() is False")
        torch.cuda.set_device(args.pid % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if args.device == "cuda" else "gloo",
        init_method=args.init_method or f"tcp://127.0.0.1:{args.port}",
        world_size=args.nproc, rank=args.pid, timeout=datetime.timedelta(seconds=120))
    try:
        out = run(args.steps, args.nproc * args.local_shards, args.device, dist.group.WORLD)
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
