"""Break the timestep into its cost components.

PyTorch counterpart of ``tools/profile_step.py``.  After two warm-up
steps through ``multi_step`` it times, by difference quotient
(``_common.difference_quotient``), per call:

  step      the complete timestep (``PGModel.step``)
  invert    the saddle FGMRES solve (solve + preconditioner), warm-started
            from the previous step's flow as a step's solve is (the JAX
            tool starts from the converged flow, which FGMRES accepts
            with no iteration)
  evolve    the buoyancy step (advection assembly + CG)
  adv       the advection-rhs element assembly alone

and, for each, its device-busy time per call from a profiler trace of
n1 calls, which the host's clock jitter does not reach.

Usage: python -m nupgcm_tpu_torch.tools.profile_step [h] [nz]
       defaults h=0.033 nz=12.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from ._common import (bowl_model, device_name, device_times, difference_quotient,
                      initial_b, log_print, require_cuda)

N1, N2 = 3, 13
PARTS = ("step", "invert", "evolve", "adv")


def run(h=0.033, nz=12, model=None, device="cuda", dtype=torch.float32, n1=N1, n2=N2,
        log=log_print) -> dict:
    """ms per call of each of PARTS on ``model`` (or the mixing model of
    ``bowl3D(h, 0.5, nz)``), with each part's share of the step."""
    model = bowl_model(h, nz, device, dtype, model)
    fe, pr = model.fe, model.params
    log(f"{fe.summary()}")
    state = model.set_b(model.rest_state(), initial_b)
    # two steps so u/b_prev are physical
    state, aux = model.multi_step(state, 2)
    log(f"warmed: evo_it={int(aux['evo_iters'][-1])} inv_it={int(aux['inv_iters'][-1])}")

    def chain(st, val):
        # the next call depends on this one's result
        return dataclasses.replace(st, b=st.b + 0.0 * val.reshape(-1)[0])

    def body_step(st):
        return model.step(st)[0]

    def body_invert(st):
        x0 = torch.cat([st.u_prev.reshape(-1), st.p])
        u, _, stats = model._invert_pure(model.ops, st.b, x0)
        inv_iters.append(stats.iterations)
        return chain(st, u)

    def body_evolve(st):
        b_new, _ = model._evolve_pure(model.ops, st, 1.0)
        return chain(st, b_new)

    def body_adv(st):
        c = model.const
        u_q = torch.einsum("qi,cia->cqa", c["phi_u"], st.u[c["cd_u"]])
        b_e = st.b[c["cd_b"]]
        gb_q = torch.einsum("cqid,ci->cqd", c["Gb3"], b_e)
        adv = torch.einsum("cqa,cqa->cq", u_q, gb_q) + u_q[..., 2] * pr.N2
        b_q = torch.einsum("qi,ci->cq", c["phi_b"], b_e)
        integ = b_q - st.dt * adv
        rhs_adv = fe.vec_plan_b.assemble(
            torch.einsum("cq,qi,cq->ci", c["wq"], c["phi_b"], integ))
        return chain(st, rhs_adv)

    def looped(body):
        def fn(n):
            st = state
            for _ in range(n):
                st = body(st)
            return st
        return fn

    inv_iters = []
    bodies = dict(zip(PARTS, (body_step, body_invert, body_evolve, body_adv)))
    ms, device_ms = {}, {}
    for name in PARTS:
        sec, first = difference_quotient(looped(bodies[name]), n1, n2, model.device)
        ms[name] = sec * 1e3
        device_ms[name], _ = device_times(looped(bodies[name]), n1, model.device, "")
        dev = ("device not measured" if device_ms[name] is None
               else f"device busy {device_ms[name]:.3f} ms")
        log(f"  {name:10s} {ms[name]:9.3f} ms, {dev}  (first {n1} calls {first:.2f} s)")
    log(f"invert: {inv_iters[0]} FGMRES iterations per solve")
    log("\ncomposition: step = invert + evolve + dt overhead;\n  evolve = adv + CG;  shares:")
    share = {k: v / ms["step"] for k, v in ms.items()}
    for k, v in ms.items():
        log(f"  {k:8s} {v:8.3f} ms ({100 * share[k]:.0f}% of step)")
    return {"device": device_name(model.device), "n_dof": fe.n_inv, "ms": ms,
            "share": share, "device_ms": device_ms, "invert_iters": inv_iters[0]}


def main(argv=None):
    require_cuda()
    argv = sys.argv[1:] if argv is None else argv
    h = float(argv[0]) if len(argv) > 0 else 0.033
    nz = int(argv[1]) if len(argv) > 1 else 12
    run(h, nz)


if __name__ == "__main__":
    main()
