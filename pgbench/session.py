"""One run of one cell: set-up, the replayed window, the traced replays
and the judgement of what the window produced.

Set-up builds the configuration's model, makes the start state from the
seed (the traffic's initial buoyancy with the seed's draws), advances it
by the traffic's ``advance_steps`` and keeps it; where the eddy closure
is on it also keeps a copy of ``model.ops``, which the closure's
rebuilds and the preconditioner refreshes overwrite.  The window then
replays the traffic's fixed segment of ``segment_steps`` steps from that
start, again and again, restoring the state and the operators before
each replay, so every replay does the same work however fast the
program is.  A step is ``PGModel.step`` plus, every ``refresh_every``
steps of the segment, ``PGModel.refresh_precond`` (the cadence of
``PGModel.run(n_precond_refresh=...)``), timed together on the host
clock; ``step`` ends in a host read, so no synchronise is added.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from . import trace as tr
from .hooks import Hooks
from .work import OperatorWork, least_seconds, pair_counts


def draws(traffic: dict, seed: int) -> dict:
    """The initial field's parameters: the traffic's fixed ones and the
    seed's draws (uniform in each named range, in name order)."""
    ic = traffic["initial_b"]
    rng = np.random.default_rng(int(seed))
    out = dict(ic.get("fixed", {}))
    for k in sorted(ic.get("draws", {})):
        lo, hi = ic["draws"][k]
        out[k] = float(rng.uniform(lo, hi))
    return out


def host(state) -> dict:
    """A host copy of what the reference reads of a state."""
    return {"u": state.u.detach().cpu(), "p": state.p.detach().cpu(),
            "b": state.b.detach().cpu(), "u_prev": state.u_prev.detach().cpu(),
            "b_prev": state.b_prev.detach().cpu(), "dt": float(state.dt), "step": state.step}


def view(state) -> dict:
    """The same fields, kept on the device (the window's states are never
    written in place, so a reference costs nothing)."""
    return {"u": state.u, "p": state.p, "b": state.b, "u_prev": state.u_prev,
            "b_prev": state.b_prev, "dt": state.dt, "step": state.step}


class Capture:
    """The judged operator applications, as a subscriber of
    ``hooks.Hooks`` in the replay after the window: for each step, the
    second application (the first is to the Dirichlet values) of the
    inversion operator (K1 ``full``) and of the evolution operator (K2),
    input and output copied for the reference."""

    def __init__(self, n_b):
        self.n_b, self.steps = n_b, []

    def begin_step(self):
        self.steps.append({})
        self.count = {"inv": 0, "evo": 0}

    def _kind(self, op, meth):
        if meth != "matvec" or not self.steps:
            return None
        name = type(op).__name__
        if name == "SaddleOperator" and op.up is not None and op.pp is None:
            return "inv"
        if name == "ElementOperator" and op.n == self.n_b:
            return "evo"
        return None

    def __call__(self, op, meth, args, result):
        k = self._kind(op, meth)
        if k is not None:
            self.count[k] += 1
            if self.count[k] == 2:
                self.steps[-1][k] = (args[0].detach().clone(), result.detach().clone())


class Session:
    def __init__(self, cfg, traffic, seed, system, device="cuda", control=None, fault=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.system, self.device, self.fault = system, torch.device(device), fault
        eddy = cfg.get("eddy")
        self.rebuild_every = eddy["rebuild_every"] if eddy else 0
        self.refresh_every = traffic.get("refresh_every", 0) if eddy else 0
        self.n_seg = traffic["segment_steps"]
        if control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.model, mesh = system.build(cfg, self.device,
                                        matmul_precision=None if control else "float32")
        self.raw, self.nodes = system.raw_mesh(mesh), system.node_coords(self.model)
        self.ic = draws(traffic, seed)
        model = self.model
        st = system.start_state(model, traffic["initial_b"]["expr"], self.ic)
        if getattr(fault, "AT_START", False):
            st, self.fault = fault(st), None
        self.first = host(st)
        # the set-up's steps: a seeded sample of them is judged too
        rng = np.random.default_rng(self.seed + 1)
        n_adv = traffic.get("advance_steps", 0)
        judge = set(rng.choice(n_adv, size=min(n_adv, traffic.get("judge_advance", 0)),
                               replace=False).tolist()) if n_adv else set()
        self.setup_judged, nu = [], None
        for k in range(n_adv):
            new, _ = model.step(st)
            if k in judge:
                self.setup_judged.append((host(st), host(new), nu))
            nu = self._nu_after(new, nu, refreshed=False, keep=host)
            st = new
        self.start, self.nu_start = st, nu
        self.ops_orig = dict(model.ops) if eddy else None
        self.ops_snap = ({k: v.clone() if torch.is_tensor(v) else v for k, v in model.ops.items()}
                         if eddy else None)
        self.spans = None
        self.replay()          # warm every shape of the segment
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _nu_after(self, new, nu, refreshed, keep=view):
        """The buoyancy the eddy viscosity comes from after a step (a
        rebuild every ``rebuild_every`` steps, or a refresh)."""
        if self.rebuild_every and (refreshed or new.step % self.rebuild_every == 0):
            return keep(new)["b"]
        return nu

    # -- the segment --------------------------------------------------
    def restore(self):
        if self.ops_orig is not None:
            for k, v in self.ops_orig.items():
                if torch.is_tensor(v):
                    v.copy_(self.ops_snap[k])
            self.model.ops = dict(self.ops_orig)

    def replay(self, keep=False, cap=None):
        """One replay of the segment: (host seconds of each step, aux of
        each step, with ``keep`` the judged steps [(before, after, nu
        source, the operator applications ``cap`` captured)])."""
        model = self.model
        self.restore()
        st, nu = self.start, self.nu_start
        times, auxs, kept = [], [], [] if keep else None
        for k in range(1, self.n_seg + 1):
            if cap:
                cap.begin_step()
            t0 = time.perf_counter()
            with self._span("step"):
                new, aux = model.step(st)
                if self.fault is not None:
                    new = self.fault(st, new)
                refreshed = bool(self.refresh_every) and k % self.refresh_every == 0
                if refreshed:
                    model.ops = model.refresh_precond(model.ops, new)
            times.append(time.perf_counter() - t0)
            auxs.append(aux)
            if keep:
                kept.append((view(st), view(new), nu, cap.steps[-1] if cap else {}))
            nu = self._nu_after(new, nu, refreshed)
            st = new
        return times, auxs, kept

    def window(self, seconds):
        """Replays until ``seconds`` have passed: the record of the window
        (every step's seconds and aux, the window's seconds).  It keeps
        the states of one replay drawn uniformly from the seed (decided
        before each replay runs, as a reservoir of one); keeping them
        copies nothing, since the window's states are never written in
        place."""
        rng = np.random.default_rng(self.seed + 2)
        self._sync()
        t0 = time.perf_counter()
        times, auxs, n = [], [], 0
        self.drawn = None
        while True:
            n += 1
            draw = rng.random() < 1.0 / n
            t, a, kept = self.replay(keep=draw)
            times += t
            auxs += a
            if draw:
                self.drawn = kept
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        return {"window_s": time.perf_counter() - t0, "step_s": times, "aux": auxs,
                "replays": n, "steps": len(times)}

    def judged_replay(self):
        """After the window: one more replay of the segment by the same
        model, from the same restored start, with the judged operator
        applications captured (the window itself carries no hooks)."""
        cap = Capture(self.model.fe.spaces.n_b)
        with Hooks(cap):
            _, _, self.after = self.replay(keep=True, cap=cap)

    # -- spans and traces (the --trace 1 run) --------------------------
    @contextlib.contextmanager
    def _span(self, name):
        """A harness span around a call into the model (--trace 1 only):
        a profiler range, and, while ``timed``, host seconds between two
        synchronises."""
        sp = self.spans
        if sp is None:
            yield
            return
        with torch.profiler.record_function(f"pgbench.{name}"):
            if sp["timed"]:
                self._sync()
                t0 = time.perf_counter()
                yield
                self._sync()
                sp["s"][name] = sp["s"].get(name, 0.0) + time.perf_counter() - t0
            else:
                yield

    def _wrap(self, attr, name):
        fn = getattr(self.model, attr)

        def wrapped(*a, **k):
            with self._span(name):
                return fn(*a, **k)

        setattr(self.model, attr, wrapped)

    def traced_window(self, seconds, trace_replays):
        """The --trace 1 run: the window with spans around the model's
        calls (each closed by a synchronise) and the operator-work
        counter, then ``trace_replays`` replays under the profiler."""
        model = self.model
        self.spans = {"s": {}, "timed": True}
        self._wrap("_invert_pure", "invert")
        self._wrap("_evolve_pure", "evolve")
        counts = pair_counts(self.raw["cells"], len(self.raw["coords"]))
        variable = bool(self.cfg.get("eddy")) or isinstance(self.cfg["coefficients"]["nu"], str)
        work = OperatorWork(model, counts, variable)
        try:
            with Hooks(work):
                rec = self.window(seconds)
                rec["spans_s"] = dict(self.spans["s"])
                rec["work"] = work.summary()
                self.spans["timed"] = False
                rec["trace"] = self._device_trace(work, trace_replays)
        finally:
            self.spans = None
        return rec

    def _device_trace(self, work, trace_replays):
        """``trace_replays`` replays under the profiler: device busy time,
        launches, the least time of the work applied, the top device
        operations and idle gaps (None off the card)."""
        if self.device.type != "cuda":
            return None

        def traced_work():
            work.reset()
            for _ in range(trace_replays):
                self.replay()

        events, wall, tries = tr.traced(traced_work)
        if events is None:
            return {"tries": tries, "wall_s": wall}
        summ = tr.trace_summary(events)
        kernel_us = sum(float(e["dur"]) for e in events if e.get("cat") == "kernel")
        wk = work.summary()
        return {"steps": trace_replays * self.n_seg, "wall_s": wall, "tries": tries,
                "busy_s": summ["busy_us"] / 1e6, "kernel_s": kernel_us / 1e6,
                "launches": len(tr.launches_of(events)), "least_s": least_seconds(wk),
                "work": wk,
                "device_ops": [[k, us / 1e6] for k, (_, us) in list(summ["by_name"].items())[:10]],
                "idle_gaps": tr.idle_gaps(events)}

    # -- after the window --------------------------------------------
    def release(self):
        """Free the program's state before the reference runs: the judged
        steps go to the host, the model and its operators go."""
        def cpu(v):
            return v.detach().cpu() if torch.is_tensor(v) else v

        def to_host(j):
            return [({k: cpu(v) for k, v in a.items()}, {k: cpu(v) for k, v in b.items()}, cpu(nu),
                     {k: (cpu(x), cpu(y)) for k, (x, y) in ap.items()})
                    for a, b, nu, ap in (j or [])]

        self.judged = {"setup": [(a, b, cpu(nu), {}) for a, b, nu in self.setup_judged],
                       "drawn": to_host(self.drawn), "after": to_host(self.after)}
        self.start_b = self.first["b"]
        del self.model, self.start, self.ops_orig, self.ops_snap, self.drawn, self.after
        self.nu_start = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def failed_steps(auxs, inv_itmax, evo_itmax) -> int:
    """Steps whose solve reached its cap or whose state is not finite."""
    bad = 0
    for a in auxs:
        if (a["inv_iters"] >= inv_itmax or a["evo_iters"] >= evo_itmax
                or not all(math.isfinite(a[k]) for k in ("u_max", "b_max"))):
            bad += 1
    return bad
