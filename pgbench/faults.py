"""Planted faults: a broken step under the harness, to show that the
comparison that decides ``correct`` fails it.  Each takes the state
before a step and the state the step returned, and returns the state the
window goes on with; ``AT_START`` ones alter the start state instead.
Used by the tests and by the readings of each fault on the card; the
benchmark's own runs plant none."""

from __future__ import annotations

from dataclasses import replace

import torch


def state_unchanged(before, after):
    """The step returns its buoyancy unchanged."""
    return replace(after, b=before.b)


def half_left_out(before, after):
    """Half of the buoyancy nodes keep their old values."""
    b = after.b.clone()
    n = len(b) // 2
    b[:n] = before.b[:n]
    return replace(after, b=b)


def buoyancy_altered(before, after):
    """One buoyancy value (the largest) flips sign where it is produced."""
    b = after.b.clone()
    i = int(torch.argmax(b.abs()))
    b[i] = -b[i]
    return replace(after, b=b)


def flow_altered(before, after):
    """One velocity component (the largest) flips sign."""
    u = after.u.clone().reshape(-1)
    i = int(torch.argmax(u.abs()))
    u[i] = -u[i]
    return replace(after, u=u.reshape(after.u.shape))


def pressure_shifted(before, after):
    """The pressure loses its zero volume mean."""
    return replace(after, p=after.p + 1e-3 * after.p.abs().max())


def dt_altered(before, after):
    """The adaptive step reports a time step 0.1% off."""
    return replace(after, dt=after.dt * 1.001)


def start_altered(state):
    """The start state's largest buoyancy value flips sign."""
    b = state.b.clone()
    i = int(torch.argmax(b.abs()))
    b[i] = -b[i]
    return replace(state, b=b, b_prev=b)


start_altered.AT_START = True

FAULTS = {f.__name__.replace("_", "-"): f for f in
          (state_unchanged, half_left_out, buoyancy_altered, flow_altered, pressure_shifted,
           dt_altered, start_altered)}
