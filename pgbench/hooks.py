"""The one set of wrappers the harness puts around the port's operator
entry points.  Each subscriber sees every application: the operator,
the method, its arguments and its result.  The operator-work count
(``work.py``) and the capture of the judged applications
(``session.Capture``) subscribe to it; neither runs inside the timed
window of a ``--trace 0`` run."""

from __future__ import annotations

import functools


def targets():
    """(class, method) of every operator entry point: whichever kernel
    then runs (K1/K2, the assembled vertex blocks, a dense product), an
    application passes through one of these."""
    from nupgcm_tpu_torch.ops import assembled, element
    from nupgcm_tpu_torch.solvers import preconditioners as pc

    out = [(element.SaddleOperator, "matvec"), (element.SaddleOperator, "up_matvec"),
           (element.ElementOperator, "matvec"), (assembled.AssembledBlocks, "matvec"),
           (assembled.AssembledSaddle, "matvec"), (assembled.AssembledSaddle, "up_matvec")]
    out += [(getattr(pc, n), "__call__") for n in
            ("SaddleCoarseCorrection", "CoarseCorrection", "AggregateCoarseCorrection")
            if hasattr(pc, n)]
    return out


class Hooks:
    """``with Hooks(sub, ...):`` wraps every entry point; each
    ``sub(op, method, args, result)`` is called after each application.
    The methods are put back on exit."""

    def __init__(self, *subscribers):
        self.subs, self._orig = list(subscribers), []

    def __enter__(self):
        for cls, meth in targets():
            fn = getattr(cls, meth)
            self._orig.append((cls, meth, fn))
            setattr(cls, meth, self._wrapped(fn, meth))
        return self

    def _wrapped(self, fn, meth):
        subs = self.subs

        @functools.wraps(fn)
        def wrapped(op, *a, **k):
            y = fn(op, *a, **k)
            for sub in subs:
                sub(op, meth, a, y)
            return y

        return wrapped

    def __exit__(self, *exc):
        for cls, meth, fn in reversed(self._orig):
            setattr(cls, meth, fn)
        self._orig = []
