"""The block preconditioner's ``inner_gmres`` application replayed from
two CUDA graphs.

An application of ``BlockStokesPrecond`` with the ``inner_gmres``
smoother and dense coarse levels launches some 300 small kernels and
reads the device eight times (the inner GMRES's stopping tests); on a
mesh of 54k DoF the host's launches, not the card, set its time.  Its
only host work is the inner GMRES's small least-squares problem, so it
splits in two halves with no read inside either:

* A (``split_head``): the pressure smoother, the coupling and the inner
  GMRES's m Arnoldi steps;
* the host: one read of [beta, H], the Givens rotations and the
  triangular solve (``gmres.lsq``), the same arithmetic as ``gmres``'s;
* B (``split_tail``): the velocity update from the first j basis
  vectors, the two-grid step and the saddle-coarse correction.

Each half is captured once, on its first application (B once per j:
``lsq`` stops early only where the inner residual falls below its
tolerance, so j is m almost always), and replayed from then on.  A
replay reads each tensor at the address it had at capture, with the
values it holds then, and repeats the numbers the capture took on the
host (the Chebyshev bounds).  The model decides what it captures
(``PGModel._captures``) when its ``ops`` is set, and keeps one
``GraphedPrecond`` while those addresses and numbers stay
(``PGModel._hold_inversion``; its rebuilds write every tensor in place,
``PGModel._put``).  Each capture counts ``precond.capture``.
``capture=False`` runs the same halves without graphs (the CPU, tests).
"""

from __future__ import annotations

import functools

import torch

from ..ops import kernels
from ..utils.timing import count, read, span
from .gmres import lsq
from .preconditioners import INNER_RTOL, BlockStokesPrecond

_STREAMS = {}  # device index -> the side stream every capture runs on
_WARM = set()  # device indices whose side stream has run an application


def _stream(index: int) -> torch.cuda.Stream:
    s = _STREAMS.get(index)
    if s is None:
        s = _STREAMS[index] = torch.cuda.Stream(index)
    return s


class _Half:
    """One half: its function on fixed input tensors, run directly or
    captured on the first call and replayed."""

    def __init__(self, fn, capture: bool):
        self.fn, self.capture = fn, capture
        self.graph = self.out = None

    def __call__(self, *inputs):
        if not self.capture:
            return self.fn(*inputs)
        if self.graph is None:
            self.out = self._capture(inputs)
        self.graph.replay()
        return self.out

    def _capture(self, inputs):
        device = inputs[0].device
        index = device.index if device.index is not None else torch.cuda.current_device()
        side = _stream(index)
        side.wait_stream(torch.cuda.current_stream(device))
        if index not in _WARM:
            # lazily made per-stream state (cuBLAS's workspace) is made
            # before the first capture on the side stream
            with torch.cuda.stream(side):
                self.fn(*inputs)
            _WARM.add(index)
        count("precond.capture")
        self.graph = torch.cuda.CUDAGraph()
        kernels.new_capture()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin()
                try:
                    out = self.fn(*inputs)
                finally:
                    self.graph.capture_end()
        finally:
            kernels.new_capture()
        torch.cuda.current_stream(device).wait_stream(side)
        return out


class GraphedPrecond:
    """``pc(r)`` for a ``BlockStokesPrecond`` with the ``inner_gmres``
    smoother, from the two halves above.  Returns a new tensor, as ``pc``
    does."""

    def __init__(self, pc: BlockStokesPrecond, capture: bool = True):
        self.pc, self.m = pc, pc.inner_iters_u
        self._head = _Half(pc.split_head, capture)
        self._tails = {}
        self._capture = capture
        self._r = self._y = None

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        with span("precond.graphed"):
            if self._r is None:
                self._r = torch.empty_like(r)
                self._y = r.new_zeros(self.m)
            self._r.copy_(r)
            ru, zp, V, hb = self._head(self._r)
            y, j = lsq(read(hb, "precond.lsq", "numpy"), self.m, 0.0, INNER_RTOL)
            if j:
                self._y[:j].copy_(torch.as_tensor(y, dtype=r.dtype))
            tail = self._tails.get(j)
            if tail is None:
                tail = self._tails[j] = _Half(functools.partial(self.pc.split_tail, j=j),
                                              self._capture)
            return tail(self._r, ru, zp, V, self._y).clone()

