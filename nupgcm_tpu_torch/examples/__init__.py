"""Examples of the port, run as ``python -m nupgcm_tpu_torch.examples.<name>``
with ``--device`` (default ``cuda``) and ``--dtype``: ``bowl_mixing``,
``channel_spinup``, ``sphere`` and ``convergence``.  Each follows the
JAX package's ``examples/<name>.py`` step for step and writes the same
output files."""

import argparse

import torch


def device_args(ap: argparse.ArgumentParser, dtype: str = "float32") -> None:
    """The ``--device`` and ``--dtype`` options every example takes."""
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' needs a card and raises without one")
    ap.add_argument("--dtype", default=dtype, choices=("float32", "float64"))


def dtype_of(args) -> torch.dtype:
    return getattr(torch, args.dtype)
