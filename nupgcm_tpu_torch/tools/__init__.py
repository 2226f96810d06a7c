"""Measurement tools of the port, run on a CUDA device as
``python -m nupgcm_tpu_torch.tools.<name>``:

* ``profile_matvec`` -- the saddle matvec split into streaming (K3),
  compute (pinned K1) and the production kernel;
* ``profile_stream`` -- device-memory streaming rate by tile size (K4);
* ``profile_step`` -- the timestep split into evolve, invert and advection;
* ``sweep_inner`` -- steps/s over saddle-coarse inner budgets.

Each has ``run(...)``, which returns its results and also runs on the
CPU at small sizes (the kernels' plain versions), and ``main()``, which
raises without CUDA.

Beside them: ``production`` and ``northstar`` (the full-physics runs),
``eigen`` (ARPACK spectra of the model's operators through SciPy
``LinearOperator``s whose matvecs run on the model's device) and
``column`` (the 1D sloped-column model, NumPy).
"""
