"""The PyTorch port imports no JAX (checked in a fresh interpreter)."""

import pathlib
import subprocess
import sys


def test_port_imports_without_jax():
    code = ("import sys\n"
            "import nupgcm_tpu_torch\n"
            "from nupgcm_tpu_torch.models import model\n"
            "from nupgcm_tpu_torch.ops import build, kernels\n"
            "from nupgcm_tpu_torch.tools import (_common, northstar, production,\n"
            "                                    profile_matvec, profile_step,\n"
            "                                    profile_stream, sweep_inner)\n"
            "from nupgcm_tpu_torch.io import checkpoint, vtk\n"
            "from nupgcm_tpu_torch.mesh import generators, gmsh_reader, quality, writer\n"
            "from nupgcm_tpu_torch.utils import misc, pointeval, timing\n"
            "from nupgcm_tpu_torch import plotting, postprocess\n"
            "from nupgcm_tpu_torch.tools import column, eigen\n"
            "from nupgcm_tpu_torch.parallel import comm, dd\n"
            "from nupgcm_tpu_torch.tools import multihost_dryrun\n"
            "from nupgcm_tpu_torch.examples import (bowl_mixing, channel_spinup,\n"
            "                                       convergence, sphere)\n"
            "from nupgcm_tpu_torch.solvers.preconditioners import (CoarseCorrection,\n"
            "                                                      const_diag, jacobi)\n"
            "from nupgcm_tpu_torch.fem.assembly import MatrixPlan, build_matrix_plan\n"
            "from nupgcm_tpu_torch.ops.sparse import COOMatrix, ELLMatrix, coo_from_plan\n"
            "from nupgcm_tpu_torch.utils import precision\n"
            "from nupgcm_tpu_torch.io import gridap, jld2\n"
            "from nupgcm_tpu_torch.tools import kernel_bench, measure_l2, trace_check\n"
            "assert 'h5py' not in sys.modules\n"
            "assert 'matplotlib' not in sys.modules\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
            "assert 'nupgcm_tpu' not in sys.modules\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
