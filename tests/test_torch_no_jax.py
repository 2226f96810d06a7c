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
            "from nupgcm_tpu_torch.io import checkpoint\n"
            "from nupgcm_tpu_torch.mesh import generators, quality\n"
            "from nupgcm_tpu_torch.utils import timing\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
            "assert 'nupgcm_tpu' not in sys.modules\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
