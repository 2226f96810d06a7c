"""nupgcm_tpu_torch: the planetary-geostrophic ocean model in PyTorch.

The PyTorch counterpart of ``nupgcm_tpu`` for one NVIDIA H100:
continuous-Galerkin P2-P1 Taylor-Hood finite elements on unstructured
tri/tet meshes solving the nondimensional PG equations -- a
rotating-Stokes inversion (FGMRES) and an implicit-diffusion /
explicit-advection buoyancy evolution (CG).  Every element-local
operator application runs through hand-written CUDA kernels
(``csrc/element_matvec.cu``) on a CUDA device and through their plain
PyTorch versions on the CPU.

Same public entry points as ``nupgcm_tpu``; ``PGModel`` takes
``device=`` and ``dtype=``.
"""

from .mesh import generators
from .mesh.core import Mesh
from .mesh.gmsh_reader import read_msh
from .mesh.writer import write_msh
from .models.config import (
    ConvectionParameterization,
    EddyParameterization,
    Forcings,
    Parameters,
    SurfaceDirichletBC,
    SurfaceFluxBC,
)
from .models.fedata import FEData, Spaces
from .models.model import BlowUpError, PGModel, State
from .models.timesteppers import BDF1, BDF2
from .utils.timing import memory_status, print_memory_status
from . import plotting, postprocess

__version__ = "0.1.0"
__all__ = [
    "Parameters", "Forcings", "SurfaceDirichletBC", "SurfaceFluxBC",
    "ConvectionParameterization", "EddyParameterization",
    "Spaces", "FEData", "PGModel", "State", "BlowUpError",
    "BDF1", "BDF2", "Mesh", "read_msh", "write_msh", "generators",
    "plotting", "postprocess", "memory_status", "print_memory_status",
]
