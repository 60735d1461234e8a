"""airpollution_tpu_torch: the PyTorch + CUDA port of airpollution_tpu.

The CRBE solve (Crouzeix-Raviart FEM, backward Euler or Crank-Nicolson) on
PyTorch tensors: on structured meshes with the uniform operator and the
per-DOF canvas operator (variable winds, Robin walls, obstacles), on
general meshes (unstructured, gmsh ``.msh`` files, mirrored grids) with
the ELL operator, and the multi-species chemistry-transport solve
(``MultiSpeciesSolver``), and the physics-informed network solver
(``PINN``: sampling, residual autodiff, Adam and L-BFGS training), with
the solves' kernels written in CUDA C++ for Hopper
(``csrc/``, built with ``nvcc`` on first use). Entry points run on the
CUDA card unless given ``device="cpu"``, where every kernel is replaced by
its plain PyTorch version.
"""

from airpollution_tpu_torch.mesh import (Mesh, MeshData, create_mesh,
                                        create_unstructured_mesh, read_msh,
                                        write_msh)
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.models.multispecies import MultiSpeciesSolver
from airpollution_tpu_torch.models.pinn import PINN
from airpollution_tpu_torch.ops.fused_hbm import fused_multispecies_canvas_hbm
from airpollution_tpu_torch.problems import (
    AdDifProblem,
    Domain,
    GaussianSourceProblem,
    MultiSpeciesProblem,
    Problem,
    RotatingPlumeProblem,
    SquarePulseProblem,
)

__version__ = "0.1.0"

__all__ = [
    "AdDifProblem",
    "CRBESolver",
    "Domain",
    "GaussianSourceProblem",
    "Mesh",
    "MeshData",
    "MultiSpeciesProblem",
    "MultiSpeciesSolver",
    "PINN",
    "Problem",
    "RotatingPlumeProblem",
    "SquarePulseProblem",
    "create_mesh",
    "create_unstructured_mesh",
    "fused_multispecies_canvas_hbm",
    "read_msh",
    "write_msh",
]
