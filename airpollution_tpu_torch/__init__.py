"""airpollution_tpu_torch: the PyTorch + CUDA port of airpollution_tpu.

The structured-mesh CRBE solve (Crouzeix-Raviart FEM, backward Euler or
Crank-Nicolson) on PyTorch tensors, on the uniform operator and on the
per-DOF canvas operator (variable winds, Robin walls, obstacles), with its
kernels written in CUDA C++ for Hopper (``csrc/``, built with ``nvcc`` on
first use). Entry points run on the CUDA card unless given ``device="cpu"``,
where every kernel is replaced by its plain PyTorch version.
"""

from airpollution_tpu_torch.mesh import Mesh, MeshData, create_mesh
from airpollution_tpu_torch.models.crbe import CRBESolver
from airpollution_tpu_torch.problems import (
    AdDifProblem,
    Domain,
    Problem,
    RotatingPlumeProblem,
    SquarePulseProblem,
)

__version__ = "0.1.0"

__all__ = [
    "AdDifProblem",
    "CRBESolver",
    "Domain",
    "Mesh",
    "MeshData",
    "Problem",
    "RotatingPlumeProblem",
    "SquarePulseProblem",
    "create_mesh",
]
