"""Kernels and operators of the port: sparse ELL operators and the
iterative solvers are exported as the JAX package's
``airpollution_tpu.ops`` exports them. Importing builds no kernel."""

from airpollution_tpu_torch.ops.linalg import (
    SolveResult,
    bicgstab,
    cg,
    gmres,
    jacobi_preconditioner,
)
from airpollution_tpu_torch.ops.sparse import (
    EllMatrix,
    ell_diagonal,
    ell_from_entries,
    ell_mask_dirichlet_rows,
    ell_matvec,
)

__all__ = [
    "EllMatrix", "ell_diagonal", "ell_from_entries",
    "ell_mask_dirichlet_rows", "ell_matvec",
    "SolveResult", "bicgstab", "cg", "gmres", "jacobi_preconditioner",
]
