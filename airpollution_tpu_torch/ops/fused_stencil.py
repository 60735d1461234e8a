"""The family-layout stencil matvec as one kernel (kernel B3), PyTorch
counterpart of ``airpollution_tpu/ops/pallas_stencil.py``.

``y = A x`` with the 15 per-DOF coefficient grids of stencil.py: one
thread per output DOF reads its row's coefficients and the five
neighbours it couples to, on the unpadded family grids H (n x c), V (c x n)
and D (c x c) (``csrc/stencil_matvec.cu``). It is the inner operation of
the scan path with ``matvec_impl="pallas"``. The routing budget
(:func:`fits_vmem`) is the JAX package's, so that the same meshes take
this path in both packages.

On a CPU tensor the wrapper runs the plain version,
``stencil.stencil_matvec``.
"""

from __future__ import annotations

import ctypes

import torch

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops import stencil

KERNEL = _build.Kernel(
    "stencil_matvec", "stencil_matvec.cu",
    {torch.float32: "crbe_stencil_matvec_f32",
     torch.float64: "crbe_stencil_matvec_f64"},
    [ctypes.c_void_p] * 17 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)
THREADS = 256

# The JAX kernel's VMEM budget: 15 coefficient grids + 3 x-grids + 3
# y-grids in f32 under 12 MiB.
_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def fits_vmem(pattern, itemsize: int = 4) -> bool:
    n, c = pattern.n, pattern.c
    return (15 + 6) * (n * c) * itemsize < _VMEM_BUDGET_BYTES


def kernel_matvec(pattern, coeffs, x_fam, threads=THREADS):
    """One launch of B3 (CUDA tensors only)."""
    if not x_fam.is_cuda:
        raise ValueError("kernel_matvec needs CUDA tensors")
    n, c = pattern.n, pattern.c
    sizes = [n * c] * 5 + [c * n] * 5 + [c * c] * 5
    if len(coeffs) != 15 or any(
            g.numel() != size or g.dtype != x_fam.dtype
            or g.device != x_fam.device for g, size in zip(coeffs, sizes)):
        raise ValueError("need the 15 coefficient grids of the pattern, of "
                         "x's dtype and device")
    y = torch.empty_like(x_fam)
    P = _build.pointer
    KERNEL.launch(x_fam.dtype, *(P(g) for g in coeffs), P(x_fam), P(y),
                  pattern.n, threads, _build.current_stream())
    return y


def stencil_matvec_fused(pattern, coeffs, x_fam):
    """y = A @ x in family layout: kernel B3 on a CUDA tensor, the plain
    ``stencil.stencil_matvec`` on a CPU one."""
    if x_fam.is_cuda:
        return kernel_matvec(pattern, coeffs, x_fam)
    if x_fam.device.type != "cpu":
        raise ValueError(f"unsupported device {x_fam.device}")
    return stencil.stencil_matvec(pattern, coeffs, x_fam)
