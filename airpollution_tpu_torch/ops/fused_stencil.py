"""The family-layout stencil matvec as one kernel (kernel B3), PyTorch
counterpart of ``airpollution_tpu/ops/pallas_stencil.py``.

``y = A x`` with the 15 per-DOF coefficient grids of stencil.py: one
thread per output DOF reads its row's coefficients and the five
neighbours it couples to, on the unpadded family grids H (n x c), V (c x n)
and D (c x c) (``csrc/stencil_matvec.cu``). It is the inner operation of
the scan path with ``matvec_impl="pallas"``. The routing budget
(:func:`fits_vmem`) is the JAX package's, so that the same meshes take
this path in both packages.

:class:`StencilOperator` binds the kernel to one operator's coefficients
once: it checks the grids and builds the host structure the kernel reads
(their pointers and n), so that a product checks only ``x`` and makes one
four-argument launch. ``stencil.family_operators`` builds one per solve.
On a CPU tensor the operator, and :func:`stencil_matvec_fused`, run the
plain version, ``stencil.stencil_matvec``.
"""

from __future__ import annotations

import ctypes

import torch

from airpollution_tpu_torch import _build
from airpollution_tpu_torch.ops import stencil


class _Operator(ctypes.Structure):
    """``crbe::StencilOperator``: the coefficient pointers and n, read by
    the launcher on the host."""

    _fields_ = [("coefs", ctypes.c_void_p * 15), ("n", ctypes.c_int)]


KERNEL = _build.Kernel(
    "stencil_matvec", "stencil_matvec.cu",
    {torch.float32: "crbe_stencil_matvec_f32",
     torch.float64: "crbe_stencil_matvec_f64"},
    [ctypes.POINTER(_Operator)] + [ctypes.c_void_p] * 3)

# The JAX kernel's VMEM budget: 15 coefficient grids + 3 x-grids + 3
# y-grids in f32 under 12 MiB.
_VMEM_BUDGET_BYTES = 12 * 1024 * 1024


def fits_vmem(pattern, itemsize: int = 4) -> bool:
    n, c = pattern.n, pattern.c
    return (15 + 6) * (n * c) * itemsize < _VMEM_BUDGET_BYTES


class StencilOperator:
    """Kernel B3 bound to one operator's 15 coefficient grids.

    Built once per coefficient tuple: it checks the grids' sizes, dtype,
    device and contiguity, and, for CUDA grids, fills the host structure
    the kernel reads (their pointers and n). It keeps the grids, so the
    pointers stay valid while it lives. Calling it with x
    gives A x: one launch on a CUDA x, the plain version on a CPU one.
    """

    def __init__(self, pattern, coeffs):
        n, c = pattern.n, pattern.c
        coeffs = tuple(coeffs)
        sizes = [n * c] * 10 + [c * c] * 5
        if len(coeffs) != 15:
            raise ValueError(f"need the 15 coefficient grids, got "
                             f"{len(coeffs)}")
        dtype, device = coeffs[0].dtype, coeffs[0].device
        for g, size in zip(coeffs, sizes):
            if g.numel() != size:
                raise ValueError(f"a coefficient grid has {g.numel()} "
                                 f"entries, the pattern needs {size}")
            if g.dtype != dtype or g.device != device:
                raise ValueError("the coefficient grids must share one "
                                 "dtype and device")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"kernel B3 takes float32 or float64, not "
                             f"{dtype}")
        self.pattern = pattern
        self.coeffs = coeffs
        self.dtype = dtype
        self.size = 2 * n * c + c * c
        self._device = coeffs[0].get_device()
        self._op = None
        if coeffs[0].is_cuda:
            op = _Operator(n=n)
            for t, g in enumerate(coeffs):
                op.coefs[t] = _build.pointer(g)
            self._op = ctypes.pointer(op)

    def __call__(self, x):
        if x.is_cuda:
            if (x.dtype != self.dtype or x.get_device() != self._device
                    or x.dim() != 1 or x.shape[0] != self.size):
                raise ValueError(
                    f"kernel B3 takes x of shape ({self.size},), dtype "
                    f"{self.dtype} and the coefficients' device; got "
                    f"{tuple(x.shape)}, {x.dtype}, {x.device}")
            y = torch.empty_like(x)
            KERNEL.launch(self.dtype, self._op, _build.pointer(x),
                          y.data_ptr(), _build.current_stream())
            return y
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return stencil.stencil_matvec(self.pattern, self.coeffs, x)

    def matvec(self, x, *coeffs):
        """``A(coeffs) x`` with ``coeffs`` this operator's grids or
        detached views of them (a ``linalg.BoundMatvec``'s params): the
        bound kernel on CUDA, the plain version, differentiable in the
        grids, on the CPU."""
        if x.is_cuda:
            return self(x)
        return stencil.stencil_matvec(self.pattern, coeffs, x)


def stencil_matvec_fused(pattern, coeffs, x_fam):
    """y = A @ x in family layout: kernel B3 on a CUDA tensor, bound for
    this one call (a solve binds once, :class:`StencilOperator`), the
    plain ``stencil.stencil_matvec`` on a CPU one."""
    if x_fam.is_cuda:
        return StencilOperator(pattern, coeffs)(x_fam)
    if x_fam.device.type != "cpu":
        raise ValueError(f"unsupported device {x_fam.device}")
    return stencil.stencil_matvec(pattern, coeffs, x_fam)
