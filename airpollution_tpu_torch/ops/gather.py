"""The ELL gather SpMV as one kernel (kernel B7), PyTorch counterpart of
``airpollution_tpu/ops/pallas_gather.py``.

``y[r] = sum_k vals[r, k] * x[cols[r, k]]``: one thread per output row
reads its row's values and int32 columns and gathers x through the
read-only cache (``csrc/ell_gather.cu``). A second grid dimension runs a
batch of right-hand sides, over one shared operator or over a stack of
operators. It is the matvec of every general-mesh (ELL) solve, reached
through ``ops/sparse.ell_matvec`` and ``ell_matvec_stacked``, whose
backward runs it again over the transposed values.

On a CPU tensor every entry point runs the plain version,
:func:`plain_matvec` (one torch gather, multiply and row sum).
"""

from __future__ import annotations

import ctypes

import torch

from airpollution_tpu_torch import _build

KERNEL = _build.Kernel(
    "ell_gather", "ell_gather.cu",
    {torch.float32: "crbe_ell_gather_f32",
     torch.float64: "crbe_ell_gather_f64"},
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
)
THREADS = 256
# 16 blocks of 256 threads on each of the H100's 132 SMs; larger
# operators take the grid-stride loop.
MAX_BLOCKS = 132 * 16


def fits_vmem(n: int, dtype_bytes: int = 4,
              budget_bytes: int = 64 * 1024 * 1024) -> bool:
    """The JAX package's VMEM residency test for the state vector (half
    the TPU core's 128 MB). Kept for parity; nothing routes on it."""
    return n * dtype_bytes * 2 <= budget_bytes


def gather_cols(x, cols):
    """``x[..., cols]`` for one operator's int64 ``cols`` (n, w) and x
    (..., n); per operator for a stack (B, n, w) and x (B, n)."""
    if cols.dim() == 2:
        return x[..., cols]
    K, n, width = cols.shape
    return torch.gather(x, 1, cols.reshape(K, n * width)).reshape(K, n,
                                                                   width)


def plain_matvec(vals, cols, x):
    """The plain version: ``vals`` and int64 ``cols`` (n, w) with x
    (..., n), or a stack (B, n, w) with x (B, n)."""
    return torch.sum(vals * gather_cols(x, cols), dim=-1)


def kernel_matvec(vals, cols32, x):
    """One launch of B7 (CUDA tensors only): ``vals`` and int32 ``cols32``
    (n, w) with x (..., n), or a stack (B, n, w) with x (B, n)."""
    if not x.is_cuda:
        raise ValueError("kernel_matvec needs CUDA tensors")
    if vals.dim() not in (2, 3) or cols32.shape != vals.shape:
        raise ValueError("vals and cols must be (n, w) or (B, n, w) alike")
    if cols32.dtype != torch.int32:
        raise ValueError("kernel B7 takes int32 columns")
    if (vals.dtype != x.dtype or vals.device != x.device
            or cols32.device != x.device):
        raise ValueError("vals, cols and x must share x's device, and vals "
                         "x's dtype")
    n, width = vals.shape[-2:]
    if x.shape[-1] != n:
        raise ValueError(f"x has {x.shape[-1]} rows, the operator {n}")
    if vals.dim() == 2:
        op_stride = 0
        xb = x.reshape(-1, n).contiguous()
    else:
        if x.shape != vals.shape[:2]:
            raise ValueError("a stack of B operators takes x of shape (B, n)")
        op_stride = n * width
        xb = x.contiguous()
    y = torch.empty_like(xb)
    P = _build.pointer
    KERNEL.launch(x.dtype, P(vals), P(cols32), P(xb), P(y), n, width,
                  xb.shape[0], op_stride, THREADS, MAX_BLOCKS,
                  _build.current_stream())
    return y.reshape(x.shape)


def matvec(vals, cols, cols32, x):
    """B7 on a CUDA tensor, the plain version on a CPU one."""
    if x.is_cuda:
        if cols32 is None:
            raise ValueError(
                "kernel B7 needs the operator's int32 columns: build the "
                "operator on an index from sparse.ell_index or "
                "MeshData.ell_index")
        return kernel_matvec(vals, cols32, x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return plain_matvec(vals, cols, x)


def ell_matvec_vmem(A, x, *, block_rows: int = 2048):
    """``y = A @ x`` (an ``sparse.EllMatrix``), the entry point of the JAX
    package's row-block kernel: kernel B7 on a CUDA tensor. ``block_rows``
    is checked as the JAX function checks it; B7's blocks are its own."""
    if block_rows % 128:
        raise ValueError("block_rows must be a multiple of 128")
    return matvec(A.vals, A.cols, A.cols32, x)


def ell_matvec_vmem_roll(A, x):
    """``y = A @ x``, the entry point of the JAX package's roll+gather
    kernel: the same kernel B7 (a CUDA thread gathers any address, so the
    TPU's lane rolls have no counterpart)."""
    return matvec(A.vals, A.cols, A.cols32, x)
