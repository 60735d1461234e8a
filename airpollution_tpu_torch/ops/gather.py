"""The ELL gather SpMV as one kernel (kernel B7), PyTorch counterpart of
``airpollution_tpu/ops/pallas_gather.py``.

``y[r] = sum_k vals[r, k] * x[cols[r, k]]``: one thread per output row
reads its row's values and int32 columns and gathers x through the
read-only cache (``csrc/ell_gather.cu``). A second grid dimension runs
a batch of right-hand sides, over one shared operator or over a stack of
operators; a stack shares one pattern, so it keeps one (n, w) column
index, which the kernel reads for every operator. It is the matvec of every
general-mesh (ELL) solve and of the ensembles' member batches, reached
through ``ops/sparse.ell_matvec`` and ``ell_matvec_stacked``, whose
backward runs it again over the transposed values. The int32 columns are
checked once, when the operator's index is built (:class:`KernelIndex`),
so a product checks x and the values and makes one six-argument launch.

On a CPU tensor every entry point runs the plain version,
:func:`plain_matvec` (one torch gather, multiply and row sum).
"""

from __future__ import annotations

import ctypes

import torch

from airpollution_tpu_torch import _build


class _Index(ctypes.Structure):
    """``crbe::EllIndex``: the int32 columns and what a product's launch
    takes from them."""

    _fields_ = [("cols", ctypes.c_void_p), ("n", ctypes.c_int),
                ("width", ctypes.c_int), ("op_stride", ctypes.c_longlong)]


KERNEL = _build.Kernel(
    "ell_gather", "ell_gather.cu",
    {torch.float32: "crbe_ell_gather_f32",
     torch.float64: "crbe_ell_gather_f64"},
    [ctypes.POINTER(_Index)] + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_void_p],
)


def fits_vmem(n: int, dtype_bytes: int = 4,
              budget_bytes: int = 64 * 1024 * 1024) -> bool:
    """The JAX package's VMEM residency test for the state vector (half
    the TPU core's 128 MB). Kept for parity; nothing routes on it."""
    return n * dtype_bytes * 2 <= budget_bytes


def gather_cols(x, cols):
    """``x[..., cols]`` for int64 ``cols`` (n, w) and x (..., n): every
    row of x gathered on the one index, as one operator over a batch and
    a stack of operators over its members both need. No copy of the
    columns is made."""
    return x[..., cols]


def plain_matvec(vals, cols, x):
    """The plain version: ``vals`` (n, w) with x (..., n), or a stack
    (B, n, w) with x (B, n), on the int64 ``cols`` (n, w)."""
    return torch.sum(vals * gather_cols(x, cols), dim=-1)


class KernelIndex:
    """Kernel B7's view of one pattern's int32 columns (n, w): checked
    once, with the launch structure built from them (their pointer, n, w
    and the value stride). ``stack=B`` makes it the index of a stack of B
    operators on that pattern: values (B, n, w) at a stride of n * w, the
    columns shared by all of them. It keeps the columns, so the pointer stays
    valid while it lives; a copy or a pickle binds the copied columns
    anew. ``sparse.ell_index``, ``stack_ell`` and ``unstack_ell`` build
    one per index."""

    def __init__(self, cols32, stack=None):
        if cols32.dtype != torch.int32:
            raise ValueError("kernel B7 takes int32 columns")
        if cols32.dim() != 2 or not cols32.is_contiguous():
            raise ValueError("kernel B7's columns must be a contiguous "
                             "(n, w) tensor")
        n, width = cols32.shape
        self.cols32 = cols32
        self.stack = stack
        self.shape = cols32.shape if stack is None \
            else torch.Size((stack, n, width))
        self.device = cols32.get_device()
        self.struct = ctypes.pointer(_Index(
            cols=cols32.data_ptr(), n=n, width=width,
            op_stride=0 if stack is None else n * width))

    def __reduce__(self):
        return KernelIndex, (self.cols32, self.stack)


def kernel_matvec(vals, index, x):
    """One launch of B7 (CUDA tensors only): ``vals`` on the columns of
    ``index`` (a :class:`KernelIndex`), (n, w) with x (..., n), or a
    stack (B, n, w) with x (B, n). The columns were checked when the index
    was built; a product checks x and vals."""
    if not x.is_cuda:
        raise ValueError("kernel_matvec needs CUDA tensors")
    shape, device = index.shape, index.device
    if vals.shape != shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols "
                         f"{tuple(shape)} differ")
    if (vals.dtype != x.dtype or vals.get_device() != device
            or x.get_device() != device):
        raise ValueError("vals, cols and x must share x's device, and vals "
                         "x's dtype")
    n = shape[-2]
    if x.shape[-1] != n:
        raise ValueError(f"x has {x.shape[-1]} rows, the operator {n}")
    if len(shape) == 2:
        batch = x.numel() // n  # x (..., n) is a (batch, n) block
    else:
        if x.shape != shape[:2]:
            raise ValueError("a stack of B operators takes x of shape (B, n)")
        batch = shape[0]
    xb = x.contiguous()
    y = torch.empty_like(xb)
    KERNEL.launch(x.dtype, index.struct, _build.pointer(vals),
                  xb.data_ptr(), y.data_ptr(), batch,
                  _build.current_stream())
    return y


def matvec(vals, cols, index, x):
    """B7 on a CUDA tensor (on the columns of ``index``, a
    :class:`KernelIndex`), the plain version on a CPU one."""
    if x.is_cuda:
        if index is None:
            raise ValueError(
                "kernel B7 needs the operator's int32 columns: build the "
                "operator on an index from sparse.ell_index or "
                "MeshData.ell_index")
        return kernel_matvec(vals, index, x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return plain_matvec(vals, cols, x)


def rows_matvec(vals, cols, index, x):
    """``y = A[rows] @ x`` of a block of an operator's rows: ``vals`` and
    ``cols`` (n_rows, w) of those rows, their columns into the whole
    vector ``x`` (N,). One launch of B7 on a CUDA tensor (the kernel's
    rows run to the index's n, its one x is read at the columns), the
    plain version on a CPU one."""
    if x.dim() != 1:
        raise ValueError("a row block multiplies one vector x (N,)")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return plain_matvec(vals, cols, x)
    if index is None or tuple(vals.shape) != tuple(index.shape):
        raise ValueError("kernel B7 needs the row block's int32 columns "
                         "(a KernelIndex of vals' shape)")
    if (vals.dtype != x.dtype or vals.get_device() != index.device
            or x.get_device() != index.device):
        raise ValueError("vals, cols and x must share x's device, and vals "
                         "x's dtype")
    xb = x.contiguous()
    y = torch.empty(vals.shape[0], dtype=x.dtype, device=x.device)
    KERNEL.launch(x.dtype, index.struct, _build.pointer(vals),
                  xb.data_ptr(), y.data_ptr(), 1, _build.current_stream())
    return y


def ell_matvec_vmem(A, x, *, block_rows: int = 2048):
    """``y = A @ x`` (an ``sparse.EllMatrix``), the entry point of the JAX
    package's row-block kernel: kernel B7 on a CUDA tensor. ``block_rows``
    is checked as the JAX function checks it; B7's blocks are its own."""
    if block_rows % 128:
        raise ValueError("block_rows must be a multiple of 128")
    return matvec(A.vals, A.cols, A.b7, x)


def ell_matvec_vmem_roll(A, x):
    """``y = A @ x``, the entry point of the JAX package's roll+gather
    kernel: the same kernel B7 (a CUDA thread gathers any address, so the
    TPU's lane rolls have no counterpart)."""
    return matvec(A.vals, A.cols, A.b7, x)
