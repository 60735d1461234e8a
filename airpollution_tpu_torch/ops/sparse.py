"""ELL sparse operators for the CR global matrices, PyTorch counterpart of
``airpollution_tpu/ops/sparse.py``.

Values and column indices as dense ``(n_rows, width)`` tensors; padding
slots hold value 0 and column 0. Dirichlet rows are applied once by
masking values.

Every product goes through :class:`EllMatvec`: kernel B7 (ops/gather.py)
on a CUDA tensor, its plain torch gather on a CPU one, with a gradient on
both. The CR pattern is structurally symmetric (rows i and j couple iff
their edges share a triangle), so ``A^T`` has the same columns and the
values ``vals.flatten()[tslot]``; the backward runs B7 over those. The
operator carries the kernel's int32 columns, checked once and bound to its
launch structure (``gather.KernelIndex``), and ``tslot``, built once per
pattern (:func:`ell_index`), so that no product casts, checks the
columns or transposes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from airpollution_tpu_torch.ops import gather


class EllIndex(NamedTuple):
    """The index tensors of one ELL pattern on one device."""

    cols: torch.Tensor  # (n_rows, width) int64, for torch's gathers
    cols32: torch.Tensor  # the same, int32, for kernel B7
    tslot: torch.Tensor  # (n_rows * width,) int64, see transpose_slots
    b7: gather.KernelIndex  # cols32, checked once, with B7's launch struct


class EllMatrix(NamedTuple):
    """Fixed-width sparse matrix: ``A[r, cols[r, k]] += vals[r, k]``.

    ``cols32``, ``tslot`` and ``b7`` (:class:`EllIndex`) are what kernel
    B7 and the backward need; an operator without them still multiplies
    on the CPU, and raises where they are needed."""

    vals: torch.Tensor  # (n_rows, width)
    cols: torch.Tensor  # (n_rows, width) int64
    cols32: Optional[torch.Tensor] = None
    tslot: Optional[torch.Tensor] = None
    b7: Optional[gather.KernelIndex] = None

    @property
    def n_rows(self) -> int:
        return self.vals.shape[-2]

    @property
    def width(self) -> int:
        return self.vals.shape[-1]


def transpose_slots(cols) -> np.ndarray:
    """``tslot``, (n * w,) int64: the flat slot of ``A[c, r]`` for each
    slot (r, k) with ``cols[r, k] = c``, and ``n * w`` (one past the end,
    a zero appended before the gather) for each padding slot, so that
    ``cat([vals.flatten(), 0])[tslot]`` are the values of ``A^T`` on the
    same columns. (``mesh/topology.build_ell_pattern`` gives the same map
    from the triangles; this one needs only the columns.)

    Padding (value 0, column 0, at the end of a short row) is told from a
    real column-0 entry by symmetry: row r couples to DOF 0 iff row 0
    holds column r, and then its first column-0 slot is the real one.
    Raises ValueError when the pattern is not structurally symmetric."""
    cols = np.asarray(cols, dtype=np.int64)
    n, width = cols.shape
    is0 = cols == 0
    couples0 = np.zeros(n, dtype=bool)
    couples0[cols[0]] = True  # row 0's padding only repeats column 0
    first0 = np.argmax(is0, axis=1)
    real = ~is0
    rows0 = np.nonzero(is0.any(axis=1) & couples0)[0]
    real[rows0, first0[rows0]] = True

    slots = np.flatnonzero(real)
    rows = slots // width
    c = cols.reshape(-1)[slots]
    tslot = np.full(n * width, n * width, dtype=np.int64)
    found = np.zeros(slots.size, dtype=bool)
    for k in range(width):  # row c's columns are unique: one hit at most
        hit = (cols[c, k] == rows) & real[c, k]
        tslot[slots[hit]] = c[hit] * width + k
        found |= hit
    if not found.all():
        raise ValueError("the ELL pattern is not structurally symmetric: "
                         "its transpose needs other columns")
    return tslot


def ell_index(cols, device, tslot=None) -> EllIndex:
    """The :class:`EllIndex` of host columns ``cols`` (n, w) on
    ``device``; ``tslot`` defaults to :func:`transpose_slots`."""
    cols = np.asarray(cols)
    if tslot is None:
        tslot = transpose_slots(cols)
    c64 = torch.as_tensor(cols.astype(np.int64), device=device)
    c32 = c64.to(torch.int32)
    return EllIndex(cols=c64, cols32=c32,
                    tslot=torch.as_tensor(np.asarray(tslot, dtype=np.int64),
                                          device=device),
                    b7=gather.KernelIndex(c32))


def _transposed_vals(vals, tslot):
    """Values of ``A^T`` on the same columns (per operator of a stack)."""
    flat = vals.reshape(vals.shape[:-2] + (-1,))
    pad = torch.zeros(flat.shape[:-1] + (1,), dtype=vals.dtype,
                      device=vals.device)
    return torch.cat([flat, pad], dim=-1)[..., tslot].reshape(vals.shape)


class EllMatvec(torch.autograd.Function):
    """``y = A x`` over values ``vals`` (n, w) with x (..., n), or a stack
    (K, n, w) with x (K, n), on the columns (n, w). The forward is kernel
    B7 on CUDA tensors and the plain gather on CPU ones; the backward is
    differentiable again:

    - x_bar = A^T y_bar, this Function over the transposed values, so B7
      runs transposed;
    - vals_bar[r, k] = y_bar[r] x[cols[r, k]] in torch ops, summed over
      the batch when one operator serves it.

    ``linalg._operator_jvp`` differentiates the vals gradient once more
    (create_graph) for forward-mode tangents, so nothing here may be
    once-differentiable. The forward-mode rule is ``A_dot x + A x_dot``.
    """

    @staticmethod
    def forward(ctx, vals, x, cols, b7, tslot):
        ctx.index = (cols, b7, tslot)
        ctx.save_for_backward(vals, x)
        ctx.save_for_forward(vals, x)
        return gather.matvec(vals, cols, b7, x)

    @staticmethod
    def backward(ctx, y_bar):
        vals, x = ctx.saved_tensors
        cols, b7, tslot = ctx.index
        x_bar = vals_bar = None
        if ctx.needs_input_grad[1]:
            if tslot is None:
                raise ValueError(
                    "the gradient in x needs the operator's transposition "
                    "map: build the operator on an index from "
                    "sparse.ell_index or MeshData.ell_index")
            x_bar = EllMatvec.apply(_transposed_vals(vals, tslot), y_bar,
                                    cols, b7, tslot)
        if ctx.needs_input_grad[0]:
            vals_bar = y_bar[..., None] * gather.gather_cols(x, cols)
            if vals_bar.dim() > vals.dim():  # one operator, a batch of x
                vals_bar = vals_bar.reshape((-1,) + vals.shape).sum(0)
        return vals_bar, x_bar, None, None, None

    @staticmethod
    def jvp(ctx, vals_dot, x_dot, *_):
        vals, x = ctx.saved_tensors
        cols, b7, _ = ctx.index
        y_dot = None
        if vals_dot is not None:
            y_dot = gather.matvec(vals_dot, cols, b7, x)
        if x_dot is not None:
            ax = gather.matvec(vals, cols, b7, x_dot)
            y_dot = ax if y_dot is None else y_dot + ax
        return y_dot


def ell_matvec(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x; ``x`` is (n,) or (..., n) (one operator applied to every
    row, e.g. every species)."""
    return EllMatvec.apply(A.vals, x, A.cols, A.b7, A.tslot)


def ell_matvec_stacked(A: EllMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y[k] = A_k @ X[k] for a stack of operators (:func:`stack_ell`:
    (K, n, width) values on one shared (n, width) column index) and a
    (K, n) X: one launch of kernel B7 for the whole stack."""
    return EllMatvec.apply(A.vals, X, A.cols, A.b7, A.tslot)


def stack_ell(mats) -> EllMatrix:
    """A stack of operators on one pattern: the values stacked along a new
    leading axis, the pattern's index (int64 and int32 columns, the
    transposition map) kept once and shared by every operator; kernel B7
    reads the shared columns for every operator
    (``gather.KernelIndex(stack=)``).
    Raises ValueError when the operators' patterns differ."""
    first = mats[0]
    for m in mats[1:]:
        same = (m.cols is first.cols or torch.equal(m.cols, first.cols))
        if first.tslot is not None:
            same = same and m.tslot is not None and (
                m.tslot is first.tslot or torch.equal(m.tslot, first.tslot))
        if not same:
            raise ValueError("stacked operators must share one pattern")
    cols32 = first.cols32
    return EllMatrix(torch.stack([m.vals for m in mats]), first.cols, cols32,
                     first.tslot,
                     None if cols32 is None
                     else gather.KernelIndex(cols32, stack=len(mats)))


def unstack_ell(A: EllMatrix, k: int) -> EllMatrix:
    """Operator ``k`` of a stack, on the stack's columns with a launch
    index of its own."""
    cols32 = A.cols32
    return EllMatrix(A.vals[k], A.cols, cols32, A.tslot,
                     None if cols32 is None else gather.KernelIndex(cols32))


def ell_from_entries(entry_vals, entry_to_slot, index: EllIndex) -> EllMatrix:
    """Assemble an ELL matrix on the pattern ``index`` from flattened
    local-matrix entries and their precomputed flat slots (one
    scatter-add)."""
    n_rows, width = index.cols.shape
    flat = torch.zeros(n_rows * width, dtype=entry_vals.dtype,
                       device=entry_vals.device)
    flat.index_add_(0, entry_to_slot, entry_vals)
    return EllMatrix(flat.reshape(n_rows, width), *index)


def ell_diagonal(A: EllMatrix, diag_slot) -> torch.Tensor:
    """Diagonal from precomputed flat diagonal slots."""
    return A.vals.reshape(-1)[diag_slot]


def ell_mask_dirichlet_rows(A: EllMatrix, boundary_mask, diag_slot) -> EllMatrix:
    """Replace Dirichlet rows by identity rows, once."""
    vals = torch.where(boundary_mask[:, None], torch.zeros_like(A.vals),
                       A.vals)
    flat = vals.reshape(-1).clone()
    flat[diag_slot] = torch.where(boundary_mask,
                                  torch.ones_like(flat[diag_slot]),
                                  flat[diag_slot])
    return A._replace(vals=flat.reshape(A.vals.shape))
