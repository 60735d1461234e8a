"""ELL sparse operators for the CR global matrices, PyTorch counterpart of
``airpollution_tpu/ops/sparse.py``.

Values and column indices as dense ``(n_rows, width)`` tensors; padding
slots hold value 0 and column 0. Dirichlet rows are applied once by
masking values.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EllMatrix(NamedTuple):
    """Fixed-width sparse matrix: ``A[r, cols[r, k]] += vals[r, k]``."""

    vals: torch.Tensor  # (n_rows, width)
    cols: torch.Tensor  # (n_rows, width) int64

    @property
    def n_rows(self) -> int:
        return self.vals.shape[0]

    @property
    def width(self) -> int:
        return self.vals.shape[1]


def ell_matvec(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: one gather, multiply and row sum. ``x`` is (n,) or
    (..., n) (one operator applied to every row, e.g. every species)."""
    return torch.sum(A.vals * x[..., A.cols], dim=-1)


def ell_matvec_stacked(A: EllMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y[k] = A_k @ X[k] for a stack of operators with (K, n, width)
    values and columns, and a (K, n) X."""
    K, n, width = A.cols.shape
    g = torch.gather(X, 1, A.cols.reshape(K, n * width)).reshape(K, n, width)
    return torch.sum(A.vals * g, dim=-1)


def ell_from_entries(entry_vals, entry_to_slot, cols) -> EllMatrix:
    """Assemble an ELL matrix from flattened local-matrix entries and their
    precomputed flat slots (one scatter-add)."""
    n_rows, width = cols.shape
    flat = torch.zeros(n_rows * width, dtype=entry_vals.dtype,
                       device=entry_vals.device)
    flat.index_add_(0, entry_to_slot, entry_vals)
    return EllMatrix(vals=flat.reshape(n_rows, width), cols=cols)


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
    return EllMatrix(vals=flat.reshape(A.vals.shape), cols=A.cols)
