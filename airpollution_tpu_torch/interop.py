"""Carry an assembled operator over from numpy arrays.

The port has no weights; what two implementations must share to be
compared step for step is the assembled operator, its Chebyshev interval
and the initial state. ``operators_from_numpy`` builds this package's
``GlobalOperators`` from plain arrays, for example those of another
implementation's assembly, so both can run on one operator; hand the
interval to ``CRBESolver(cheb_bounds=...)`` and the operator to
``CRBESolver.set_operators``. ``canvas_operator_from_numpy`` does the same
for the per-DOF canvas operator that the fused canvas kernels take.
"""

from __future__ import annotations

import numpy as np
import torch

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.models.crbe import GlobalOperators
from airpollution_tpu_torch.ops.sparse import EllMatrix


def operators_from_numpy(*, mass_diag, stiffness, advection, ka, system,
                         system_diag, dtype=None,
                         device=None) -> GlobalOperators:
    """``GlobalOperators`` from numpy arrays; each ELL operator is a
    ``(vals, cols)`` pair of (n_seg, width) arrays. ``dtype`` defaults to
    the arrays' own, ``device`` to the CUDA card."""
    device = resolve_device(device)

    def real(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def ell(pair):
        vals, cols = pair
        return EllMatrix(
            vals=real(vals),
            cols=torch.tensor(np.asarray(cols, dtype=np.int64),
                              device=device),
        )

    return GlobalOperators(
        mass_diag=real(mass_diag),
        stiffness=ell(stiffness),
        advection=ell(advection),
        ka=ell(ka),
        system=ell(system),
        system_diag=real(system_diag),
    )


def canvas_operator_from_numpy(*, coeffs, mass_fam, inv_diag_fam,
                               dtype=None, device=None):
    """The canvas operator of the fused canvas kernels (B4, B5) from numpy
    arrays, in family layout: the 15 coefficient grids of the masked
    system (H rows (n, c), V rows (c, n), D rows (c, c)), the masked mass
    and the inverse system diagonal. Returns ``(coeffs, mass_fam,
    inv_diag_fam)`` as tensors, ready for fused_hbm.fused_solve_canvas_hbm
    or fused_solver.fused_solve."""
    device = resolve_device(device)

    def real(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    if len(coeffs) != 15:
        raise ValueError("a canvas operator has 15 coefficient grids")
    return tuple(real(g) for g in coeffs), real(mass_fam), real(inv_diag_fam)
