"""Carry an assembled operator over from numpy arrays.

The port has no weights; what two implementations must share to be
compared step for step is the assembled operator, its Chebyshev interval
and the initial state. ``operators_from_numpy`` builds this package's
``GlobalOperators`` from plain arrays, for example those of another
implementation's assembly, so both can run on one operator; hand the
interval to ``CRBESolver(cheb_bounds=...)`` and the operator to
``CRBESolver.set_operators``. ``stacked_operators_from_numpy`` stacks
per-species operators for ``MultiSpeciesSolver.set_operators``, and
``canvas_operator_from_numpy`` carries the per-DOF canvas operator that
the fused canvas kernels take. ``params_from_numpy`` carries a parameter
pytree (a dict of arrays) into the dict of tensors that the port's
diagnostics/inverse.py takes, so that both packages start a fit or a
posterior from the same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.models.crbe import GlobalOperators
from airpollution_tpu_torch.models.multispecies import stack_operators
from airpollution_tpu_torch.ops.sparse import EllMatrix, ell_index


def operators_from_numpy(*, mass_diag, stiffness, advection, ka, system,
                         system_diag, dtype=None,
                         device=None) -> GlobalOperators:
    """``GlobalOperators`` from numpy arrays; each ELL operator is a
    ``(vals, cols)`` pair of (n_seg, width) arrays, and gets its int32
    columns and transposition map (ops/sparse.ell_index) once per
    pattern. ``dtype`` defaults to the arrays' own, ``device`` to the CUDA
    card."""
    device = resolve_device(device)

    def real(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    index = {}

    def ell(pair):
        vals, cols = pair
        cols = np.asarray(cols)
        key = cols.tobytes()  # the four operators share one pattern
        if key not in index:
            index[key] = ell_index(cols, device)
        return EllMatrix(real(vals), *index[key])

    return GlobalOperators(
        mass_diag=real(mass_diag),
        stiffness=ell(stiffness),
        advection=ell(advection),
        ka=ell(ka),
        system=ell(system),
        system_diag=real(system_diag),
    )


def stacked_operators_from_numpy(species_ops, *, dtype=None, device=None):
    """Per-species operators stacked along a leading species axis, the
    layout of a multi-species solve whose species do not share (v, D):
    ``species_ops`` is one dict of :func:`operators_from_numpy` keyword
    arrays per species."""
    return stack_operators([
        operators_from_numpy(**ops, dtype=dtype, device=device)
        for ops in species_ops
    ])


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


def params_from_numpy(params, *, dtype=None, device=None,
                      requires_grad: bool = False):
    """A parameter pytree, a dict of numpy arrays (as
    ``{k: np.asarray(v) for k, v in params.items()}`` gives it), as a dict
    of tensors of the same shapes. ``dtype`` defaults to each array's own,
    ``device`` to the CUDA card; ``requires_grad`` makes every value a leaf
    of autograd."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device,
                            requires_grad=requires_grad)
            for k, v in params.items()}
