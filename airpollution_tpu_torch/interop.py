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
posterior from the same parameters. ``pinn_params_from_numpy`` builds
the PINN's network (models/pinn.MLP) from the JAX package's parameter
list, and ``pinn_params_from_file`` from a ``pinn_*.npz`` params file
that the JAX package's ``save_pinn`` wrote, so that both packages compute
from the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.models.crbe import GlobalOperators
from airpollution_tpu_torch.models.multispecies import stack_operators
from airpollution_tpu_torch.models.pinn import MLP
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


def pinn_params_from_numpy(params, activation="adaptive_tanh", *,
                           dtype=None, device=None) -> MLP:
    """The network of a JAX-layout parameter list: ``[{"B": (in, m)}]``
    first where there is a Fourier embedding, then one dict per dense
    layer with ``W`` (in, out), ``b`` and, where present, ``alpha``
    (hidden layers of the adaptive tanh) and ``amp`` (the last layer).
    The layers list, the embedding and the amplitude are read off the
    arrays; ``dtype`` defaults to the arrays' own, ``device`` to the CUDA
    card."""
    params = [{k: np.asarray(v) for k, v in layer.items()}
              for layer in params]
    dense = params[1:] if "B" in params[0] else params
    layers = [dense[0]["W"].shape[0]] + [layer["W"].shape[1]
                                         for layer in dense]
    fourier = params[0]["B"].shape[1] if "B" in params[0] else 0
    if fourier:
        layers[0] = params[0]["B"].shape[0]
    has_alpha = any("alpha" in layer for layer in dense)
    if has_alpha != (activation == "adaptive_tanh"):
        raise ValueError(
            f"activation {activation!r} does not match the parameters "
            f"({'with' if has_alpha else 'without'} adaptive-tanh alphas)")
    amp = "amp" in dense[-1]
    mlp = MLP(layers, activation, fourier_features=fourier,
              output_scale=1.0 if amp else 0.0,
              dtype=dtype or torch.from_numpy(dense[0]["W"]).dtype,
              device=device)
    mlp.load_params_tree(params)
    return mlp


def pinn_params_from_file(path, activation="adaptive_tanh", *, dtype=None,
                          device=None) -> MLP:
    """:func:`pinn_params_from_numpy` of a ``pinn_*.npz`` params file (with
    its ``.tree`` descriptor) of either package's ``save_pinn``."""
    from airpollution_tpu_torch.io.checkpoint import params_from_descriptor

    return pinn_params_from_numpy(params_from_descriptor(path), activation,
                                  dtype=dtype, device=device)
