"""Dirichlet boundary lift, PyTorch counterpart of
``airpollution_tpu/ops/lifting.py``.

The solvers iterate on the homogeneous state (zero on Dirichlet rows) and
add the boundary values back when they produce output.
"""

from __future__ import annotations

import torch


def make_lift(problem, midpoints, boundary_mask):
    """``lift_at(t)``: boundary values at time t on boundary DOFs, 0 inside."""

    def lift_at(t):
        t_col = torch.full((midpoints.shape[0], 1), float(t),
                           dtype=midpoints.dtype, device=midpoints.device)
        vals = problem.boundary_fn(torch.cat([midpoints, t_col], dim=1))
        return torch.where(boundary_mask, vals, torch.zeros_like(vals))

    return lift_at


def lifted_final_state(lift_at, u_hom, dt, n_steps):
    """``(1, n_seg)`` final state: homogeneous solution + lift at T."""
    return (u_hom + lift_at(dt * n_steps))[None, :]
