"""Dirichlet boundary lift and strided-trajectory assembly, PyTorch
counterpart of ``airpollution_tpu/ops/lifting.py``.

The solvers iterate on the homogeneous state (zero on Dirichlet rows) and
add the boundary values back when they produce output.
"""

from __future__ import annotations

import torch


def make_lift(problem, midpoints, boundary_mask, zero_mask=None):
    """``lift_at(t)``: boundary values at time t on boundary DOFs, 0 inside.

    ``zero_mask``: DOFs held at 0 whatever ``boundary_fn`` says there
    (obstacle dead DOFs: identity rows pinned to 0 at interior
    midpoints)."""
    mask = boundary_mask if zero_mask is None else boundary_mask & ~zero_mask

    def lift_at(t):
        t_col = torch.full((midpoints.shape[0], 1), float(t),
                           dtype=midpoints.dtype, device=midpoints.device)
        vals = problem.boundary_fn(torch.cat([midpoints, t_col], dim=1))
        return torch.where(mask, vals, torch.zeros_like(vals))

    return lift_at


def lifted_final_state(lift_at, u_hom, dt, n_steps):
    """``(1, n_seg)`` final state: homogeneous solution + lift at T."""
    return (u_hom + lift_at(dt * n_steps))[None, :]


def strided_trajectory(lift_at, u0, u_homs, dt, snapshot_every, n_steps):
    """The strided trajectory: row 0 is the full initial condition
    (boundary values included), later rows the (n_steps / snapshot_every,
    n_seg) homogeneous snapshots ``u_homs`` lifted at their times
    ``dt * snapshot_every * (1 .. n_snap)``."""
    step = dt * snapshot_every
    lifts = torch.stack([lift_at(step * j)
                         for j in range(1, n_steps // snapshot_every + 1)])
    return torch.cat([u0[None, :], u_homs + lifts], dim=0)
