"""Batched and device-parallel diffusion sweeps, PyTorch counterpart of
``airpollution_tpu/parallel/sweep.py``.

The JAX package makes the diffusion coefficient a traced argument and
``vmap``s the whole solve over it, optionally ``shard_map``ped over a
'trial' axis. Here the D values are the members of one member batch
(``diagnostics/ensemble``: each member's operator assembled, the stack on
one shared column index, every ELL product one launch of kernel B7a's
stacked mode, the member-batched BiCGStab); with a mesh, the batch is
padded to a multiple of the axis size and each rank (or each block of a
BlockMesh, one after another) solves its contiguous share, and the per-D
errors are gathered.
"""

from __future__ import annotations

import torch

from airpollution_tpu_torch.parallel.collectives import RowChain
from airpollution_tpu_torch.problems import Problem


def padded_shares(chain: RowChain, n: int):
    """``(share, [(block, first, stop)])``: ``n`` members padded to a
    multiple of the axis size, each block's contiguous share of the padded
    batch (the padding repeats the last member)."""
    share = -(-n // chain.n_blocks)
    return share, [(d, d * share, (d + 1) * share) for d in chain.ids]


def crbe_diffusion_sweep(mesh_data, domain, D_values, *, v=(1.0, 0.5),
                         sigma=1.0, order=1, tol=1e-7, maxiter=200,
                         stiffness_convention="reference", mesh=None,
                         axis: str = "trial"):
    """Solve the CRBE problem for every D at once; returns the per-D
    errors, a dict of (len(D_values),) tensors ``rel_l2_error``,
    ``l2_error`` and ``max_error`` (unweighted norms at t = T against the
    closed form, crbe.py:447-453), on every rank with a mesh."""
    from airpollution_tpu_torch.diagnostics.ensemble import (
        member_initial_state, member_operators, stack_problems)
    from airpollution_tpu_torch.models.crbe import run_time_loop

    md = mesh_data
    dt = domain.T / (md.nt - 1)
    dtype, device = md.midpoints.dtype, md.midpoints.device
    D_all = [float(D) for D in D_values]
    if not D_all:
        raise ValueError("D_values is empty")
    t_col = torch.full((md.midpoints.shape[0], 1), float(domain.T),
                       dtype=dtype, device=device)
    xyt = torch.cat([md.midpoints, t_col], dim=1)

    def solve_batch(Ds):
        problems = [Problem(v=v, D=D, sigma=sigma) for D in Ds]
        batched = stack_problems(problems, dtype=dtype, device=device)
        ops = member_operators(md, problems, dt, order,
                               stiffness_convention)
        sols, _ = run_time_loop(
            ops, member_initial_state(md, batched, len(Ds)), mesh_data=md,
            problem=batched, dt=dt, order=order, tol=tol, maxiter=maxiter,
            store_solutions=False)
        u_T = sols[0]
        u_exact = batched.analytical_solution(xyt).to(dtype)
        err = torch.abs(u_exact - u_T)
        l2 = torch.sqrt(torch.sum(err ** 2, dim=-1))
        return torch.stack([l2 / torch.sqrt(torch.sum(u_exact ** 2, dim=-1)),
                            l2, torch.max(err, dim=-1).values])

    if mesh is None:
        out = solve_batch(D_all)
    else:
        chain = RowChain(mesh, axis)
        share, shares = padded_shares(chain, len(D_all))
        padded = D_all + [D_all[-1]] * (share * chain.n_blocks - len(D_all))
        parts = torch.stack([solve_batch(padded[a:b]) for _, a, b in shares])
        out = chain.gather(parts, dim=1)[:, :len(D_all)]
    return {"rel_l2_error": out[0], "l2_error": out[1], "max_error": out[2]}
