"""Halo-exchange distributed CRBE solve on the uniform stencil, PyTorch
counterpart of ``airpollution_tpu/parallel/stencil_shard.py``.

The translation-invariant operator (ops/uniform.py) couples canvas rows
only at offsets {-1, 0, +1}, so a block of contiguous canvas rows needs
ONE row from each neighbour per matvec: one ``halo_exchange`` (the JAX
package's two 1-row ppermutes, zeros at the chain ends, which is the
zero-padded canvases' boundary), and none else. With Chebyshev the inner
loop has no inner product and so no other collective; the interval is
estimated once on the whole operator. ``solver_method="bicgstab"`` runs
linalg.bicgstab with dots summed over the blocks (4 scalar sums per
iteration and the residual norm), as the JAX solver's psums.

This is plain PyTorch, as the JAX module is XLA with no Pallas kernel.
The mesh (parallel/device_mesh.py) is a ProcessMesh, one block per rank,
or a BlockMesh, every block in one process (collectives.RowChain).
Dirichlet rows stay 0 throughout (the RHS is masked) and the boundary
lift is added to the gathered state, on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from airpollution_tpu_torch.models.crbe import reject_obstacles, reject_robin
from airpollution_tpu_torch.ops import fused_solver, lifting, linalg
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod
from airpollution_tpu_torch.parallel.collectives import RowChain
from airpollution_tpu_torch.parallel.device_mesh import check_mesh, same_device


def _shift_cols(x, shift):
    """Zero-fill column shift (the last axis): shift=-1 -> x[..., j+1]."""
    if shift == -1:
        return F.pad(x[..., 1:], (0, 1))
    return F.pad(x[..., :-1], (1, 0))


def _local_matvec(consts, masks, slabs, chain):
    """One uniform stencil application on the blocks ``slabs`` (blocks, 3,
    r, n) of the H, V, D canvases: row offsets take one halo row from each
    neighbour, column offsets are local shifts, and the family masks (in
    global rows) zero Dirichlet rows, canvas padding and halo wrap-ins, as
    the JAX solver's ``_local_matvec``."""
    xH, xV, xD = slabs[:, 0], slabs[:, 1], slabs[:, 2]
    (cHH, cHVu, cHDu, cHVd, cHDd,
     cVV, cVDl, cVHl, cVHr, cVDr,
     cDD, cDVr, cDHd, cDHu, cDVl) = consts
    mH, mV, mD = masks
    below, above = chain.neighbours(
        xH[:, :1], torch.stack([xV[:, -1], xD[:, -1]], dim=1))
    xV_down = torch.cat([below[:, 0:1], xV[:, :-1]], dim=1)
    xD_down = torch.cat([below[:, 1:2], xD[:, :-1]], dim=1)
    xH_up = torch.cat([xH[:, 1:], above], dim=1)

    yH = mH * (cHH * xH
               + cHVu * _shift_cols(xV, -1)
               + cHDu * xD
               + cHVd * xV_down
               + cHDd * xD_down)
    yV = mV * (cVV * xV
               + cVDl * _shift_cols(xD, 1)
               + cVHl * _shift_cols(xH, 1)
               + cVHr * xH_up
               + cVDr * xD)
    yD = mD * (cDD * xD
               + cDVr * _shift_cols(xV, -1)
               + cDHd * xH
               + cDHu * xH_up
               + cDVl * xV)
    return torch.stack([yH, yV, yD], dim=1)


def _family_masks(n, c, r_loc, row0s, dtype, device):
    """(blocks, r, n) interior rectangle masks of the H, V, D families for
    blocks whose first global rows are ``row0s``: H rows [1, c) x cols
    [0, c); V rows [0, c) x cols [1, c); D rows [0, c) x cols [0, c)."""
    rows = (torch.as_tensor(row0s, device=device)[:, None, None]
            + torch.arange(r_loc, device=device)[None, :, None])
    cols = torch.arange(n, device=device)[None, None, :]

    def rect(r0, r1, c0, c1):
        return (((rows >= r0) & (rows < r1)) &
                ((cols >= c0) & (cols < c1))).to(dtype)

    return rect(1, c, 0, c), rect(0, c, 1, c), rect(0, c, 0, c)


def build_halo_solver(mesh, mesh_data, problem, dt, *, order=1, iters=8,
                      axis="mp", extrapolate=False, snapshot_every=None,
                      solver_method="chebyshev", tol=1e-8, maxiter=200,
                      source_quadrature="mass_lumped"):
    """Halo-exchange solve over a structured mesh, its canvas rows cut
    into ``mesh.shape[axis]`` blocks.

    Returns ``solve(ops, u0)``: the ``(1, n_seg)`` final state, or with
    ``snapshot_every=k`` the strided ``((nt-1)/k + 1, n_seg)`` trajectory
    including the initial state (the serial ``solutions[::k]``; the warm
    start carries across snapshots), boundary-lifted, on every rank.
    Sources load ``dt * m * s`` per step on the blocks' midpoint
    coordinates (``source_quadrature="mass_lumped"``: BE samples t^{n+1},
    CN the trapezoid; ``"reference"`` the raw pointwise add).
    ``solver_method``: ``"chebyshev"`` (``iters`` Jacobi-preconditioned
    iterations, no collective beyond the halos) or ``"bicgstab"``
    (``tol``, ``maxiter``; residual early exit)."""
    reject_robin(problem, "the halo-exchange solver")
    reject_obstacles(problem, "the halo-exchange solver")
    md = mesh_data
    if getattr(md, "structured_n", None) is None:
        raise ValueError("halo solver requires a structured mesh")
    if getattr(problem, "variable_coefficients", False):
        raise ValueError(
            "the halo solver runs on the translation-invariant uniform "
            "operator; spatially varying coefficients need the serial "
            "stencil/canvas paths (CRBESolver matvec_impl='stencil') or "
            "the row-sharded ELL solver (parallel/fem_shard.py)")
    if solver_method not in ("chebyshev", "bicgstab"):
        raise ValueError(f"unknown solver_method {solver_method!r}")
    if source_quadrature not in ("mass_lumped", "reference"):
        raise ValueError(f"unknown source_quadrature {source_quadrature!r}")
    n_steps = md.nt - 1
    if snapshot_every is not None and (
            snapshot_every < 1 or n_steps % snapshot_every):
        raise ValueError("snapshot_every must be a positive divisor "
                         "of nt-1")
    check_mesh(mesh, axis)
    if not same_device(mesh.device, md.device):
        raise ValueError(f"mesh device {mesh.device} differs from the mesh "
                         f"data's {md.device}")
    chain = RowChain(mesh, axis)
    has_source = not getattr(problem, "zero_source", False)
    pattern = stencil_mod.get_pattern(md)
    spec = uniform_mod.build_uniform_spec(pattern)
    n, c = spec.n, spec.c
    r_loc = -(-n // chain.n_blocks)
    n_rows = r_loc * chain.n_blocks
    row0s = [d * r_loc for d in chain.ids]
    perm, inv = (torch.as_tensor(a, device=md.device)
                 for a in (pattern.perm, pattern.inv_perm))
    lift_at = lifting.make_lift(problem, md.midpoints, md.boundary_mask)

    def blocks_of(vec_fam):
        """Family-layout vector -> this process's (blocks, 3, r, n)."""
        can = F.pad(fused_solver.to_canvases(spec, vec_fam),
                    (0, 0, 0, n_rows - n))
        return torch.stack([can[:, r0:r0 + r_loc] for r0 in row0s])

    def joined(u_blocks):
        return fused_solver.from_canvases(
            spec, chain.gather(u_blocks, dim=1)[:, :n, :])[inv]

    cache = {"ops": None, "bounds": None}

    def bounds_of(ops, u0):
        if cache["ops"] is not ops:
            consts = uniform_mod.extract_constants(spec, ops.system.vals)
            cache["bounds"] = linalg.power_bounds(
                lambda x: uniform_mod.uniform_matvec(spec, consts, x),
                torch.zeros_like(u0),
                scale=1.0 / torch.sqrt(ops.system_diag[perm]))
            cache["ops"] = ops
        return cache["bounds"]

    def solve(ops, u0):
        dtype, device = u0.dtype, u0.device
        consts = uniform_mod.extract_constants(
            spec, ops.system.vals).unbind()
        mass3 = uniform_mod.family_constants(spec, ops.mass_diag)[
            :, None, None]
        id3 = (1.0 / uniform_mod.family_constants(spec, ops.system_diag))[
            :, None, None]
        masks = _family_masks(n, c, r_loc, row0s, dtype, device)
        mask3 = torch.stack(masks, dim=1)

        def mv(x):
            return _local_matvec(consts, masks, x, chain)

        if has_source:
            mid = md.midpoints.to(dtype)
            x_loc, y_loc = blocks_of(mid[perm, 0]), blocks_of(mid[perm, 1])

            def s_at(t):
                xyt = torch.stack([x_loc, y_loc, t.expand_as(x_loc)], dim=-1)
                return problem.source_term(xyt)

        if solver_method == "chebyshev":
            lo, hi = bounds_of(ops, u0)
            theta = 0.5 * (hi + lo)
            delta = 0.5 * (hi - lo)
            sigma = theta / delta

            def inner(r, x):
                d = (id3 / theta) * r
                rho = 1.0 / sigma
                for _ in range(iters):
                    x = x + d
                    r = r - mv(d)
                    rho_new = 1.0 / (2.0 * sigma - rho)
                    d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (
                        id3 * r)
                    rho = rho_new
                return x
        else:
            def pdot(a, b):
                return chain.total(torch.stack([torch.sum(a[i] * b[i])
                                                for i in range(a.shape[0])]))

            def pnorm(v):
                return torch.sqrt(pdot(v, v))

        def step(u, up, t):
            if order == 2:
                b = 2.0 * mass3 * (mask3 * u) - mv(u)
            else:
                b = mass3 * (mask3 * u)
            if has_source:
                if source_quadrature == "reference":
                    b = b + dt * mask3 * s_at(t)
                else:
                    s = s_at(t) if order == 1 \
                        else 0.5 * (s_at(t) + s_at(t - dt))
                    b = b + dt * mass3 * (mask3 * s)
            x0 = mask3 * ((2.0 * u - up) if extrapolate else u)
            if solver_method == "chebyshev":
                return inner(b - mv(x0), x0)
            return linalg.bicgstab(mv, b, x0=x0, tol=tol, maxiter=maxiter,
                                   precond=lambda v: id3 * v, dot=pdot,
                                   norm=pnorm).x

        ts = dt * torch.arange(1, n_steps + 1, dtype=dtype, device=device)
        u = up = blocks_of(u0[perm])
        snaps = []
        for i in range(n_steps):
            u, up = step(u, up, ts[i]), u
            if snapshot_every is not None and (i + 1) % snapshot_every == 0:
                snaps.append(joined(u))
        if snapshot_every is None:
            return lifting.lifted_final_state(lift_at, joined(u), dt,
                                              n_steps)
        return lifting.strided_trajectory(lift_at, u0, torch.stack(snaps),
                                          dt, snapshot_every, n_steps)

    return solve
