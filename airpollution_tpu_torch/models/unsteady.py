"""Quasi-static solves for time-varying coefficients (a wind that turns
over the horizon), PyTorch counterpart of
``airpollution_tpu/models/unsteady.py``.

The horizon is split into chunks of ``reassemble_every`` steps; each chunk
reassembles the operator from the problem's hooks at the chunk's midpoint
time (second order in the chunk length) and runs the implicit loop over
it. The loop carries the homogeneous state (Dirichlet rows 0 after the
first step) and lifts only the rows it returns, so a chunk's lifted last
row with its Dirichlet rows zeroed is exactly the next chunk's start: on a
wind that does not change, any chunking gives CRBESolver's trajectory.

Routes (``matvec_impl``):

- ``"scan"``: models/crbe.assemble and run_time_loop per chunk (ELL
  operator; BiCGStab or Chebyshev), stored rows or the final state;
  ``differentiable=True`` makes every chunk's solves implicit autograd
  functions (linalg._ImplicitSolve), so a gradient with respect to the
  problem's tensor parameters (``omega_t``, say) is the exact discrete
  adjoint of the quasi-static scheme.
- ``"fused_hbm"``: crbe.assemble_canvas per chunk (no ELL operator), the
  spectral interval re-estimated per chunk on the stencil matvec
  (fused_hbm.canvas_interval), then one launch of kernel B4 per step
  (fused_hbm.fused_solve_canvas_hbm, with its load plane for a source or a
  Robin flux); final state only. With ``differentiable=True`` each chunk
  runs run_time_loop in family layout with B4's raw mode over the chunk's
  coefficients and their transpose as the solve and its adjoint
  (fused_hbm.raw_solve_pair).
- ``mesh=``: the chunks on the row blocks of parallel/hbm_shard's canvas
  solver, kernel B9, its stack rebuilt from assemble_canvas at each chunk
  (``coeff_time``), with the serial fused chunks' interval.

After every chunk one scalar is read on the host: a diverged carry stops
the solve there. Runs on the mesh data's device; on the CPU every kernel
is its plain version.
"""

from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from airpollution_tpu_torch.mesh.data import structured_grid
from airpollution_tpu_torch.models.crbe import (
    GlobalOperators,
    assemble,
    assemble_canvas,
    obstacle_masks,
    robin_terms,
    run_time_loop,
)
from airpollution_tpu_torch.ops import fused_hbm, linalg, lifting
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.problems import (
    robin_g_customized,
    robin_g_xy_provided,
)


def _perm_tensors(md, pattern):
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.int64),
                                 device=md.device)
                 for a in (pattern.perm, pattern.inv_perm))


def _chunk_loads(prob, md, dt, source_quadrature):
    """The keyword arguments of fused_solve_canvas_hbm that load a source
    and an inhomogeneous Robin flux, without their ``t0``."""
    kw = {}
    if not getattr(prob, "zero_source", False):
        kw = dict(source_fn=prob.source_xy,
                  source_steady=bool(getattr(prob, "steady_source", False)),
                  source_lumped=source_quadrature == "mass_lumped")
    sides = getattr(prob, "robin_sides", None) or None
    if sides and robin_g_customized(prob):
        kw.update(robin_g_fn=prob.robin_g_xy,
                  robin_sides=tuple(sorted(sides)))
    if kw:
        kw.update(grid=structured_grid(md), dt=dt)
    return kw


def _fused_chunk(md, dt, k, order, convention, iters, extrapolate,
                 source_quadrature, bmask, rect=None, dead=None,
                 fixed_bounds=None):
    """``chunk(u0, t0, prob) -> (lifted final row (1, n), carry)`` on
    kernel B4: assemble_canvas at the chunk's midpoint, the mass masked on
    ``bmask`` (the reduced Dirichlet set with the dead DOFs), the interval
    re-estimated (or ``fixed_bounds``), k steps in one
    fused_solve_canvas_hbm from ``u0`` (full at the first chunk), then the
    lift at the chunk's end. ``rect``: the Robin-widened interior
    rectangle; ``dead``: the obstacle dead DOFs, whose loads and lift are
    zero."""
    pattern = stencil_mod.family_pattern(md)
    perm, inv = _perm_tensors(md, pattern)
    bmask_fam = bmask[perm]
    dead_fam = None if dead is None else dead[perm]

    def chunk(u0_c, t0_c, prob):
        coeffs, mass_raw_fam, diag_fam = assemble_canvas(
            md, prob, dt, order, convention, coeff_time=t0_c + 0.5 * k * dt)
        mass_fam = torch.where(bmask_fam, torch.zeros_like(mass_raw_fam),
                               mass_raw_fam)
        bounds = (fixed_bounds if fixed_bounds is not None
                  else fused_hbm.canvas_interval(pattern, coeffs, diag_fam))
        u_fam = fused_hbm.fused_solve_canvas_hbm(
            pattern, coeffs, mass_fam, 1.0 / diag_fam, u0_c[perm],
            n_steps=k, n_iters=iters, bounds=bounds, use_ka=order == 2,
            extrapolate=extrapolate, rect=rect, t0=t0_c, dead_fam=dead_fam,
            **_chunk_loads(prob, md, dt, source_quadrature))
        u_hom = u_fam[inv]
        lift = lifting.make_lift(prob, md.midpoints, bmask, zero_mask=dead)
        return (u_hom + lift(t0_c + k * dt))[None, :], u_hom

    return chunk


def _differentiable_fused_chunk(md, dt, k, order, convention, iters,
                                extrapolate, source_quadrature, bmask,
                                store_solutions, tol, maxiter, rect=None,
                                dead=None):
    """``chunk(u0, t0, prob) -> (rows, carry)``: assemble_canvas at the
    chunk's midpoint, then run_time_loop(differentiable=True) in family
    layout on the stencil matvec over those grids, each step's Chebyshev
    sweep and its adjoint one launch of B4's raw mode over the grids and
    their transpose, over the forward chunks' interval
    (fused_hbm.canvas_interval). Crank-Nicolson's K + A grids come from
    the system's: the mass off the diagonal terms, divided by dt / 2."""
    pattern = stencil_mod.family_pattern(md)
    perm, inv = _perm_tensors(md, pattern)
    fam_view = dataclasses.replace(
        stencil_mod.family_view(md, pattern.perm, dead), nt=k + 1)
    n, c = pattern.n, pattern.c
    nH = n * c
    csc = {1: 1.0, 2: 0.5}[order]

    def chunk(u0_c, t0_c, prob):
        coeffs, mass_fam, diag_fam = assemble_canvas(
            md, prob, dt, order, convention, coeff_time=t0_c + 0.5 * k * dt)
        matvec = linalg.BoundMatvec(
            lambda x, *cs: stencil_mod.stencil_matvec(pattern, cs, x),
            *coeffs)
        ka_matvec = None
        if order == 2:
            # Dirichlet rows come out as (1 - mass) / (c dt), dead rows 0:
            # the Crank-Nicolson right-hand side masks those rows anyway.
            mass_cv = (mass_fam[:nH].reshape(n, c),
                       mass_fam[nH:2 * nH].reshape(c, n),
                       mass_fam[2 * nH:].reshape(c, c))
            ka_cv = [g / (csc * dt) for g in coeffs]
            for fam, di in enumerate((0, 5, 10)):
                ka_cv[di] = (coeffs[di] - mass_cv[fam]) / (csc * dt)
            ka_cv = tuple(ka_cv)

            def ka_matvec(x):
                return stencil_mod.stencil_matvec(pattern, ka_cv, x)

        s_impl, t_impl = fused_hbm.raw_solve_pair(
            pattern, coeffs, 1.0 / diag_fam, iters, mass_fam.dtype, rect)
        ops_fam = GlobalOperators(mass_diag=mass_fam, stiffness=None,
                                  advection=None, ka=None, system=None,
                                  system_diag=diag_fam)
        sols_fam, _ = run_time_loop(
            ops_fam, u0_c[perm], mesh_data=fam_view, problem=prob, dt=dt,
            order=order, tol=tol, maxiter=maxiter,
            store_solutions=store_solutions, t0=t0_c, differentiable=True,
            bounds=fused_hbm.canvas_interval(pattern, coeffs, diag_fam),
            solver="chebyshev", chebyshev_iters=iters, matvec=matvec,
            ka_matvec=ka_matvec, cheb_solve_impl=s_impl,
            cheb_transpose_solve_impl=t_impl,
            extrapolate_warm_start=extrapolate,
            source_quadrature=source_quadrature)
        sols = sols_fam[:, inv]
        u_next = torch.where(bmask, torch.zeros_like(sols[-1]), sols[-1])
        return (sols[1:] if store_solutions else sols[-1:]), u_next

    return chunk


def _scan_chunk(md, dt, k, order, convention, tol, maxiter, solver, iters,
                extrapolate, differentiable, source_quadrature,
                store_solutions, bmask, dead=None):
    """``chunk(u0, t0, prob) -> (rows, carry)``: assemble at the chunk's
    midpoint, run_time_loop over k steps on the ELL operator."""
    view = SimpleNamespace(midpoints=md.midpoints,
                           boundary_mask=md.boundary_mask, nt=k + 1,
                           points=md.points,
                           segment_lengths=md.segment_lengths)
    if dead is not None:
        view.obstacle_dead_mask = dead

    def chunk(u0_c, t0_c, prob):
        ops = assemble(md, prob, dt, order, convention,
                       coeff_time=t0_c + 0.5 * k * dt)
        sols, _ = run_time_loop(
            ops, u0_c, mesh_data=view, problem=prob, dt=dt, order=order,
            tol=tol, maxiter=maxiter, store_solutions=store_solutions,
            t0=t0_c, differentiable=differentiable,
            extrapolate_warm_start=extrapolate, solver=solver,
            chebyshev_iters=iters, source_quadrature=source_quadrature)
        # The rows are lifted; the carry has zero Dirichlet rows, so
        # stripping the lift is exact.
        u_next = torch.where(bmask, torch.zeros_like(sols[-1]), sols[-1])
        return (sols[1:] if store_solutions else sols[-1:]), u_next

    return chunk


def _masks(md, problem):
    """(reduced Dirichlet mask with the dead DOFs, dead mask or None)."""
    bmask = robin_terms(md, problem)[0]
    _, dead = obstacle_masks(md, problem)
    if dead is not None:
        bmask = bmask | dead
    return bmask, dead


def _initial_state(problem, md, dead):
    """The initial condition at the midpoints, carved out of the solids."""
    u = problem.initial_condition_fn(md.midpoints)
    if dead is not None:
        u = torch.where(dead, torch.zeros_like(u), u)
    return u


def _check_divergence(u, u0_norm, c, k, n_steps, iters, where):
    if bool(linalg.diverged_state(u, u0_norm)):
        raise FloatingPointError(linalg.divergence_message(
            where, (c + 1) * k, n_steps, iters))


def _solve_time_varying_distributed(problem, md, mesh, axis, *, k,
                                    time_scheme_order, stiffness_convention,
                                    chebyshev_iters, extrapolate_warm_start,
                                    store_solutions, differentiable,
                                    matvec_impl, source_quadrature):
    """The chunks on parallel/hbm_shard.build_canvas_hbm_halo_solver's row
    blocks (kernel B9): one solver for every chunk (``n_steps = k``), each
    call given the chunk's start and midpoint times, so that it rebuilds
    its block stack from assemble_canvas there. Final state only, not
    differentiable, Chebyshev."""
    from airpollution_tpu_torch.parallel.hbm_shard import (
        build_canvas_hbm_halo_solver,
    )

    if matvec_impl != "fused_hbm":
        raise ValueError(
            "solve_time_varying(mesh=...) runs on the block-sharded canvas "
            "step kernel — pass matvec_impl='fused_hbm'")
    if store_solutions or differentiable:
        raise ValueError("the distributed time-varying path is "
                         "final-state-only and not differentiable")
    n_steps = md.nt - 1
    dt = float(md.domain.T) / n_steps
    solver = build_canvas_hbm_halo_solver(
        mesh, md, problem, dt, order=time_scheme_order,
        iters=chebyshev_iters, axis=axis,
        extrapolate=extrapolate_warm_start,
        source_quadrature=source_quadrature, n_steps=k,
        stiffness_convention=stiffness_convention)
    bmask, dead = _masks(md, problem)
    u = _initial_state(problem, md, dead)
    u0_norm = torch.linalg.norm(u)
    out = None
    for c in range(n_steps // k):
        t0_c = c * k * dt
        out = solver(None, u, t0=t0_c, coeff_time=t0_c + 0.5 * k * dt)
        # The block solve returns the lifted final state; the carry's
        # Dirichlet rows are 0, so stripping the lift is exact.
        u = torch.where(bmask, torch.zeros_like(out[-1]), out[-1])
        _check_divergence(u, u0_norm, c, k, n_steps, chebyshev_iters,
                          "solve_time_varying (distributed)")
    return out


def solve_time_varying(problem, mesh_data, *, reassemble_every: int,
                       time_scheme_order: int = 1,
                       stiffness_convention: str = "correct",
                       tol: float = 1e-8, maxiter: int = 200,
                       solver: str = "bicgstab", chebyshev_iters: int = 8,
                       extrapolate_warm_start: bool = False,
                       differentiable: bool = False,
                       source_quadrature: str = "mass_lumped",
                       store_solutions: bool = True,
                       matvec_impl: str = "scan",
                       reestimate_bounds: bool = True,
                       mesh=None, mesh_axis: str = "mp"):
    """Solve a ``time_varying`` problem in quasi-static chunks (module
    docstring). Returns the (nt, n) trajectory with CRBESolver's row
    semantics (row 0 the full initial condition, each later row lifted at
    its own time), or with ``store_solutions=False`` the lifted final
    state as (1, n).

    ``reassemble_every`` must divide nt - 1; the hooks are sampled at each
    chunk's midpoint, so ``reassemble_every = nt - 1`` is the frozen wind
    of T/2. ``matvec_impl="fused_hbm"`` (kernel B4, Chebyshev with
    ``chebyshev_iters``) returns the final state only unless
    ``differentiable``; its interval is re-estimated per chunk, or with
    ``reestimate_bounds=False`` estimated once at mid-horizon and widened
    10% each way. ``mesh``: a parallel/device_mesh block mesh, whose
    ``mesh_axis`` blocks run the fused chunks on kernel B9.
    ``differentiable=False`` runs without autograd."""
    md = mesh_data
    n_steps = md.nt - 1
    k = int(reassemble_every)
    if k < 1 or n_steps % k:
        raise ValueError("reassemble_every must be a positive divisor "
                         "of nt-1")
    if not getattr(problem, "time_varying", False):
        raise ValueError(
            "solve_time_varying is for problem.time_varying=True; steady "
            "problems belong to CRBESolver")
    if matvec_impl not in ("scan", "fused_hbm"):
        raise ValueError(f"unknown matvec_impl {matvec_impl!r}")
    grad = contextlib.nullcontext() if differentiable else torch.no_grad()
    if mesh is not None:
        with grad:
            return _solve_time_varying_distributed(
                problem, md, mesh, mesh_axis, k=k,
                time_scheme_order=time_scheme_order,
                stiffness_convention=stiffness_convention,
                chebyshev_iters=chebyshev_iters,
                extrapolate_warm_start=extrapolate_warm_start,
                store_solutions=store_solutions,
                differentiable=differentiable, matvec_impl=matvec_impl,
                source_quadrature=source_quadrature)
    fused = matvec_impl == "fused_hbm"
    if fused and store_solutions and not differentiable:
        raise ValueError(
            "the fused chunk path is final-state-only — use "
            "matvec_impl='scan' for trajectories (or differentiable=True, "
            "whose per-step kernel variant can store)")
    dt = float(md.domain.T) / n_steps
    robin = getattr(problem, "robin_sides", None) or None
    if fused and robin and robin_g_customized(problem) \
            and not robin_g_xy_provided(problem):
        raise ValueError(
            "this problem overrides robin_g without an elementwise "
            "robin_g_xy — the fused chunk path builds the flux load on the "
            "wall lines from robin_g_xy; override robin_g_xy or use "
            "matvec_impl='scan'")
    # The carry strip masks only true Dirichlet rows (Robin DOFs are
    # unknowns) and the dead DOFs.
    bmask, dead = _masks(md, problem)
    common = (md, dt, k, time_scheme_order, stiffness_convention)
    with grad:
        if fused:
            rect = (fused_hbm.robin_rect_bounds(md.structured_n - 1, robin)
                    if robin else None)
            if differentiable:
                chunk = _differentiable_fused_chunk(
                    *common, chebyshev_iters, extrapolate_warm_start,
                    source_quadrature, bmask, store_solutions, tol, maxiter,
                    rect=rect, dead=dead)
            else:
                fixed = None
                if not reestimate_bounds:
                    # One mid-horizon estimate, widened 10% each way so
                    # that a slowly drifting spectrum stays bracketed.
                    ops_mid = assemble(md, problem, dt, time_scheme_order,
                                       stiffness_convention,
                                       coeff_time=0.5 * float(md.domain.T))
                    pattern = stencil_mod.get_pattern(md)
                    perm, _ = _perm_tensors(md, pattern)
                    lo, hi = fused_hbm.canvas_interval(
                        pattern, stencil_mod.extract_coefficients(
                            pattern, ops_mid.system.vals),
                        ops_mid.system_diag[perm])
                    fixed = (0.9 * lo, 1.1 * hi)
                chunk = _fused_chunk(
                    *common, chebyshev_iters, extrapolate_warm_start,
                    source_quadrature, bmask, rect=rect, dead=dead,
                    fixed_bounds=fixed)
        else:
            chunk = _scan_chunk(
                *common, tol, maxiter, solver, chebyshev_iters,
                extrapolate_warm_start, differentiable, source_quadrature,
                store_solutions, bmask, dead=dead)
        u = _initial_state(problem, md, dead)
        rows = [u[None, :]]  # row 0: the full initial condition
        u0_norm = torch.linalg.norm(u.detach())
        iters = chebyshev_iters if solver == "chebyshev" or fused else None
        out = None
        for c in range(n_steps // k):
            out, u = chunk(u, c * k * dt, problem)
            _check_divergence(u.detach(), u0_norm, c, k, n_steps, iters,
                              "solve_time_varying")
            if store_solutions:
                rows.append(out)
    if not store_solutions:
        return out  # (1, n): the lifted final state
    return torch.cat(rows, dim=0)
