"""Multi-species advection-diffusion with coupled linear chemistry, PyTorch
counterpart of ``airpollution_tpu/models/multispecies.py``.

K species share one mesh and are coupled by a (K, K) chemistry matrix R:

    dt c_k + v_k . grad c_k - D_k lap c_k + (R c)_k = s_k.

The solve is Strang chemistry-transport splitting,

    c^{n+1} = E_h T_dt E_h c^n,     E_h = expm(-R dt/2),

with the exponential computed once per solve on the host in float64
(``problems.expm64``) and
each half-step applied as sums of K scaled rows (elementwise, so no
reduced-precision matrix product can reach the chemistry). Transport is the
implicit CR step of ``models/crbe.run_time_loop`` (BiCGStab or Chebyshev),
with the species axis as a batch dimension: one assembled operator serves
every species when (v, D) is shared, else the per-species operators are
stacked (:func:`stack_operators`).

Routes (``MultiSpeciesSolver``):

- ``splitting="commute"`` (what 'auto' picks for shared transport and no
  sources, where it is exact): K single-species ``CRBESolver`` solves on
  one assembly, then the ``expm(-R t)`` mixture of their rows.
- Strang on ``matvec_impl="ell"`` / ``"stencil"`` / ``"uniform"``: the
  loop of :func:`run_multispecies_loop` in Python, on the ELL operator,
  the family-layout stencil or the 15-scalar uniform operator.
- Strang on ``matvec_impl="fused_hbm"``: one launch of kernel B6 per step
  (``ops/fused_hbm.fused_multispecies_canvas_hbm``), or K launches of B4
  with ``fuse_chemistry=False``; emission loads built in torch.

Boundary semantics follow the single-species loop: the loop evolves the
homogeneous state and the Dirichlet lift is added to stored rows only.
Everything runs on ``device`` (default: the CUDA card).
:func:`run_multispecies_loop` with ``differentiable=True`` and a traced
``R`` is the loop under diagnostics/inverse.solve_multispecies_snapshots
and fit_chemistry.
"""

from __future__ import annotations

import time
import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.mesh.data import structured_grid
from airpollution_tpu_torch.models.crbe import (CRBESolver, GlobalOperators,
                                                _ell_matvec, assemble,
                                                checkpoint_steps,
                                                obstacle_masks, robin_terms)
from airpollution_tpu_torch.ops import fused_hbm, linalg, sparse
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod
from airpollution_tpu_torch.problems import expm64, mix_species

__all__ = ["MultiSpeciesSolver", "run_multispecies_loop", "stack_operators"]


def stack_operators(ops_list) -> GlobalOperators:
    """Stack per-species GlobalOperators along a new leading species axis."""
    def stack(*xs):
        if isinstance(xs[0], sparse.EllMatrix):
            return sparse.stack_ell(xs)
        return torch.stack(xs)

    return GlobalOperators(*(stack(*fields) for fields in zip(*ops_list)))


def half_step_exponential(R, dt) -> torch.Tensor:
    """``expm(-dt/2 R)``, float64, on the host (problems.expm64)."""
    return expm64(-(0.5 * dt) * torch.as_tensor(R, dtype=torch.float64))


def make_species_lift(problem, midpoints, bmask, dead=None, R=None):
    """``lift(t)``: the (K, N) boundary values at time t on the masked DOFs
    ``bmask``, 0 inside and on the obstacle dead DOFs ``dead`` (pinned to 0
    inside the solid, never lifted). ``R``: a mechanism overriding the
    problem's in the boundary values (the oracle's mixture)."""
    def lift(t):
        vals = problem.boundary_values(midpoints, t, R=R)
        zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
        lifted = torch.where(bmask[None, :], vals, zero)
        if dead is not None:
            lifted = torch.where(dead[None, :], zero, lifted)
        return lifted

    return lift


def run_multispecies_loop(ops: GlobalOperators, C0, *, mesh_data, problem,
                          dt, order, tol, maxiter, store_solutions=True,
                          solver="bicgstab", chebyshev_iters=8,
                          source_quadrature="mass_lumped", t0=0.0,
                          matvec=None, ka_matvec=None, differentiable=False,
                          R=None, bounds=None):
    """The Strang-split multi-species time loop.

    ``ops`` has the single-species shapes (shared transport) or a leading
    species axis on every field (:func:`stack_operators`). ``C0`` is the
    (K, N) initial state. Returns ``(solutions, None)``, solutions (nt, K,
    N), or (1, K, N) for the final state only. ``matvec`` / ``ka_matvec``:
    closures replacing the ELL matvecs (shared transport only; they take
    (K, N) rows, as ``ops/stencil.stencil_matvec`` does). ``bounds``: the
    Chebyshev interval, one (lo, hi) or one per species; estimated per
    operator with ``power_bounds`` when None. Chebyshev solves the K
    species as one (K, N) batch; BiCGStab solves them one after another,
    each stopping on its own residual.

    ``differentiable=True`` (BiCGStab only, as in the JAX package) makes
    every transport solve a linalg.differentiable_solve (``matvec`` must
    then be a linalg.BoundMatvec; the ELL default is) and checkpoints each
    step while grad mode is on (as models/crbe.checkpoint_steps decides),
    so the gradient flows through the coupled
    loop to the operators' tensors and to ``R``: a (K, K) tensor
    overriding ``problem.R``, whose half-step exponential is
    problems.expm64 (torch operations, differentiable) and which also
    enters the lift where the boundary values are the oracle's.
    """
    if differentiable and solver != "bicgstab":
        raise ValueError(
            "differentiable=True requires solver='bicgstab' (the "
            "implicit-function VJP wraps the Krylov solve)"
        )
    md = mesh_data
    midpoints = md.midpoints
    # Robin walls and obstacles: one partition and one carved domain for
    # every species (validated by MultiSpeciesProblem).
    bmask = robin_terms(md, problem.species[0])[0]
    _, dead = obstacle_masks(md, problem.species[0])
    zero = torch.zeros((), dtype=C0.dtype, device=C0.device)
    if dead is not None:
        bmask = bmask | dead
        C0 = torch.where(dead[None, :], zero, C0)
    nt = md.nt
    K = C0.shape[0]
    stacked = ops.mass_diag.ndim == 2
    if stacked and matvec is not None:
        raise ValueError("custom matvec closures need the shared-operator "
                         "layout (per-species stacked ops are ELL-only)")
    if solver not in ("bicgstab", "chebyshev"):
        raise ValueError(f"unknown solver {solver!r}")
    if source_quadrature not in ("mass_lumped", "reference"):
        raise ValueError(f"unknown source_quadrature {source_quadrature!r}")

    E_half = half_step_exponential(problem.R if R is None else R,
                                   dt).to(dtype=C0.dtype, device=C0.device)
    mass = ops.mass_diag if stacked else ops.mass_diag[None, :]
    if stacked:
        mv = partial(sparse.ell_matvec_stacked, ops.system)
        ka_mv = partial(sparse.ell_matvec_stacked, ops.ka)
        # Each species' (matvec, diagonal), for its interval and BiCGStab.
        per_species = []
        for k in range(K):
            A_k = sparse.unstack_ell(ops.system, k)
            per_species.append((linalg.BoundMatvec(_ell_matvec(A_k),
                                                   A_k.vals),
                                ops.system_diag[k]))
    else:
        if matvec is None:
            matvec = linalg.BoundMatvec(_ell_matvec(ops.system),
                                        ops.system.vals)
            ka_matvec = partial(sparse.ell_matvec, ops.ka)
        mv, ka_mv = matvec, ka_matvec
        per_species = [(mv, ops.system_diag)] * K

    if solver == "chebyshev":
        if bounds is None:
            bl = [linalg.power_bounds(m, torch.zeros_like(C0[0]),
                                      scale=1.0 / torch.sqrt(d))
                  for m, d in per_species[:K if stacked else 1]]
        elif np.ndim(bounds) == 1:
            bl = [tuple(float(b) for b in bounds)]
        else:
            bl = [tuple(float(b) for b in pair) for pair in bounds]
        if stacked:
            bl = bl if len(bl) == K else bl * K

            def col(i):
                return torch.stack([torch.as_tensor(b[i], dtype=C0.dtype,
                                                    device=C0.device)
                                    for b in bl])[:, None]

            interval = (col(0), col(1))
        else:
            interval = bl[0]
        precond = linalg.jacobi_preconditioner(ops.system_diag)

        def solve_species(B, X0):
            return linalg.chebyshev(mv, B, x0=X0, bounds=interval,
                                    iters=chebyshev_iters,
                                    precond=precond).x
    else:
        preconds = [linalg.jacobi_preconditioner(
            d.detach() if differentiable else d) for _, d in per_species]

        def solve_one(k, b, x0):
            m = per_species[k][0]
            if differentiable:
                return linalg.differentiable_solve(
                    m, b, x0=x0, tol=tol, maxiter=maxiter,
                    precond=preconds[k])
            return linalg.bicgstab(m, b, x0=x0, tol=tol, maxiter=maxiter,
                                   precond=preconds[k]).x

        def solve_species(B, X0):
            return torch.stack([solve_one(k, B[k], X0[k])
                                for k in range(K)])

    zero_source = getattr(problem, "zero_source", False)

    def rhs(U, t):
        if order == 1:
            B = mass * U
        else:
            B = mass * U - (0.5 * dt) * ka_mv(U)
        if not zero_source:
            if source_quadrature == "reference":
                # The reference's raw pointwise source (its defect D10),
                # kept as a parity switch.
                B = B + dt * problem.sources(midpoints, t)
            else:
                if order == 1:
                    s = problem.sources(midpoints, t)
                else:
                    s = 0.5 * (problem.sources(midpoints, t)
                               + problem.sources(midpoints, t - dt))
                B = B + dt * mass * s
        return torch.where(bmask[None, :], zero, B)

    lift = make_species_lift(problem, midpoints, bmask, dead, R=R)

    def step(C, t):
        # Chemistry half-step, implicit transport, chemistry half-step:
        # every stored row is a whole-step state.
        Ch = mix_species(E_half, C)
        B = rhs(Ch, t)
        X0 = torch.where(bmask[None, :], zero, Ch)
        C_new = mix_species(E_half, solve_species(B, X0))
        return C_new, (C_new + lift(t) if store_solutions else None)

    # The reverse pass keeps one state per step and re-runs each step once
    # (the JAX loop's jax.checkpoint) where the saved tensors would not fit.
    checkpointed = (differentiable and torch.is_grad_enabled()
                    and checkpoint_steps(nt - 1, C0))
    C = C0
    snaps = [C0] if store_solutions else None
    for i in range(1, nt):
        t = t0 + dt * i
        if checkpointed:
            C, out = checkpoint(step, C, t, use_reentrant=False)
        else:
            C, out = step(C, t)
        if store_solutions:
            snaps.append(out)
    if store_solutions:
        return torch.stack(snaps), None
    return (C + lift(t0 + dt * (nt - 1)))[None], None


class MultiSpeciesSolver:
    """K-species CRBE solver with Strang-split linear chemistry.

    The JAX ``MultiSpeciesSolver``'s constructor and surface: ``solve()``
    returns (nt, K, n_seg) rows (or the (1, K, n_seg) final state), and
    ``compute_errors()`` per-species and total norms against the
    expm-mixture oracle. ``problem`` is a ``MultiSpeciesProblem``. As the
    port's ``CRBESolver``, it adds ``device=`` (the CUDA card by default),
    ``cheb_bounds=`` (a fixed Chebyshev interval instead of the estimate)
    and :meth:`set_operators` (an assembled operator, e.g. carried over
    from the JAX package by ``airpollution_tpu_torch.interop``).
    """

    def __init__(self, domain, problem, mesh_data, time_scheme_order=1, *,
                 solver_tol: float = 1e-7, solver_maxiter: int = 200,
                 stiffness_convention: str = "correct",
                 solver_method: str = "bicgstab", chebyshev_iters: int = 8,
                 source_quadrature: str = "mass_lumped",
                 matvec_impl: str = "auto", splitting: str = "auto",
                 snapshot_every=None, chebyshev_policy: str = "reroute",
                 fuse_chemistry: bool = True,
                 transport_solver_kwargs=None, cheb_bounds=None,
                 device=None):
        if time_scheme_order not in (1, 2):
            raise ValueError(
                f"Order {time_scheme_order} numerical scheme not implemented"
            )
        self.device = resolve_device(device)
        if self.device != mesh_data.device:
            raise ValueError(f"solver device {self.device} differs from the "
                             f"mesh data's {mesh_data.device}")
        if solver_method not in ("bicgstab", "chebyshev"):
            raise ValueError(f"unknown solver_method {solver_method}")
        if splitting not in ("auto", "strang", "commute"):
            raise ValueError(f"unknown splitting {splitting}")
        commute_ok = problem.shared_transport and problem.zero_source
        if splitting == "commute" and not commute_ok:
            raise ValueError(
                "splitting='commute' is exact only for shared (v, D) and "
                "zero sources (the chemistry and transport operators act "
                "on different axes and commute; sources break it) — use "
                "splitting='strang'"
            )
        self.splitting = ("commute" if commute_ok else "strang") \
            if splitting == "auto" else splitting
        self.transport_solver_kwargs = dict(transport_solver_kwargs or {})
        if self.transport_solver_kwargs and self.splitting != "commute":
            raise ValueError(
                "transport_solver_kwargs configure the single-species "
                "CRBESolver of the commute route only"
            )
        if matvec_impl not in ("auto", "ell", "stencil", "uniform",
                               "fused_hbm"):
            raise ValueError(f"unknown matvec_impl {matvec_impl}")
        if matvec_impl == "fused_hbm":
            if not problem.shared_transport:
                raise ValueError(
                    "matvec_impl='fused_hbm' needs shared (v, D) across "
                    "species (ONE coefficient stack serves every "
                    "species; per-species operators are ELL-only)"
                )
            if mesh_data.structured_n is None:
                raise ValueError(
                    "matvec_impl='fused_hbm' requires a structured mesh"
                )
            if solver_method != "chebyshev":
                raise ValueError(
                    "matvec_impl='fused_hbm' needs solver_method="
                    "'chebyshev' (the stripe kernels are reduction-free)"
                )
        if any(getattr(sp, "robin_sides", None) for sp in problem.species):
            if matvec_impl == "uniform":
                raise ValueError(
                    "Robin walls (species robin_sides) break translation "
                    "invariance — use matvec_impl='ell', 'stencil', or "
                    "'auto'"
                )
        if getattr(problem, "obstacles", None):
            if matvec_impl in ("stencil", "uniform"):
                raise ValueError(
                    "interior obstacles (problem.obstacles) run on the "
                    "ELL multi-species path (or the canvas stripe "
                    "kernel) — use matvec_impl='ell', 'fused_hbm', or "
                    "'auto'"
                )
        if matvec_impl in ("stencil", "uniform"):
            if not problem.shared_transport:
                raise ValueError(
                    "family-layout fast paths need shared (v, D) across "
                    "species (per-species operators are ELL-only)"
                )
            if mesh_data.structured_n is None:
                raise ValueError(
                    "stencil matvec requires a structured mesh "
                    "(create_mesh-produced)"
                )
        if snapshot_every is not None and (
            snapshot_every < 1 or (mesh_data.nt - 1) % snapshot_every
        ):
            raise ValueError("snapshot_every must be a positive divisor "
                             "of nt-1")
        self.snapshot_every = snapshot_every
        self.chebyshev_policy = chebyshev_policy
        self.fuse_chemistry = fuse_chemistry
        self.matvec_impl = matvec_impl
        self.domain = domain
        self.problem = problem
        self.mesh_data = mesh_data
        self.dt = domain.T / (mesh_data.nt - 1)
        self.time_scheme_order = time_scheme_order
        self.solver_tol = solver_tol
        self.solver_maxiter = solver_maxiter
        self.stiffness_convention = stiffness_convention
        self.solver_method = solver_method
        self.chebyshev_iters = chebyshev_iters
        self.source_quadrature = source_quadrature
        self._fixed_bounds = None
        if cheb_bounds is not None:
            self._fixed_bounds = (
                tuple(float(b) for b in cheb_bounds)
                if np.ndim(cheb_bounds) == 1
                else tuple(tuple(float(b) for b in p) for p in cheb_bounds))
        self.solutions = None
        self.solve_time = None
        self._ops: Optional[GlobalOperators] = None
        self._reset_operator_state()

    def _reset_operator_state(self):
        self._solve_fn_cache = {}
        self._guard_checked = set()
        self._fused_bounds_cache = None
        self._transport_solvers = None

    def build_global_matrices(self) -> GlobalOperators:
        """Assemble the transport operator(s): one when (v, D) is shared,
        a species-stacked set otherwise. Chemistry never enters the
        operator; it lives in the split exponential."""
        p = self.problem
        if p.shared_transport:
            ops = assemble(self.mesh_data, p.species[0], self.dt,
                           self.time_scheme_order, self.stiffness_convention)
        else:
            ops = stack_operators([
                assemble(self.mesh_data, sp, self.dt,
                         self.time_scheme_order, self.stiffness_convention)
                for sp in p.species
            ])
        return self.set_operators(ops)

    def set_operators(self, ops: GlobalOperators) -> GlobalOperators:
        """Install an assembled operator (shared, or stacked per species);
        every cached quantity derived from the old one is dropped."""
        self._ops = ops
        self._reset_operator_state()
        return ops

    def _require_ops(self) -> GlobalOperators:
        if self._ops is None:
            self.build_global_matrices()
        return self._ops

    def set_initial_condition(self):
        return self.problem.initial_conditions(self.mesh_data.midpoints)

    def _use_stencil(self) -> bool:
        if self.matvec_impl == "ell":
            return False
        if self.matvec_impl in ("stencil", "uniform"):
            return True
        return (self.problem.shared_transport
                and self.mesh_data.structured_n is not None
                and not getattr(self.problem, "obstacles", None))

    def _fused_bounds(self, ops):
        """The shared Chebyshev interval of the fused Strang path (the ELL
        power estimate, or ``cheb_bounds``) and its applicability gate,
        once per operator set: a divergence-prone spectrum must not
        silently burn a run on the Chebyshev-only kernels."""
        cached = self._fused_bounds_cache
        if cached is not None and cached[0] is ops:
            return cached[1]
        mv = partial(sparse.ell_matvec, ops.system)
        z = torch.zeros_like(ops.system_diag)
        scale = 1.0 / torch.sqrt(ops.system_diag)
        if self._fixed_bounds is None:
            lo, hi = linalg.power_bounds(mv, z, scale=scale)
        else:
            lo, hi = self._fixed_bounds
        beta = linalg.skew_norm(mv, z, scale=scale)
        factor, k_rec, marginal = linalg.chebyshev_gate(
            lo, hi, beta, self.chebyshev_iters
        )
        if not (factor < linalg.CHEBYSHEV_FACTOR_GATE):
            msg = (
                f"Chebyshev worst-case convergence factor {factor:.3f} "
                f">= {linalg.CHEBYSHEV_FACTOR_GATE} (advection-dominated "
                f"operator) and the fused "
                f"multispecies path is Chebyshev-only — use "
                f"matvec_impl='ell'/'stencil' with "
                f"solver_method='bicgstab', or reduce dt"
            )
            if self.chebyshev_policy == "reroute":
                raise ValueError(msg)
            warnings.warn(msg + " (chebyshev_policy='warn': "
                          "proceeding anyway)", stacklevel=3)
        elif marginal:
            warnings.warn(
                f"chebyshev_iters={self.chebyshev_iters} gives only a "
                f"{1.0 / factor ** self.chebyshev_iters:.1f}x worst-case "
                f"per-step residual reduction (factor {factor:.3f}) — "
                f"long-horizon sourced solves may drift or diverge; use "
                f"chebyshev_iters>={k_rec} or more time steps (dt ~ h).",
                stacklevel=3,
            )
        bounds = (float(lo), float(hi))
        self._fused_bounds_cache = (ops, bounds)
        return bounds

    def _perm_tensors(self, pattern):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        return t(pattern.perm), t(pattern.inv_perm)

    def _build_fused_solve_fn(self, store_solutions: bool):
        """Strang splitting on the canvas operator
        (ops/fused_hbm.fused_multispecies_canvas_hbm): one launch of
        kernel B6 per step, or K launches of B4 with
        ``fuse_chemistry=False``; the emission inventory's loads are built
        in torch; Robin walls and obstacles ride the coefficients."""
        md = self.mesh_data
        strided = store_solutions and self.snapshot_every is not None
        if store_solutions and not strided:
            raise ValueError(
                "the fused multispecies path returns the final state "
                "only — pass snapshot_every=k to MultiSpeciesSolver for "
                "strided snapshots with store_solutions=True"
            )
        pattern = stencil_mod.get_pattern(md)
        perm, inv = self._perm_tensors(pattern)
        sp0 = self.problem.species[0]
        bmask = robin_terms(md, sp0)[0]
        _, dead = obstacle_masks(md, sp0)
        if dead is not None:
            bmask = bmask | dead
        robin = getattr(sp0, "robin_sides", None) or None
        rect = (fused_hbm.robin_rect_bounds(pattern.c, robin)
                if robin else None)
        n_steps = md.nt - 1
        dt = self.dt
        k_snap = self.snapshot_every if strided else None
        species = self.problem.species
        sourced = not self.problem.zero_source
        source_fns = tuple(
            None if getattr(sp, "zero_source", False) else sp.source_xy
            for sp in species) if sourced else None
        steady = tuple(bool(getattr(sp, "steady_source", False))
                       for sp in species)
        grid = structured_grid(md) if sourced else None
        E_half = half_step_exponential(self.problem.R, dt)
        bmask_fam = bmask[perm]
        dead_fam = None if dead is None else dead[perm]
        lift = make_species_lift(self.problem, md.midpoints, bmask, dead)
        kw = dict(
            n_steps=n_steps, n_iters=self.chebyshev_iters,
            use_ka=self.time_scheme_order == 2, rect=rect,
            snapshot_every=k_snap, source_fns=source_fns,
            source_steady=steady, fuse_chemistry=self.fuse_chemistry,
            source_lumped=self.source_quadrature == "mass_lumped",
            grid=grid, dt=dt, dead_fam=dead_fam,
            guard_every=fused_hbm.guard_stride(n_steps),
        )
        guard_state = {"checked": False}

        def fn(ops, C0):
            bounds = self._fused_bounds(ops)
            if dead is not None:
                # The kernels' state starts exactly 0 inside the solid.
                C0 = torch.where(dead[None, :], torch.zeros_like(C0), C0)
            coeffs = stencil_mod.extract_coefficients(pattern,
                                                      ops.system.vals)
            mass_fam = torch.where(bmask_fam,
                                   torch.zeros_like(ops.mass_diag[perm]),
                                   ops.mass_diag[perm])
            inv_diag_fam = 1.0 / ops.system_diag[perm]
            out, bad = fused_hbm.fused_multispecies_canvas_hbm(
                pattern, coeffs, mass_fam, inv_diag_fam, C0[:, perm],
                E_half, bounds=bounds, **kw)
            if not strided:
                sols = (out[:, inv] + lift(dt * n_steps))[None]
            else:
                rows = torch.stack([
                    out[j][:, inv] + lift(dt * k_snap * (j + 1))
                    for j in range(out.shape[0])])
                sols = torch.cat([C0[None], rows])
            # One host read per built configuration: divergence of a
            # configuration is deterministic, and each read synchronises.
            if not guard_state["checked"]:
                guard_state["checked"] = True
                b = int(bad)
                if b >= 0:
                    raise FloatingPointError(linalg.divergence_message(
                        "MultiSpeciesSolver fused solve", b, n_steps,
                        self.chebyshev_iters))
            return sols

        return fn

    def _build_solve_fn(self, store_solutions: bool):
        if self.matvec_impl == "fused_hbm":
            return self._build_fused_solve_fn(store_solutions)
        base = dict(
            problem=self.problem, dt=self.dt,
            order=self.time_scheme_order,
            tol=self.solver_tol, maxiter=self.solver_maxiter,
            store_solutions=store_solutions, solver=self.solver_method,
            chebyshev_iters=self.chebyshev_iters,
            source_quadrature=self.source_quadrature,
            bounds=self._fixed_bounds,
        )
        md = self.mesh_data
        if not self._use_stencil():
            def solve_ell(ops, C0):
                return run_multispecies_loop(ops, C0, mesh_data=md,
                                             **base)[0]

            return solve_ell

        # Family-layout stencil or uniform operator (shared transport):
        # the (K, N) state is permuted into family order once per solve.
        pattern = stencil_mod.get_pattern(md)
        perm, inv = self._perm_tensors(pattern)
        fam_view = stencil_mod.family_view(md, pattern.perm)
        if self.matvec_impl == "uniform":
            spec = uniform_mod.build_uniform_spec(pattern)

            def family_ops(ops):
                return uniform_mod.uniform_family_operators(
                    spec, pattern, ops, self.time_scheme_order)
        else:
            def family_ops(ops):
                return stencil_mod.family_operators(
                    pattern, ops, self.time_scheme_order)

        def solve_stencil(ops, C0):
            ops_fam, matvec, ka_matvec = family_ops(ops)
            sols_fam = run_multispecies_loop(
                ops_fam, C0[:, perm], mesh_data=fam_view, matvec=matvec,
                ka_matvec=ka_matvec, **base)[0]
            return sols_fam[:, :, inv]

        return solve_stencil

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _solve_commute(self, store_solutions: bool):
        """K independent single-species transport solves on one assembly,
        then the ``expm(-R t)`` mixture of their rows: exact for shared
        (v, D) and no sources, where chemistry (the species axis) and
        transport (the space axis) commute. ``transport_solver_kwargs``
        pass through to the port's ``CRBESolver``."""
        base = dict(
            time_scheme_order=self.time_scheme_order,
            solver_tol=self.solver_tol,
            solver_maxiter=self.solver_maxiter,
            stiffness_convention=self.stiffness_convention,
            solver_method=self.solver_method,
            chebyshev_iters=self.chebyshev_iters,
            matvec_impl=self.matvec_impl,
            chebyshev_policy=self.chebyshev_policy,
            device=self.device,
        )
        if self.snapshot_every is not None:
            base["snapshot_every"] = self.snapshot_every
        base.update(self.transport_solver_kwargs)
        if self._transport_solvers is None:
            solvers = [CRBESolver(self.domain, sp, self.mesh_data, **base)
                       for sp in self.problem.species]
            ops = self._require_ops()  # shared (v, D): one assembly
            for s in solvers:
                s.set_operators(ops)
            self._transport_solvers = solvers

        t_start = time.perf_counter()
        S = torch.stack([s.solve(store_solutions=store_solutions)
                         for s in self._transport_solvers])  # (K, rows, N)
        n_rows = S.shape[1]
        if store_solutions and n_rows > 1:
            k_snap = (self.mesh_data.nt - 1) // (n_rows - 1)
            t_rows = [self.dt * k_snap * j for j in range(n_rows)]
        else:
            t_rows = [self.domain.T]
        R = torch.as_tensor(self.problem.R, dtype=torch.float64).cpu()
        self.solutions = torch.stack([
            mix_species(expm64(-t * R).to(dtype=S.dtype, device=S.device),
                        S[:, j])
            for j, t in enumerate(t_rows)])
        self._sync()
        self.solve_time = time.perf_counter() - t_start
        return self.solutions

    def _config_key(self):
        """Every solver attribute a built solve function depends on."""
        return (
            self.time_scheme_order, self.solver_tol, self.solver_maxiter,
            self.solver_method, self.chebyshev_iters, self.matvec_impl,
            self.splitting, self.snapshot_every, self.chebyshev_policy,
            self.stiffness_convention, self.fuse_chemistry,
            self.source_quadrature,
        )

    def solve(self, store_solutions: bool = True):
        """Run the full horizon: (nt, K, n_seg) rows (strided rows on the
        fused path with ``snapshot_every``), or the (1, K, n_seg) final
        state with ``store_solutions=False``."""
        if self.splitting == "commute":
            return self._solve_commute(store_solutions)
        ops = self._require_ops()
        key = (store_solutions,) + self._config_key()
        fn = self._solve_fn_cache.get(key)
        if fn is None:
            fn = self._solve_fn_cache[key] = self._build_solve_fn(
                store_solutions)
        C0 = self.set_initial_condition()
        self._sync()
        t_start = time.perf_counter()
        self.solutions = fn(ops, C0)
        self._sync()
        self.solve_time = time.perf_counter() - t_start
        if key not in self._guard_checked:
            # Once per configuration: each read synchronises, and
            # divergence of a configuration is deterministic.
            self._guard_checked.add(key)
            if bool(linalg.diverged_state(self.solutions[-1],
                                          torch.linalg.norm(C0))):
                raise FloatingPointError(linalg.divergence_message(
                    "MultiSpeciesSolver.solve", self.mesh_data.nt - 1,
                    self.mesh_data.nt - 1,
                    self.chebyshev_iters
                    if self.solver_method == "chebyshev" else None,
                ))
        return self.solutions

    def compute_errors(self):
        """Per-species and total error norms at t=T against the
        expm-mixture oracle (``problem.has_analytical``): max, unweighted
        vector L2 and relative L2, as the single-species solver."""
        if self.solutions is None:
            raise ValueError("call solve() first")
        C = self.solutions[-1]
        C_ex = self.problem.analytical_solution(
            self.mesh_data.midpoints, self.domain.T).to(C.dtype)
        err = C - C_ex

        def norms(e, ex):
            l2 = torch.linalg.norm(e)
            return {
                "max_error": float(torch.max(torch.abs(e))),
                "l2_error": float(l2),
                "rel_l2_error": float(l2 / torch.linalg.norm(ex)),
            }

        total = norms(err.reshape(-1), C_ex.reshape(-1))
        total["per_species"] = [norms(err[k], C_ex[k])
                                for k in range(self.problem.n_species)]
        return total
