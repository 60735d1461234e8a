"""Crouzeix-Raviart FEM solver with implicit time stepping (CRBE), PyTorch
counterpart of ``airpollution_tpu/models/crbe.py``.

Assembly computes the local matrices of all triangles at once and
scatters them into a static ELL layout; the CR mass matrix is diagonal and
kept as a vector; Dirichlet rows are masked into the operator once. The
base system is ``M + dt (K + A)`` for backward Euler and
``M + dt/2 (K + A)`` for Crank-Nicolson. ``stiffness_convention`` selects
the correct gradient pullback (``"correct"``) or the reference solver's
transposed one (``"reference"``).

Solve paths (``matvec_impl``):

- ``"ell"`` / ``"stencil"``: the step loop in Python, each step solved
  with BiCGStab or Chebyshev on the ELL SpMV or the family-layout stencil.
  This is the correctness oracle.
- ``"fused"``: the whole loop in one launch of kernel B1
  (ops/fused_solver.py) while the state fits the routing limit, else
- ``"fused_hbm"``: one launch of kernel B2 per step (ops/fused_hbm.py).

Everything runs on ``device`` (default: the CUDA card). Parts of the JAX
solver that this package does not have yet raise ``NotImplementedError``
instead of taking another path.
"""

from __future__ import annotations

import time
import warnings
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.ops import lifting, linalg, sparse
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod


class ElementCR:
    """The Crouzeix-Raviart reference element (analytic constants): shape
    functions ``[-1 + 2(x + y), 1 - 2x, 1 - 2y]`` on the unit triangle with
    DOFs at edge midpoints, local edge order ``[(1,2), (2,0), (0,1)]``."""

    points = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    midpoints = np.array([[0.5, 0.5], [0.5, 0.0], [0.0, 0.5]])
    segment_enumeration = np.array([[1, 2], [2, 0], [0, 1]])

    def get_shape_functions(self, local_coords):
        x, y = local_coords
        return np.array([-1 + 2 * (x + y), 1 - 2 * x, 1 - 2 * y])

    def get_shape_function_derivatives(self):
        return np.array([[2.0, 2.0], [-2.0, 0.0], [0.0, -2.0]])

    def get_stiffness_matrix(self):
        return np.array([[4.0, -2.0, -2.0], [-2.0, 2.0, 0.0],
                         [-2.0, 0.0, 2.0]])

    def get_mass_matrix(self):
        return np.eye(3) / 6.0


# Reference-element gradients (rows = d(shape_i)/d(xi, eta)).
_REF_GRADS = np.array([[2.0, 2.0], [-2.0, 0.0], [0.0, -2.0]])


class LocalMatrices(NamedTuple):
    mass_diag: torch.Tensor  # (n_tri, 3) diagonal local mass entries
    stiffness: torch.Tensor  # (n_tri, 3, 3)
    advection: torch.Tensor  # (n_tri, 3, 3)


def local_matrices(vertices, areas, D, v,
                   stiffness_convention: str = "correct") -> LocalMatrices:
    """Local CR matrices for every triangle at once (constant scalar ``D``
    and constant ``v``). vertices: (n_tri, 3, 2); areas: (n_tri,)."""
    if stiffness_convention not in ("correct", "reference"):
        raise ValueError(f"unknown stiffness_convention {stiffness_convention}")
    dtype, device = vertices.dtype, vertices.device
    ref_grads = torch.as_tensor(_REF_GRADS, dtype=dtype, device=device)
    e1 = vertices[:, 1] - vertices[:, 0]
    e2 = vertices[:, 2] - vertices[:, 0]
    # J columns are the edge vectors from vertex 0.
    J = torch.stack([e1, e2], dim=2)  # (n_tri, 2, 2)
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    J_inv = torch.stack([
        torch.stack([J[:, 1, 1], -J[:, 0, 1]], dim=1),
        torch.stack([-J[:, 1, 0], J[:, 0, 0]], dim=1),
    ], dim=1) / det[:, None, None]
    # Physical gradients: rows of G @ J^{-1} == (J^{-T} g_i)^T.
    g_phys = ref_grads @ J_inv
    if stiffness_convention == "correct":
        g_stiff = g_phys
    else:  # the reference solver's transposed pullback (crbe.py:272-276)
        g_stiff = ref_grads @ J_inv.transpose(1, 2)
    K = (D * areas)[:, None, None] * (g_stiff @ g_stiff.transpose(1, 2))
    v_vec = torch.as_tensor(v, dtype=dtype, device=device)
    v_dot_g = g_phys @ v_vec  # (n_tri, 3)
    A = (areas / 3.0)[:, None, None] * v_dot_g[:, None, :].expand(-1, 3, 3)
    m = (areas / 3.0)[:, None].expand(-1, 3)
    return LocalMatrices(mass_diag=m, stiffness=K, advection=A)


class GlobalOperators(NamedTuple):
    """Assembled global operators (static sparsity)."""

    mass_diag: torch.Tensor  # (n_seg,) — CR mass matrix is diagonal
    stiffness: sparse.EllMatrix
    advection: sparse.EllMatrix
    ka: sparse.EllMatrix  # K + A (+ reaction * M on the diagonal)
    system: sparse.EllMatrix  # M + c*dt*(K+A) with Dirichlet rows masked
    system_diag: torch.Tensor  # diagonal of the masked system (Jacobi)


def reject_unported(problem):
    """Refuse problem features this package does not solve yet."""
    if getattr(problem, "variable_coefficients", False) or getattr(
        problem, "time_varying", False
    ):
        raise NotImplementedError(
            "spatially or temporally varying coefficients are not ported "
            "yet; use the JAX package (airpollution_tpu)"
        )
    if getattr(problem, "robin_sides", None):
        raise NotImplementedError(
            "Robin boundaries (problem.robin_sides) are not ported yet"
        )
    if getattr(problem, "obstacles", None):
        raise NotImplementedError(
            "interior obstacles (problem.obstacles) are not ported yet"
        )


def _local_operators(mesh_data, problem, stiffness_convention):
    """Local matrices of every triangle for a constant-coefficient problem."""
    reject_unported(problem)
    md = mesh_data
    verts = md.points[md.triangles]  # (n_tri, 3, 2)
    return local_matrices(verts, md.triangle_areas, problem.D, problem.v,
                          stiffness_convention)


def assemble(mesh_data, problem, dt: float, time_scheme_order: int,
             stiffness_convention: str = "correct") -> GlobalOperators:
    """Assemble all global operators in one pass (crbe.py:326-362)."""
    md = mesh_data
    loc = _local_operators(md, problem, stiffness_convention)
    t2s_flat = md.triangle_to_segments.reshape(-1)
    n_seg = md.number_of_segments
    mass_diag = torch.zeros(n_seg, dtype=loc.mass_diag.dtype,
                            device=loc.mass_diag.device)
    mass_diag.index_add_(0, t2s_flat, loc.mass_diag.reshape(-1))

    ell_cols = md.ell_cols
    ell_e2s = md.ell_entry_to_slot
    ell_diag_slot = md.ell_diag_slot

    def to_ell(local_vals):
        return sparse.ell_from_entries(local_vals.reshape(-1), ell_e2s,
                                       ell_cols)

    K = to_ell(loc.stiffness)
    A = to_ell(loc.advection)
    ka_vals = K.vals + A.vals
    # First-order reaction: + r c in the PDE is + r M in the operator.
    r = float(getattr(problem, "reaction", 0.0))
    if r != 0.0:
        ka_flat = ka_vals.reshape(-1).clone()
        ka_flat.index_add_(0, ell_diag_slot, r * mass_diag)
        ka_vals = ka_flat.reshape(ka_vals.shape)
    ka = sparse.EllMatrix(vals=ka_vals, cols=K.cols)

    c = {1: 1.0, 2: 0.5}[time_scheme_order]
    flat = ((c * dt) * ka.vals).reshape(-1).clone()
    flat.index_add_(0, ell_diag_slot, mass_diag)
    system = sparse.EllMatrix(vals=flat.reshape(ka.vals.shape), cols=ka.cols)
    system = sparse.ell_mask_dirichlet_rows(system, md.boundary_mask,
                                            ell_diag_slot)
    system_diag = sparse.ell_diagonal(system, ell_diag_slot)
    return GlobalOperators(mass_diag=mass_diag, stiffness=K, advection=A,
                           ka=ka, system=system, system_diag=system_diag)


def run_time_loop(ops: GlobalOperators, u0, *, mesh_data, problem, dt, order,
                  tol, maxiter, store_solutions=True, collect_iters=False,
                  matvec=None, ka_matvec=None, extrapolate_warm_start=False,
                  precond=None, solver="bicgstab", chebyshev_iters=8,
                  source_quadrature="mass_lumped", t0=0.0, bounds=None):
    """The implicit time-stepping loop (crbe.py:383-433 semantics).

    Each step forms the RHS, masks Dirichlet rows, and solves the fixed
    masked system from a warm start (the previous state, or ``2u - u_prev``
    with ``extrapolate_warm_start``). Boundary values are added to the
    output only. ``mesh_data`` may be a family-layout view (midpoints,
    boundary_mask, nt). ``bounds``: the Chebyshev interval; estimated with
    power_bounds when None. Returns ``(solutions, iterations)``.
    """
    md = mesh_data
    midpoints = md.midpoints
    bmask = md.boundary_mask
    nt = md.nt
    if matvec is None:
        matvec = partial(sparse.ell_matvec, ops.system)
    if ka_matvec is None:
        ka_matvec = partial(sparse.ell_matvec, ops.ka)
    if precond is None:
        precond = linalg.jacobi_preconditioner(ops.system_diag)
    if solver not in ("bicgstab", "chebyshev"):
        raise ValueError(f"unknown solver {solver!r}")
    if source_quadrature not in ("mass_lumped", "reference"):
        raise ValueError(f"unknown source_quadrature {source_quadrature!r}")
    if solver == "chebyshev" and bounds is None:
        bounds = linalg.power_bounds(
            matvec, torch.zeros_like(u0),
            scale=1.0 / torch.sqrt(ops.system_diag),
        )
    sourced = not getattr(problem, "zero_source", False)
    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)

    def at_time(t):
        t_col = torch.full((midpoints.shape[0], 1), float(t),
                           dtype=midpoints.dtype, device=midpoints.device)
        return torch.cat([midpoints, t_col], dim=1)

    def rhs(u, t):
        if order == 1:
            b = ops.mass_diag * u
        else:
            b = ops.mass_diag * u - (0.5 * dt) * ka_matvec(u)
        if sourced:
            if source_quadrature == "reference":
                # The reference's raw pointwise source (its defect D10),
                # kept as a parity switch.
                b = b + dt * problem.source_term(at_time(t))
            else:
                s = problem.source_term(at_time(t))
                if order == 2:
                    s = 0.5 * (s + problem.source_term(at_time(t - dt)))
                b = b + dt * ops.mass_diag * s
        return torch.where(bmask, zero, b)

    def lift_at(t):
        return torch.where(bmask, problem.boundary_fn(at_time(t)), zero)

    u, u_prev = u0, u0
    snaps = [u0] if store_solutions else None
    iters = [] if collect_iters else None
    for i in range(1, nt):
        t = t0 + dt * i
        b = rhs(u, t)
        guess = (2.0 * u - u_prev) if extrapolate_warm_start else u
        x0 = torch.where(bmask, zero, guess)
        if solver == "chebyshev":
            res = linalg.chebyshev(matvec, b, x0=x0, bounds=bounds,
                                   iters=chebyshev_iters, precond=precond)
        else:
            res = linalg.bicgstab(matvec, b, x0=x0, tol=tol,
                                  maxiter=maxiter, precond=precond)
        u_prev, u = u, res.x
        if store_solutions:
            snaps.append(u + lift_at(t))
        if collect_iters:
            iters.append(res.iterations)
    if store_solutions:
        solutions = torch.stack(snaps)
    else:
        # Final state only, with the boundary lift applied.
        solutions = (u + lift_at(t0 + dt * (nt - 1)))[None, :]
    return solutions, iters


_NOT_PORTED_IMPLS = ("uniform", "pallas")


class CRBESolver:
    """Backward-Euler / Crank-Nicolson + Crouzeix-Raviart FEM solver.

    Same constructor shape as the JAX ``CRBESolver``; ``solve()`` returns
    the (nt, n_seg) solution array (or the (1, n_seg) final state), and
    ``compute_errors`` the same norms. Two additions carry state across
    from the JAX package: ``cheb_bounds`` fixes the Chebyshev interval
    instead of estimating it, and :meth:`set_operators` installs an
    assembled operator (see ``airpollution_tpu_torch.interop``).
    """

    def __init__(
        self,
        domain,
        problem,
        mesh_data,
        element: Optional[ElementCR] = None,
        time_scheme_order: int = 1,
        *,
        solver_tol: float = 1e-7,
        solver_maxiter: int = 200,
        stiffness_convention: str = "correct",
        matvec_impl: str = "auto",
        fused_operator: str = "auto",
        extrapolate_warm_start: bool = False,
        preconditioner: str = "jacobi",
        solver_method: str = "bicgstab",
        chebyshev_iters: int = 8,
        chebyshev_policy: str = "reroute",
        assembly: str = "auto",
        snapshot_every: Optional[int] = None,
        source_quadrature: str = "mass_lumped",
        cheb_bounds=None,
        device=None,
    ):
        if time_scheme_order not in (1, 2):
            raise ValueError(
                f"Order {time_scheme_order} numerical scheme not implemented"
            )
        self.device = resolve_device(device)
        if self.device != mesh_data.device:
            raise ValueError(f"solver device {self.device} differs from the "
                             f"mesh data's {mesh_data.device}")
        if matvec_impl not in ("auto", "ell", "stencil", "uniform", "pallas",
                               "fused", "fused_hbm"):
            raise ValueError(f"unknown matvec_impl {matvec_impl}")
        if preconditioner not in ("jacobi", "spectral"):
            raise ValueError(f"unknown preconditioner {preconditioner}")
        if fused_operator not in ("auto", "uniform", "canvas"):
            raise ValueError(f"unknown fused_operator {fused_operator}")
        if solver_method not in ("bicgstab", "chebyshev"):
            raise ValueError(f"unknown solver_method {solver_method}")
        if chebyshev_policy not in ("reroute", "warn"):
            raise ValueError(f"unknown chebyshev_policy {chebyshev_policy}")
        if assembly not in ("auto", "full", "patch"):
            raise ValueError(f"unknown assembly {assembly}")
        if source_quadrature not in ("mass_lumped", "reference"):
            raise ValueError(f"unknown source_quadrature {source_quadrature}")
        if snapshot_every is not None and snapshot_every < 1:
            raise ValueError("snapshot_every must be a positive int")
        reject_unported(problem)
        if (
            matvec_impl == "auto"
            and getattr(mesh_data, "structured_n", None) is not None
            and mesh_data.structured_n >= 3
            and mesh_data.number_of_segments > 6_000_000
        ):
            # The JAX solver routes 'auto' to the uniform operator here.
            matvec_impl = "uniform"
        if matvec_impl in _NOT_PORTED_IMPLS:
            raise NotImplementedError(
                f"matvec_impl={matvec_impl!r} is not ported yet; use "
                f"'stencil', 'ell', 'fused' or 'fused_hbm'"
            )
        if preconditioner == "spectral":
            raise NotImplementedError(
                "preconditioner='spectral' is not ported yet"
            )
        if assembly == "patch":
            raise NotImplementedError("assembly='patch' is not ported yet")
        if snapshot_every is not None:
            raise NotImplementedError("snapshot_every is not ported yet")
        fused = matvec_impl in ("fused", "fused_hbm")
        if fused and fused_operator == "canvas":
            raise NotImplementedError(
                "fused_operator='canvas' is not ported yet"
            )
        if fused and solver_method != "chebyshev":
            raise NotImplementedError(
                "the fused paths are ported for solver_method='chebyshev' "
                "only (the BiCGStab whole-loop kernel needs grid-wide dot "
                "products)"
            )
        if fused and not getattr(problem, "zero_source", False):
            raise NotImplementedError(
                "sourced problems on the fused paths are not ported yet; "
                "use matvec_impl='stencil'"
            )
        self.domain = domain
        self.problem = problem
        self.mesh_data = mesh_data
        self.element = element or ElementCR()
        self.dt = domain.T / (mesh_data.nt - 1)  # crbe.py:233
        self.time_scheme_order = time_scheme_order
        self.solver_tol = solver_tol
        self.solver_maxiter = solver_maxiter
        self.stiffness_convention = stiffness_convention
        self.matvec_impl = matvec_impl
        self.fused_operator = fused_operator
        self.extrapolate_warm_start = extrapolate_warm_start
        self.preconditioner = preconditioner
        self.solver_method = solver_method
        self.chebyshev_iters = chebyshev_iters
        self.chebyshev_policy = chebyshev_policy
        self.assembly = assembly
        self.snapshot_every = snapshot_every
        self.source_quadrature = source_quadrature
        self._fixed_bounds = (None if cheb_bounds is None else
                              (float(cheb_bounds[0]), float(cheb_bounds[1])))
        self.solutions = None
        self.solve_time = None
        self.solver_iterations = None
        self._ops = None
        self._pattern = None
        self._reset_operator_state()

    def _config_key(self):
        """Every solver attribute a built solve function depends on."""
        return (
            self.time_scheme_order, self.solver_tol, self.solver_maxiter,
            self.matvec_impl, self.extrapolate_warm_start,
            self.solver_method, self.chebyshev_iters,
            self.stiffness_convention, self.source_quadrature,
        )

    def _reset_operator_state(self):
        self._cheb_checked = False
        self._cheb_warn_evaluated = False
        self._cheb_bounds = None
        self._u0_cache = None
        self._solve_fn_cache = {}
        self._guard_checked = set()

    # --- assembly ---

    def build_global_matrices(self) -> GlobalOperators:
        return self.set_operators(assemble(
            self.mesh_data, self.problem, self.dt, self.time_scheme_order,
            self.stiffness_convention,
        ))

    def set_operators(self, ops: GlobalOperators) -> GlobalOperators:
        """Install an assembled operator (e.g. one carried over from the JAX
        package); every cached quantity derived from the old one is
        dropped."""
        self._ops = ops
        self._reset_operator_state()
        return ops

    def _require_ops(self) -> GlobalOperators:
        if self._ops is None:
            self.build_global_matrices()
        return self._ops

    # --- time stepping ---

    def set_initial_condition(self):
        """IC sampled at edge midpoints (crbe.py:364-365)."""
        return self.problem.initial_condition_fn(self.mesh_data.midpoints)

    def _use_stencil(self) -> bool:
        if self.matvec_impl == "ell":
            return False
        if self.matvec_impl in ("stencil", "fused", "fused_hbm"):
            if self.mesh_data.structured_n is None:
                raise ValueError("stencil matvec requires a structured mesh "
                                 "(create_mesh-produced)")
            return True
        return self.mesh_data.structured_n is not None  # "auto"

    def _stencil_pattern(self):
        if self._pattern is None:
            self._pattern = stencil_mod.get_pattern(self.mesh_data)
        return self._pattern

    def _perm_tensors(self, pattern):
        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        return t(pattern.perm), t(pattern.inv_perm)

    def _build_solve_fn(self, store_solutions: bool, collect_iters: bool):
        """A function ``(ops, u0) -> (solutions, bad)``; ``bad`` is the fused
        paths' divergence flag on the device (None on the scan paths)."""
        base = dict(
            problem=self.problem, dt=self.dt, order=self.time_scheme_order,
            tol=self.solver_tol, maxiter=self.solver_maxiter,
            store_solutions=store_solutions, collect_iters=collect_iters,
            extrapolate_warm_start=self.extrapolate_warm_start,
            solver=self.solver_method, chebyshev_iters=self.chebyshev_iters,
            source_quadrature=self.source_quadrature,
            bounds=self._fixed_bounds,
        )
        if self.matvec_impl in ("fused", "fused_hbm"):
            return self._build_fused_fn(store_solutions, collect_iters)

        if not self._use_stencil():
            def solve_ell(ops, u0):
                sols, iters = run_time_loop(ops, u0, mesh_data=self.mesh_data,
                                            **base)
                return sols, iters, None

            return solve_ell

        # Stencil path: the whole loop in family layout, permuted back.
        pattern = self._stencil_pattern()
        perm, inv = self._perm_tensors(pattern)
        fam_view = stencil_mod.family_view(self.mesh_data, pattern.perm)

        def solve_stencil(ops, u0):
            ops_fam, matvec, ka_matvec = stencil_mod.family_operators(
                pattern, ops, self.time_scheme_order
            )
            sols_fam, iters = run_time_loop(
                ops_fam, u0[perm], mesh_data=fam_view, matvec=matvec,
                ka_matvec=ka_matvec, **base,
            )
            return sols_fam[:, inv], iters, None

        return solve_stencil

    def _build_fused_fn(self, store_solutions: bool, collect_iters: bool):
        """The fused paths: kernel B1 while the state fits the routing
        limit (or kernel B2 with matvec_impl='fused_hbm'), final state
        only."""
        from airpollution_tpu_torch.ops import fused_hbm, fused_solver

        if store_solutions or collect_iters:
            raise ValueError(
                "fused solver returns the final state only: call "
                "solve(store_solutions=False) (collect_iters is not "
                "available fused)"
            )
        md = self.mesh_data
        if md.structured_n < 3:
            raise NotImplementedError(
                "the uniform fused operator needs n_points_per_axis >= 3; "
                "the canvas operator is not ported yet"
            )
        pattern = self._stencil_pattern()
        spec = uniform_mod.build_uniform_spec(pattern)
        perm, inv = self._perm_tensors(pattern)
        use_hbm = (self.matvec_impl == "fused_hbm"
                   or not _fused_fits(md.structured_n,
                                      self.extrapolate_warm_start))
        self.fused_kernel = "B2" if use_hbm else "B1"
        n_steps = md.nt - 1
        use_ka = self.time_scheme_order == 2
        lift_at = lifting.make_lift(self.problem, md.midpoints,
                                    md.boundary_mask)

        def solve_fused(ops, u0):
            consts = uniform_mod.extract_constants(spec, ops.system.vals)
            mass_c = uniform_mod.family_constants(spec, ops.mass_diag)
            inv_diag_c = 1.0 / uniform_mod.family_constants(
                spec, ops.system_diag
            )
            # u0 goes in full (boundary values included): CN's first RHS
            # reads boundary columns; the kernel masks the warm start.
            u0_fam = u0[perm]
            kw = dict(n_steps=n_steps, n_iters=self.chebyshev_iters,
                      bounds=self._cheb_bounds, use_ka=use_ka,
                      extrapolate=self.extrapolate_warm_start)
            if use_hbm:
                u_fam, bad = fused_hbm.fused_solve_uniform_hbm(
                    spec, consts, mass_c, inv_diag_c, u0_fam,
                    guard_every=fused_hbm.guard_stride(n_steps), **kw,
                )
            else:
                # One launch: divergence is caught after the solve.
                u_fam = fused_solver.fused_solve_uniform(
                    spec, consts, mass_c, inv_diag_c, u0_fam, **kw,
                )
                bad = torch.where(
                    linalg.diverged_state(u_fam, torch.linalg.norm(u0_fam)),
                    n_steps, -1,
                ).to(torch.int32)
            sols = lifting.lifted_final_state(lift_at, u_fam[inv], self.dt,
                                              n_steps)
            return sols, None, bad

        return solve_fused

    def _check_chebyshev_applicable(self, ops, warn=True):
        """Chebyshev applicability check, once per operator: the spectral
        interval (unless ``cheb_bounds`` fixed it), the skew norm, and the
        worst-case convergence factor."""
        if self._cheb_checked:
            if warn and not self._cheb_warn_evaluated:
                self._cheb_warn_evaluated = True
                self._warn_cheb_factor()
            return
        md = self.mesh_data
        if (self.matvec_impl in ("fused", "fused_hbm")
                and md.structured_n >= 3):
            # Family-layout uniform matvec: the same spectrum (similarity
            # by permutation) at a fraction of the ELL gather's cost.
            pattern = self._stencil_pattern()
            spec = uniform_mod.build_uniform_spec(pattern)
            consts = uniform_mod.extract_constants(spec, ops.system.vals)
            matvec = partial(uniform_mod.uniform_matvec, spec, consts)
            perm, _ = self._perm_tensors(pattern)
            scale = 1.0 / torch.sqrt(ops.system_diag[perm])
        else:
            matvec = partial(sparse.ell_matvec, ops.system)
            scale = 1.0 / torch.sqrt(ops.system_diag)
        example = torch.zeros_like(ops.system_diag)
        if self._fixed_bounds is None:
            lo, hi = linalg.power_bounds(matvec, example, scale=scale)
            self._cheb_bounds = (float(lo), float(hi))
        else:
            self._cheb_bounds = self._fixed_bounds
        beta = linalg.skew_norm(matvec, example, scale=scale)
        self._cheb_checked = True
        self._cheb_skew = float(beta)
        self._cheb_factor = linalg.chebyshev_convergence_factor(
            *self._cheb_bounds, self._cheb_skew
        )
        self._cheb_warn_evaluated = bool(warn)
        if warn:
            self._warn_cheb_factor()

    def _warn_cheb_factor(self):
        """Warn when the cached factor is near 1 or the iteration count
        buys less than a 2x per-step residual reduction."""
        factor = self._cheb_factor
        lo, hi = self._cheb_bounds
        _, k_rec, marginal = linalg.chebyshev_gate(
            lo, hi, self._cheb_skew, self.chebyshev_iters
        )
        if not factor < linalg.CHEBYSHEV_FACTOR_GATE:
            warnings.warn(
                f"Chebyshev worst-case convergence factor {factor:.3f} is "
                f"close to or above 1 (threshold "
                f"{linalg.CHEBYSHEV_FACTOR_GATE}) for this operator "
                f"(interval [{lo:.3f}, {hi:.3f}], skew "
                f"{self._cheb_skew:.3f}) — the solve may converge slowly or "
                f"diverge; use solver_method='bicgstab'.",
                stacklevel=4,
            )
        elif marginal:
            warnings.warn(
                f"chebyshev_iters={self.chebyshev_iters} gives only a "
                f"{1.0 / factor ** self.chebyshev_iters:.1f}x worst-case "
                f"per-step residual reduction for this operator "
                f"(convergence factor {factor:.3f}) — long-horizon solves "
                f"may drift or diverge; use chebyshev_iters>={k_rec}, more "
                f"time steps, or solver_method='bicgstab'.",
                stacklevel=4,
            )

    def _reroute_divergent_chebyshev(self):
        """A divergence-prone Chebyshev configuration (factor >= the gate)
        switches to BiCGStab on the scan paths, with a warning. The fused
        paths have no BiCGStab kernel in this package, so there it raises
        and names a working configuration."""
        factor = self._cheb_factor
        lo, hi = self._cheb_bounds
        detail = (
            f"Chebyshev worst-case convergence factor {factor:.3f} >= "
            f"{linalg.CHEBYSHEV_FACTOR_GATE} for this operator (interval "
            f"[{lo:.3f}, {hi:.3f}], skew {self._cheb_skew:.3f})"
        )
        if self.matvec_impl in ("fused", "fused_hbm"):
            raise ValueError(
                f"{detail} — the solve would diverge, and the fused kernels "
                f"are Chebyshev-only. Working configurations: "
                f"matvec_impl='stencil' with solver_method='bicgstab', or "
                f"reduce dt / refine the mesh until dt*|v|/h < ~0.4. "
                f"chebyshev_policy='warn' forces the solve anyway."
            )
        warnings.warn(
            f"auto-switching solver_method 'chebyshev' -> 'bicgstab': "
            f"{detail} — the Chebyshev solve may converge slowly or "
            f"diverge. Construct the solver with solver_method='bicgstab' "
            f"to silence this, or chebyshev_policy='warn' to force "
            f"Chebyshev.",
            stacklevel=3,
        )
        self.solver_method = "bicgstab"

    def solve(self, store_solutions: bool = True, collect_iters: bool = False):
        """Run the full time horizon; returns (nt, n_seg) solutions (or the
        (1, n_seg) final state when ``store_solutions=False``)."""
        ops = self._require_ops()
        if self.solver_method == "chebyshev":
            reroute = self.chebyshev_policy == "reroute"
            self._check_chebyshev_applicable(ops, warn=not reroute)
            if reroute:
                if not self._cheb_factor < linalg.CHEBYSHEV_FACTOR_GATE:
                    self._reroute_divergent_chebyshev()
                elif not self._cheb_warn_evaluated:
                    self._cheb_warn_evaluated = True
                    self._warn_cheb_factor()
        if self._u0_cache is None:
            self._u0_cache = self.set_initial_condition()
        u0 = self._u0_cache
        key = (store_solutions, collect_iters) + self._config_key()
        if key not in self._solve_fn_cache:
            self._solve_fn_cache[key] = self._build_solve_fn(
                store_solutions, collect_iters
            )
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        start = time.perf_counter()
        solutions, iters, bad = self._solve_fn_cache[key](ops, u0)
        sync()
        self.solve_time = time.perf_counter() - start
        self.solutions = solutions
        self.solver_iterations = iters
        # Divergence guard, read on the host once per configuration: a
        # configuration's divergence is deterministic, and each read is a
        # device synchronisation.
        if key not in self._guard_checked:
            self._guard_checked.add(key)
            n_steps = self.mesh_data.nt - 1
            k = (self.chebyshev_iters if self.solver_method == "chebyshev"
                 else None)
            if bad is not None and int(bad) >= 0:
                raise FloatingPointError(linalg.divergence_message(
                    "CRBESolver fused solve", int(bad), n_steps, k))
            if bool(linalg.diverged_state(solutions[-1],
                                          torch.linalg.norm(u0))):
                raise FloatingPointError(linalg.divergence_message(
                    "CRBESolver.solve", n_steps, n_steps, k))
        return solutions

    # --- evaluation ---

    def _exact_at_T(self, analytical_sol_fn):
        md = self.mesh_data
        t_col = torch.full((md.midpoints.shape[0], 1), float(self.domain.T),
                           dtype=md.midpoints.dtype, device=self.device)
        return analytical_sol_fn(torch.cat([md.midpoints, t_col], dim=1))

    def compute_errors(self, analytical_sol_fn):
        """Errors at final time on all edge midpoints (crbe.py:435-453):
        relative L2, unweighted vector L2, and max error."""
        u_exact = self._exact_at_T(analytical_sol_fn)
        err = torch.abs(u_exact - self.solutions[-1, :])
        l2_error = torch.sqrt(torch.sum(err ** 2))
        rel_l2 = l2_error / torch.sqrt(torch.sum(u_exact ** 2))
        return float(rel_l2), float(l2_error), float(torch.max(err))

    def compute_fem_errors(self, analytical_sol_fn):
        """Area-weighted FEM norms with per-triangle midpoint quadrature."""
        md = self.mesh_data
        u_exact = self._exact_at_T(analytical_sol_fn)
        u_num = self.solutions[-1, :]
        t2s = md.triangle_to_segments
        tri_err = torch.sum((u_num - u_exact)[t2s] ** 2, dim=1) / 3.0
        tri_ex = torch.sum(u_exact[t2s] ** 2, dim=1) / 3.0
        l2 = torch.sqrt(torch.sum(md.triangle_areas * tri_err))
        norm_ex = torch.sqrt(torch.sum(md.triangle_areas * tri_ex))
        max_error = torch.max(torch.abs(u_num - u_exact))
        return (float(l2 / (norm_ex + 1e-12)), float(l2), float(max_error))


def _fused_fits(n: int, extrapolate: bool) -> bool:
    """Routing between the whole-loop kernel (B1) and the per-step kernel
    (B2), kept from the JAX package's ``_pallas_fused_fits`` for the
    uniform Chebyshev solve so that one configuration picks the same
    kernel in both packages: 3 state + 9 Chebyshev canvases (+3 with
    extrapolation) of n^2 float32 under 14 MiB."""
    n_canvases = 3 + 9 + (3 if extrapolate else 0)
    return n_canvases * n * n * 4 < 14 * 1024 * 1024


# Reference-compatible alias (crbe.py:225).
BESCRFEM = CRBESolver
