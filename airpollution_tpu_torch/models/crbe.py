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

- ``"ell"`` / ``"stencil"`` / ``"pallas"`` / ``"uniform"``: the step loop
  in Python, each step solved with BiCGStab or Chebyshev on the ELL SpMV,
  the family-layout stencil, the stencil as kernel B3
  (ops/fused_stencil.py), or the translation-invariant uniform operator
  (15 scalars, ops/uniform.py). This is the correctness oracle. On the
  stencil paths ``preconditioner="spectral"`` preconditions with the
  inverse FFT symbol of the interior operator (ops/spectral.py).
- ``"fused"`` / ``"fused_hbm"`` (CRBESolver._fused_plan): on the
  translation-invariant uniform operator, the whole loop in one launch of
  kernel B1 (ops/fused_solver.py; Chebyshev or BiCGStab) while the state
  fits the routing limit, else one launch of kernel B2 per step
  (ops/fused_hbm.py); on the per-DOF canvas operator (variable
  coefficients, Robin walls, obstacles, or ``fused_operator="canvas"``),
  Chebyshev takes one launch of kernel B4 per step (ops/fused_hbm.py) and
  BiCGStab the whole loop in kernel B5 (ops/fused_solver.py). Sources and
  inhomogeneous Robin flux data reach B1, B2 and B4 as load planes
  (ops/loads.py); B5 is zero-source. ``snapshot_every`` runs one kernel
  sweep per snapshot chunk.

Past :data:`LARGE_MESH_DOFS` edge DOFs on a structured mesh with constant
coefficients, ``matvec_impl="auto"`` takes the uniform scan route, and
``assembly="auto"`` on the uniform routes (``"uniform"``, ``"fused"``,
``"fused_hbm"``) takes the operator's 21 scalars from a congruent patch
mesh (ops/uniform.patch_constants), assembling no global operator. At
that size a float32 BiCGStab solve goes through the large-mesh policy
(CRBESolver._apply_large_mesh_solver_policy): Chebyshev with an
iteration count from the measured convergence factor, or a tolerance
floored at float32's rounding level.

A ``time_varying`` problem is refused here: models/unsteady solves it in
chunks, each assembled at its midpoint (``assemble(..., coeff_time=)``, or
the canvas operator straight from the local matrices,
:func:`assemble_canvas`).

Everything runs on ``device`` (default: the CUDA card).
"""

from __future__ import annotations

import math
import time
import warnings
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from airpollution_tpu_torch.device import resolve_device
from airpollution_tpu_torch.mesh.data import (
    boundary_side_masks,
    structured_grid,
)
from airpollution_tpu_torch.ops import lifting, linalg, sparse
from airpollution_tpu_torch.ops import stencil as stencil_mod
from airpollution_tpu_torch.ops import uniform as uniform_mod
from airpollution_tpu_torch.problems import (
    SIDE_NORMALS,
    robin_g_customized,
    robin_g_xy_provided,
)
from airpollution_tpu_torch.utils.profiling import count, span

#: Edge DOFs past which ``matvec_impl="auto"`` takes the uniform operator
#: and ``assembly="auto"`` the patch scalars (global assembly of a 2049^2
#: mesh exhausted a 24 GB accelerator in the JAX package), and past which
#: a float32 BiCGStab solve goes through the large-mesh policy.
LARGE_MESH_DOFS = 6_000_000


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

    def get_jacobian(self):
        """The per-triangle Jacobians live in :func:`local_matrices`; the
        reference's method is an empty stub."""
        return None

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
    """Local CR matrices for every triangle at once. vertices: (n_tri, 3,
    2); areas: (n_tri,). ``D`` may be a scalar, a per-triangle (n_tri,)
    field, a constant (2, 2) tensor or a per-triangle (n_tri, 2, 2)
    tensor; ``v`` a (2,) constant or a per-triangle (n_tri, 2) field
    (centroid samples of the problem's hooks)."""
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
    D = torch.as_tensor(D, dtype=dtype, device=device)
    if D.ndim in (2, 3):  # diffusion tensor: integral grad phi . D grad phi
        K = areas[:, None, None] * (g_stiff @ D @ g_stiff.transpose(1, 2))
    else:
        K = (D * areas)[:, None, None] * (g_stiff @ g_stiff.transpose(1, 2))
    v_vec = torch.as_tensor(v, dtype=dtype, device=device)
    if v_vec.ndim == 2:  # per-triangle wind
        v_dot_g = (g_phys @ v_vec[:, :, None])[..., 0]
    else:
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


def obstacle_masks(mesh_data, problem):
    """Solid-obstacle masks ``(tri_keep, dead_mask)``, or ``(None, None)``
    when the problem declares no obstacles.

    ``tri_keep``: (n_tri,) bool, False for triangles whose centroid lies in
    an obstacle (their local matrices are zeroed at assembly, which leaves
    the weak form's natural condition on the staircase cut boundary).
    ``dead_mask``: (n_seg,) bool, DOFs with no live triangle left; they
    become identity rows pinned to 0. A view that runs the loop in another
    DOF order (the family view) carries ``obstacle_dead_mask`` in its own
    order, which is returned as is (with ``tri_keep`` None)."""
    if not getattr(problem, "obstacles", None):
        return None, None
    pre = getattr(mesh_data, "obstacle_dead_mask", None)
    if pre is not None:
        return None, pre
    md = mesh_data
    centroids = md.points[md.triangles].mean(dim=1)
    tri_keep = ~problem.obstacle_fn(centroids)
    live = torch.zeros(md.number_of_segments, dtype=torch.int64,
                       device=centroids.device)
    live.index_add_(0, md.triangle_to_segments.reshape(-1),
                    tri_keep.to(torch.int64).repeat_interleave(3))
    return tri_keep, live == 0


def reject_obstacles(problem, where: str):
    """Refuse an obstacle problem on a solve path that assumes the full
    obstacle-free box (translation-invariant operators, distributed
    stripe solvers), which would solve transport through the buildings
    (the JAX package's gate of the same name). The per-DOF assembled
    paths support obstacles."""
    if getattr(problem, "obstacles", None):
        raise ValueError(
            f"interior obstacles (problem.obstacles) are not supported "
            f"by {where} — use the per-DOF solve paths (CRBESolver "
            f"matvec_impl='ell'/'stencil'/'auto', or 'fused'/"
            f"'fused_hbm' with the canvas operator)"
        )


def reject_robin(problem, where: str):
    """Refuse a Robin problem on a solve path whose boundary handling is
    all-Dirichlet: treating Robin DOFs as Dirichlet would silently zero
    deposition walls (the JAX package's gate of the same name)."""
    if getattr(problem, "robin_sides", None):
        raise ValueError(
            f"Robin boundaries (problem.robin_sides) are not supported "
            f"by {where} — use the serial per-DOF paths "
            f"(CRBESolver matvec_impl='ell'/'stencil'/'auto')"
        )


def robin_terms(mesh_data, problem, alpha_override=None):
    """``(dirichlet_mask, robin_mask, robin_alpha)`` of a problem's Robin
    sides; ``(boundary_mask, None, None)`` without any.

    Named sides leave the Dirichlet set. The CR basis function is 1 along
    its own edge and every other one integrates to 0 there, so the
    boundary mass is diagonal: ``robin_alpha`` is the per-DOF
    ``alpha |e|`` added to the operator's diagonal at assembly, and the
    g-load is ``g(mid_e, t) |e|`` on Robin DOFs (run_time_loop).
    ``alpha_override``: a dict over the same sides whose values (tensors,
    say) replace the problem's alphas; the masks stay the problem's."""
    robin = getattr(problem, "robin_sides", None)
    if not robin:
        return mesh_data.boundary_mask, None, None
    unknown = set(robin) - set(SIDE_NORMALS)
    if unknown:
        raise ValueError(
            f"unknown robin_sides {sorted(unknown)} — expected a subset "
            f"of {sorted(SIDE_NORMALS)}"
        )
    if alpha_override is not None and set(alpha_override) != set(robin):
        raise ValueError(
            f"alpha_override sides {sorted(alpha_override)} must match "
            f"robin_sides {sorted(robin)}"
        )
    side_masks = boundary_side_masks(mesh_data)
    lengths = mesh_data.segment_lengths
    robin_mask = torch.zeros_like(mesh_data.boundary_mask)
    alpha_vec = torch.zeros_like(lengths)
    for side, alpha in robin.items():
        if alpha_override is not None:
            alpha = alpha_override[side]
        m = side_masks[side]
        robin_mask = robin_mask | m
        alpha_vec = alpha_vec + torch.where(m, alpha * lengths, 0.0)
    return mesh_data.boundary_mask & ~robin_mask, robin_mask, alpha_vec


def _local_operators(mesh_data, problem, stiffness_convention, coeff_time):
    """Local matrices of every triangle: constant or centroid-sampled
    coefficients (the time-varying hooks at ``coeff_time``), then obstacle
    masking. Returns ``(loc, dead_mask)``."""
    md = mesh_data
    verts = md.points[md.triangles]  # (n_tri, 3, 2)
    time_varying = getattr(problem, "time_varying", False)
    if time_varying and coeff_time is None:
        raise ValueError(
            "time-varying coefficients need an assembly time: pass "
            "coeff_time=t (or solve with models/unsteady."
            "solve_time_varying, which reassembles per time chunk)"
        )
    if getattr(problem, "variable_coefficients", False):
        # Piecewise-constant fields sampled at triangle centroids.
        centroids = verts.mean(dim=1)
        targs = (coeff_time,) if time_varying else ()
        D_loc = problem.diffusion_at(centroids, *targs)
        v_loc = problem.velocity_at(centroids, *targs)
    else:
        D_loc, v_loc = problem.D, problem.v
    loc = local_matrices(verts, md.triangle_areas, D_loc, v_loc,
                         stiffness_convention)
    tri_keep, dead = obstacle_masks(md, problem)
    if tri_keep is not None:
        keep = tri_keep.to(loc.stiffness.dtype)
        loc = loc._replace(
            mass_diag=loc.mass_diag * keep[:, None],
            stiffness=loc.stiffness * keep[:, None, None],
            advection=loc.advection * keep[:, None, None],
        )
    return loc, dead


def assemble(mesh_data, problem, dt: float, time_scheme_order: int,
             stiffness_convention: str = "correct", coeff_time=None,
             robin_alpha=None) -> GlobalOperators:
    """Assemble all global operators in one pass (crbe.py:326-362).

    ``coeff_time``: the time at which a ``time_varying`` problem's hooks
    are sampled, required for such a problem (models/unsteady passes each
    chunk's midpoint). ``robin_alpha``: an alpha override of the Robin
    sides (:func:`robin_terms`)."""
    md = mesh_data
    loc, dead = _local_operators(md, problem, stiffness_convention,
                                 coeff_time)
    t2s_flat = md.triangle_to_segments.reshape(-1)
    n_seg = md.number_of_segments
    mass_diag = torch.zeros(n_seg, dtype=loc.mass_diag.dtype,
                            device=loc.mass_diag.device)
    mass_diag.index_add_(0, t2s_flat, loc.mass_diag.reshape(-1))
    if dead is not None:
        # Unit mass on dead DOFs: after masking their rows are identity
        # rows (their columns are already zero: no live triangle).
        mass_diag = torch.where(dead, torch.ones_like(mass_diag), mass_diag)

    ell_index = md.ell_index()
    ell_e2s = md.ell_entry_to_slot
    ell_diag_slot = md.ell_diag_slot

    def to_ell(local_vals):
        return sparse.ell_from_entries(local_vals.reshape(-1), ell_e2s,
                                       ell_index)

    def add_diag(vals, vec):
        flat = vals.reshape(-1).clone()
        flat.index_add_(0, ell_diag_slot, vec.to(vals.dtype))
        return flat.reshape(vals.shape)

    K = to_ell(loc.stiffness)
    A = to_ell(loc.advection)
    ka_vals = K.vals + A.vals
    # First-order reaction: + r c in the PDE is + r M in the operator. A
    # Python 0 adds nothing; a tensor rate always enters (its gradient).
    r = getattr(problem, "reaction", 0.0)
    if not (isinstance(r, (int, float)) and r == 0.0):
        ka_vals = add_diag(ka_vals, r * mass_diag)
    # Robin walls: the diagonal alpha |e| boundary term folds into K + A.
    dirichlet_mask, _, robin_vec = robin_terms(md, problem,
                                               alpha_override=robin_alpha)
    if dead is not None:
        dirichlet_mask = dirichlet_mask | dead
    if robin_vec is not None:
        ka_vals = add_diag(ka_vals, robin_vec)
    ka = K._replace(vals=ka_vals)

    c = {1: 1.0, 2: 0.5}[time_scheme_order]
    system = ka._replace(vals=add_diag((c * dt) * ka.vals, mass_diag))
    system = sparse.ell_mask_dirichlet_rows(system, dirichlet_mask,
                                            ell_diag_slot)
    system_diag = sparse.ell_diagonal(system, ell_diag_slot)
    return GlobalOperators(mass_diag=mass_diag, stiffness=K, advection=A,
                           ka=ka, system=system, system_diag=system_diag)


def assemble_canvas(mesh_data, problem, dt: float, time_scheme_order: int,
                    stiffness_convention: str = "correct", coeff_time=None,
                    robin_alpha=None):
    """The canvas operator of a structured mesh, assembled from the local
    matrices directly (crbe.py:444-544 of the JAX package): no ELL
    operator, no scatter and no gather, only the static slices and pads of
    stencil.canvases_from_local. Returns ``(coeffs, mass_fam,
    system_diag_fam)`` in family layout: the 15 coefficient grids of the
    masked system (``extract_coefficients(pattern, assemble(...).system
    .vals)``), the mass and the system diagonal (``assemble(...)``'s,
    permuted). Reaction, Robin walls (with ``robin_alpha``), obstacles and
    variable and time-varying coefficients (at ``coeff_time``) fold in as
    in :func:`assemble`; the result keeps autograd."""
    md = mesh_data
    n = getattr(md, "structured_n", None)
    if n is None:
        raise ValueError("assemble_canvas requires a structured mesh "
                         "(general meshes take the assemble() ELL route)")
    c = n - 1
    loc, dead = _local_operators(md, problem, stiffness_convention,
                                 coeff_time)
    ka_loc = loc.stiffness + loc.advection
    r = getattr(problem, "reaction", 0.0)
    if not (isinstance(r, (int, float)) and r == 0.0):
        # + r M on the diagonal local mass: assemble()'s diagonal fold.
        ka_loc = ka_loc + torch.diag_embed(r * loc.mass_diag)
    csc = {1: 1.0, 2: 0.5}[time_scheme_order]
    coeffs, (mH, mV, mD) = stencil_mod.canvases_from_local(
        n, (csc * dt) * ka_loc, loc.mass_diag)
    perm = torch.as_tensor(
        np.asarray(stencil_mod.get_family_perm(md)[0], dtype=np.int64),
        device=md.device)
    nH = n * c

    def fam_split(vec):
        v = vec[perm]
        return (v[:nH].reshape(n, c), v[nH:2 * nH].reshape(c, n),
                v[2 * nH:].reshape(c, c))

    dirichlet_mask, _, robin_vec = robin_terms(md, problem,
                                               alpha_override=robin_alpha)
    if dead is not None:
        dirichlet_mask = dirichlet_mask | dead
        # Unit mass on dead DOFs: identity rows after the masking below.
        mH, mV, mD = (torch.where(d, torch.ones_like(m), m)
                      for d, m in zip(fam_split(dead), (mH, mV, mD)))
    diag_adds = [mH, mV, mD]
    if robin_vec is not None:
        diag_adds = [a + (csc * dt) * rv.to(a.dtype)
                     for a, rv in zip(diag_adds, fam_split(robin_vec))]
    bmasks = fam_split(dirichlet_mask)
    out = []
    for k, canvas in enumerate(coeffs):
        fam = k // 5
        if k % 5 == 0:  # the diagonal term of this family's rows
            canvas = torch.where(bmasks[fam], torch.ones_like(canvas),
                                 canvas + diag_adds[fam])
        else:
            canvas = torch.where(bmasks[fam], torch.zeros_like(canvas),
                                 canvas)
        out.append(canvas)
    mass_fam = torch.cat([mH.reshape(-1), mV.reshape(-1), mD.reshape(-1)])
    system_diag_fam = torch.cat([out[0].reshape(-1), out[5].reshape(-1),
                                 out[10].reshape(-1)])
    return tuple(out), mass_fam, system_diag_fam


#: Tensors a differentiable step keeps for its backward, in vectors of the
#: state's size: at most 47 (a rotating wind's per-DOF operator under the
#: gradient, CN, fused engine; measured with
#: torch.autograd.graph.saved_tensors_hooks at 33^2), rounded up.
STEP_SAVED_VECTORS = 64


def checkpoint_steps(n_steps: int, state: torch.Tensor) -> bool:
    """Whether a differentiable loop checkpoints each of its ``n_steps``
    steps (keeping one state a step and re-running the step in the
    backward) instead of keeping every step's saved tensors: always on
    the CPU; on the card when ``n_steps`` steps of
    :data:`STEP_SAVED_VECTORS` vectors of ``state``'s size would take more
    than half its free memory. The gradient is the same either way, bit
    for bit: the re-run computes what the first run computed."""
    if state.device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(state.device)
    need = n_steps * STEP_SAVED_VECTORS * state.numel() * state.element_size()
    return need > free // 2


def _ell_matvec(A):
    """The ELL SpMV on ``A``'s pattern as a :class:`linalg.BoundMatvec`
    body."""
    def fn(x, vals):
        return sparse.ell_matvec(A._replace(vals=vals), x)
    return fn


def run_time_loop(ops: GlobalOperators, u0, *, mesh_data, problem, dt, order,
                  tol, maxiter, store_solutions=True, collect_iters=False,
                  matvec=None, ka_matvec=None, differentiable=False,
                  extrapolate_warm_start=False, precond=None,
                  solver="bicgstab", chebyshev_iters=8,
                  source_quadrature="mass_lumped", t0=0.0, bounds=None,
                  robin_g_const=None, cheb_solve_impl=None,
                  cheb_transpose_solve_impl=None):
    """The implicit time-stepping loop (crbe.py:383-433 semantics).

    Each step forms the RHS, masks Dirichlet rows, and solves the fixed
    masked system from a warm start (the previous state, or ``2u - u_prev``
    with ``extrapolate_warm_start``). Boundary values are added to the
    output only. Robin DOFs are unknowns (their ``alpha |e|`` term is in
    the operator) and take the ``g |e|`` load; obstacle dead DOFs join the
    masked set with a zero lift and a zero initial value.
    ``robin_g_const``: per-side g values (tensors, say) overriding
    ``problem.robin_g`` in that load (the surface-exchange fit
    differentiates through them, diagnostics/inverse). ``mesh_data``
    may be a family-layout view (stencil.FamilyView). ``bounds``: the
    Chebyshev interval; estimated with power_bounds when None. Returns
    ``(solutions, iterations)``.

    Members: a (K, n) ``u0`` runs K independent solves at once, on
    operators stacked along a leading member axis (``mass_diag`` and
    ``system_diag`` (K, n), ``ka`` and ``system`` from
    ``sparse.stack_ell``) and a problem whose hooks return (K, n)
    (``problems.stack_problems``), the counterpart of the JAX package's
    ``vmap`` of this loop (diagnostics/ensemble.py). Every ELL product is
    one launch of kernel B7 over the stack; BiCGStab is
    ``linalg.bicgstab_members`` (one host read per iteration for all
    members; ``iterations`` then holds a (K,) tensor per step), the
    only solver of the member axis. ``solutions`` is then (nt, K, n), or
    (1, K, n) for the final state only. Not differentiable.

    ``differentiable=True`` makes the loop differentiable in the problem's
    tensor parameters and in ``u0``, as the JAX loop's: each step's solve
    is linalg.differentiable_solve (BiCGStab) or
    linalg.differentiable_chebyshev_solve (``solver='chebyshev'``, whose
    adjoint is the exact transpose polynomial), with the Chebyshev warm
    start applied by the delta trick (``u = x0 + solve(b - A x0)``, linear
    in b). ``matvec`` must then be a linalg.BoundMatvec (the default ELL
    one is), since the operator's gradient comes from its tensors; the
    Chebyshev interval and the preconditioner carry no gradient (JAX's
    ``stop_gradient``). While grad mode is on, each step is checkpointed
    (``torch.utils.checkpoint``, non-reentrant) where
    :func:`checkpoint_steps` says so, so that the reverse pass keeps one
    state per step and re-runs each step once; torch's checkpoint does not
    take forward-mode AD, so forward-mode callers run under
    ``torch.no_grad()`` (posterior_covariance does), where no checkpoint
    is made. ``cheb_solve_impl`` /
    ``cheb_transpose_solve_impl``: optional ``(rhs, bounds=) -> x`` fused
    replacements of the primal and adjoint Chebyshev sweeps (kernel B4's
    raw mode, diagnostics/inverse._solve); they must apply the same
    Jacobi-preconditioned polynomial. Incompatible with
    ``collect_iters``.
    """
    if differentiable and collect_iters:
        raise ValueError("differentiable=True cannot collect iteration "
                         "counts (the solve is an implicit primitive)")
    members = u0.dim() == 2
    if members and (differentiable or ops.system.vals.dim() != 3):
        raise ValueError("a (K, n) member state needs operators stacked "
                         "per member and differentiable=False")
    md = mesh_data
    midpoints = md.midpoints
    nt = md.nt
    bmask, robin_mask, _ = robin_terms(md, problem)
    _, dead = obstacle_masks(md, problem)
    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)
    if dead is not None:
        bmask = bmask | dead
        u0 = torch.where(dead, zero, u0)
    robin_load = None
    if robin_mask is not None:
        side_masks = boundary_side_masks(md)
        lengths = md.segment_lengths
        robin_items = sorted(problem.robin_sides)

        def robin_load(t):
            # One-point edge quadrature: g(mid_e, t) |e| on Robin DOFs.
            load = torch.zeros_like(lengths)
            for side in robin_items:
                if robin_g_const is not None and side in robin_g_const:
                    g = robin_g_const[side]
                else:
                    g = problem.robin_g(midpoints, t, side)
                load = load + torch.where(side_masks[side], lengths * g, 0.0)
            return load

    if matvec is None and members:
        matvec = partial(sparse.ell_matvec_stacked, ops.system)
    elif matvec is None:
        matvec = linalg.BoundMatvec(_ell_matvec(ops.system),
                                    ops.system.vals)
    if ka_matvec is None:
        ka_matvec = partial(sparse.ell_matvec, ops.ka)
    if differentiable and not isinstance(matvec, linalg.BoundMatvec):
        raise TypeError("differentiable=True needs matvec to be a "
                        "linalg.BoundMatvec (its operator tensors carry the "
                        "gradient)")
    if precond is None:
        diag = ops.system_diag.detach() if differentiable \
            else ops.system_diag
        precond = linalg.jacobi_preconditioner(diag)
    if solver not in ("bicgstab", "chebyshev"):
        raise ValueError(f"unknown solver {solver!r}")
    if source_quadrature not in ("mass_lumped", "reference"):
        raise ValueError(f"unknown source_quadrature {source_quadrature!r}")
    if members and solver != "bicgstab":
        raise ValueError("a (K, n) member state is solved by BiCGStab "
                         "(solver='bicgstab')")
    if solver == "chebyshev" and bounds is None:
        # The interval parameterises the polynomial; it carries no gradient
        # (the implicit-function rule treats the solve as A^-1).
        bounds = linalg.power_bounds(
            matvec.detached() if differentiable else matvec,
            torch.zeros_like(u0).detach(),
            scale=1.0 / torch.sqrt(ops.system_diag.detach()),
        )
        if differentiable:
            bounds = tuple(b.detach() for b in bounds)
    sourced = not getattr(problem, "zero_source", False)

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
        if robin_load is not None:
            gl = robin_load(t) if order == 1 \
                else 0.5 * (robin_load(t) + robin_load(t - dt))
            b = b + dt * gl
        return torch.where(bmask, zero, b)

    lift_at = lifting.make_lift(problem, midpoints, bmask, zero_mask=dead)

    def solve(b, x0):
        """``(u_new, iterations)`` of one step's system from the masked warm
        start; differentiable as the loop's docstring says."""
        if differentiable and solver == "chebyshev":
            s_impl = (partial(cheb_solve_impl, bounds=bounds)
                      if cheb_solve_impl is not None else None)
            t_impl = (partial(cheb_transpose_solve_impl, bounds=bounds)
                      if cheb_transpose_solve_impl is not None else None)
            delta = linalg.differentiable_chebyshev_solve(
                matvec, b - matvec(x0), bounds=bounds,
                iters=chebyshev_iters, precond=precond, solve_impl=s_impl,
                transpose_solve_impl=t_impl)
            return x0 + delta, None
        if differentiable:
            return linalg.differentiable_solve(
                matvec, b, x0=x0, tol=tol, maxiter=maxiter,
                precond=precond), None
        if solver == "chebyshev":
            res = linalg.chebyshev(matvec, b, x0=x0, bounds=bounds,
                                   iters=chebyshev_iters, precond=precond)
        else:
            bicgstab = (linalg.bicgstab_members if members
                        else linalg.bicgstab)
            res = bicgstab(matvec, b, x0=x0, tol=tol, maxiter=maxiter,
                           precond=precond)
        return res.x, res.iterations

    def step(u, u_prev, t):
        b = rhs(u, t)
        guess = (2.0 * u - u_prev) if extrapolate_warm_start else u
        u_new, its = solve(b, torch.where(bmask, zero, guess))
        return u_new, (u_new + lift_at(t) if store_solutions else None), its

    checkpointed = (differentiable and torch.is_grad_enabled()
                    and checkpoint_steps(nt - 1, u0))
    u, u_prev = u0, u0
    snaps = [u0] if store_solutions else None
    iters = [] if collect_iters else None
    for i in range(1, nt):
        t = t0 + dt * i
        if checkpointed:
            u_new, out, its = checkpoint(step, u, u_prev, t,
                                         use_reentrant=False)
        else:
            u_new, out, its = step(u, u_prev, t)
        u_prev, u = u, u_new
        if store_solutions:
            snaps.append(out)
        if collect_iters:
            iters.append(its)
    if store_solutions:
        solutions = torch.stack(snaps)
    else:
        # Final state only, with the boundary lift applied.
        solutions = (u + lift_at(t0 + dt * (nt - 1)))[None]
    return solutions, iters


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
        fused_iters: int = 5,
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
        if getattr(problem, "time_varying", False):
            raise ValueError(
                "CRBESolver assembles the operator once; time-varying "
                "coefficients (problem.time_varying) need the "
                "quasi-static chunk driver models/unsteady."
                "solve_time_varying"
            )
        fused = matvec_impl in ("fused", "fused_hbm")
        per_dof = ("auto", "ell", "stencil", "pallas", "fused", "fused_hbm")
        self._variable_coefficients = bool(
            getattr(problem, "variable_coefficients", False))
        if self._variable_coefficients and (
                matvec_impl == "uniform" or fused_operator == "uniform"
                or assembly == "patch"):
            raise ValueError(
                "spatially varying coefficients (variable_coefficients="
                "True) are not translation-invariant: matvec_impl="
                "'uniform', fused_operator='uniform' and assembly='patch' "
                "all assume the 15-scalar uniform operator — use 'ell', "
                "'stencil', 'pallas', 'fused' (canvas operator), or "
                "'fused_hbm' with solver_method='chebyshev'"
            )
        self._robin = getattr(problem, "robin_sides", None) or None
        self._robin_g_fused = False
        if self._robin:
            if matvec_impl not in per_dof:
                raise ValueError(
                    "Robin boundaries (problem.robin_sides) run on the "
                    "per-DOF coefficient paths only — use matvec_impl="
                    "'ell', 'stencil', 'pallas', 'fused'/'fused_hbm' "
                    "(canvas operator), or 'auto'"
                )
            if assembly == "patch":
                raise ValueError(
                    "Robin boundaries need full assembly (the alpha*|e| "
                    "boundary terms are per-DOF) — assembly='patch' is "
                    "translation-invariant"
                )
            if fused and fused_operator == "uniform":
                raise ValueError(
                    "Robin boundaries break translation invariance on wall "
                    "rows — the fused paths need the canvas operator "
                    "(fused_operator='canvas' or 'auto')"
                )
            if fused and robin_g_customized(problem):
                if not robin_g_xy_provided(problem):
                    raise ValueError(
                        "this problem overrides robin_g without an "
                        "elementwise robin_g_xy — the fused canvas kernel "
                        "evaluates the flux load on wall lines from "
                        "robin_g_xy; override it or use the scan paths "
                        "(matvec_impl='stencil'/'ell')"
                    )
                if solver_method != "chebyshev":
                    raise ValueError(
                        "inhomogeneous Robin flux data (robin_g_xy) on the "
                        "fused paths runs on the canvas step kernel only "
                        "— solver_method='chebyshev' (the whole-loop canvas "
                        "BiCGStab kernel takes no loads); or use the scan "
                        "paths (matvec_impl='stencil'/'ell')"
                    )
                self._robin_g_fused = True
        self._obstacles = getattr(problem, "obstacles", None) or None
        if self._obstacles:
            if matvec_impl not in per_dof:
                raise ValueError(
                    "interior obstacles (problem.obstacles) run on the "
                    "per-DOF assembled paths only — use matvec_impl="
                    "'ell', 'stencil', 'pallas', 'fused'/'fused_hbm' "
                    "(canvas operator), or 'auto'"
                )
            if fused and fused_operator == "uniform":
                raise ValueError(
                    "interior obstacles break translation invariance — the "
                    "fused paths need the canvas operator "
                    "(fused_operator='canvas' or 'auto')"
                )
            if assembly == "patch":
                raise ValueError(
                    "interior obstacles need full assembly (the masked "
                    "triangles are per-DOF information) — assembly='patch' "
                    "is translation-invariant"
                )
        if (
            matvec_impl == "auto"
            and not self._robin
            and not self._obstacles
            and not self._variable_coefficients
            and assembly != "full"
            and preconditioner != "spectral"
            and getattr(mesh_data, "structured_n", None) is not None
            and mesh_data.structured_n >= 3
            and mesh_data.number_of_segments > LARGE_MESH_DOFS
        ):
            # Global assembly would not fit at this size; on a structured
            # mesh with constant coefficients the uniform operator is
            # exact, and patch assembly takes its scalars.
            matvec_impl = "uniform"
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
        self.fused_iters = fused_iters
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
        self._patch_cache = None
        self._large_mesh_policy_applied = False
        self._reset_operator_state()
        self._use_patch()  # refuse an invalid assembly now
        if fused:
            self._fused_plan()  # refuse an invalid or unported route now

    def _config_key(self):
        """Every solver attribute a built solve function depends on."""
        return (
            self.time_scheme_order, self.solver_tol, self.solver_maxiter,
            self.matvec_impl, self.fused_iters, self.fused_operator,
            self.extrapolate_warm_start, self.preconditioner,
            self.solver_method, self.chebyshev_iters, self.assembly,
            self.snapshot_every, self.stiffness_convention,
            self.source_quadrature,
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
        with span("crbe.assemble"):
            ops = assemble(self.mesh_data, self.problem, self.dt,
                           self.time_scheme_order, self.stiffness_convention)
        return self.set_operators(ops)

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

    @property
    def global_mass_diag(self):
        return self._require_ops().mass_diag

    @property
    def global_stiffness(self):
        return self._require_ops().stiffness

    @property
    def global_advection(self):
        return self._require_ops().advection

    # --- time stepping ---

    def set_initial_condition(self):
        """IC sampled at edge midpoints (crbe.py:364-365)."""
        return self.problem.initial_condition_fn(self.mesh_data.midpoints)

    def boundary_values(self, t):
        """The dense boundary-lift vector at time ``t`` (crbe.py:367-379):
        the exact boundary data on Dirichlet DOFs, zero elsewhere (Robin
        DOFs are unknowns and take no lift)."""
        md = self.mesh_data
        t_col = torch.full((md.midpoints.shape[0], 1), float(t),
                           dtype=md.midpoints.dtype, device=self.device)
        vals = self.problem.boundary_fn(torch.cat([md.midpoints, t_col],
                                                  dim=1))
        dmask = robin_terms(md, self.problem)[0]
        return torch.where(dmask, vals, torch.zeros_like(vals))

    def _use_stencil(self) -> bool:
        if self.matvec_impl == "ell":
            return False
        if self.matvec_impl in ("stencil", "uniform", "pallas", "fused",
                                "fused_hbm"):
            if self.mesh_data.structured_n is None:
                raise ValueError("stencil matvec requires a structured mesh "
                                 "(create_mesh-produced)")
            return True
        return self.mesh_data.structured_n is not None  # "auto"

    def _stencil_pattern(self):
        if self._pattern is None:
            self._pattern = stencil_mod.get_pattern(self.mesh_data)
        return self._pattern

    def _use_patch(self) -> bool:
        """Patch assembly: the uniform operator's scalars from a congruent
        patch mesh (ops/uniform.patch_constants) instead of the assembled
        global operator. Needs a uniform route ('uniform', or 'fused' /
        'fused_hbm' on the uniform operator) and a non-spectral
        preconditioner (the spectral one reads the assembled operator);
        chosen by ``assembly="auto"`` past :data:`LARGE_MESH_DOFS`, where
        global assembly would not fit the card. Raises ValueError for
        ``assembly="patch"`` on any other route."""
        if self.assembly == "full":
            return False
        md = self.mesh_data
        eligible = (self.matvec_impl in ("uniform", "fused", "fused_hbm")
                    and md.structured_n is not None and md.structured_n >= 3
                    and self.preconditioner != "spectral"
                    and not self._variable_coefficients
                    and not self._robin and not self._obstacles)
        if self.matvec_impl in ("fused", "fused_hbm"):
            eligible = eligible and self.fused_operator != "canvas"
        if self.assembly == "patch":
            if not eligible:
                raise ValueError(
                    "assembly='patch' requires a structured mesh, the "
                    "uniform operator (matvec_impl='uniform', 'fused' or "
                    "'fused_hbm'; fused also needs fused_operator != "
                    "'canvas'; constant coefficients, no Robin walls or "
                    "obstacles) and a non-spectral preconditioner")
            return True
        return eligible and md.number_of_segments > LARGE_MESH_DOFS

    def _patch_pieces(self):
        """``(spec_lite, sys_consts, ka_consts, mass_c, sys_diag_c)`` of the
        patch route, on the solver's device, built once."""
        if self._patch_cache is None:
            md = self.mesh_data
            # The cell size from the mesh's own coordinates: the Domain is
            # a second, unchecked source of the same fact.
            xs = md.points[:, 0]
            half_width = float(xs.max() - xs.min()) / 2.0
            consts = uniform_mod.patch_constants(
                md.structured_n, half_width, self.problem, self.dt,
                self.time_scheme_order, self.stiffness_convention,
                dtype=md.midpoints.dtype, device=self.device)
            self._patch_cache = (
                uniform_mod.make_spec_lite(md.structured_n),) + consts
        return self._patch_cache

    def _family_perm_tensors(self):
        """(perm, inv) of the family layout, the stencil pattern's when it
        is built (the patch route never builds it)."""
        perm, inv = stencil_mod.get_family_perm(self.mesh_data)

        def t(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=self.device)

        return t(perm), t(inv)

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
            if self.preconditioner == "spectral":
                raise ValueError(
                    "the fused kernels precondition with Jacobi; use "
                    "matvec_impl='stencil' for the spectral preconditioner")
            return self._build_fused_fn(store_solutions, collect_iters)

        k_snap = self.snapshot_every
        stride = store_solutions and k_snap is not None and k_snap > 1
        if stride and (self.mesh_data.nt - 1) % k_snap:
            raise ValueError("snapshot_every must divide nt-1")

        def stride_rows(sols):
            """snapshot_every on the scan paths: every k-th stored row, the
            fused paths' row <-> time contract (peak memory is still the
            full trajectory)."""
            return sols[::k_snap] if stride else sols

        if not self._use_stencil():
            if self.preconditioner == "spectral":
                raise ValueError(
                    "the spectral preconditioner requires the structured "
                    "stencil path (matvec_impl='stencil')")

            def solve_ell(ops, u0):
                sols, iters = run_time_loop(ops, u0, mesh_data=self.mesh_data,
                                            **base)
                return stride_rows(sols), iters, None

            return solve_ell

        # Stencil paths: the whole loop in family layout, permuted back.
        md = self.mesh_data
        patch = self._use_patch()
        pattern = None if patch else self._stencil_pattern()
        perm, inv = self._family_perm_tensors()
        _, dead = obstacle_masks(md, self.problem)
        fam_view = stencil_mod.family_view(
            md, stencil_mod.get_family_perm(md)[0], dead)
        if self.matvec_impl == "uniform":
            family_ops = self._uniform_family_ops(pattern, perm)
            if self.solver_method == "chebyshev" and self._fixed_bounds is None:
                # The interval the applicability check estimated on this
                # same operator (the loop would estimate it again).
                base["bounds"] = self._cheb_bounds
        else:
            kernel = self.matvec_impl == "pallas"
            if kernel:
                from airpollution_tpu_torch.ops import fused_stencil

                if not fused_stencil.fits_vmem(pattern):
                    raise ValueError(
                        "mesh too large for matvec_impl='pallas' (kernel B3 "
                        "keeps the JAX package's VMEM budget); use "
                        "matvec_impl='stencil'"
                    )

            def family_ops(ops):
                return stencil_mod.family_operators(
                    pattern, ops, self.time_scheme_order, kernel)

        def solve_stencil(ops, u0):
            ops_fam, matvec, ka_matvec = family_ops(ops)
            precond = None
            if self.preconditioner == "spectral":
                from airpollution_tpu_torch.ops import spectral

                precond = spectral.spectral_preconditioner(
                    pattern, stencil_mod.extract_coefficients(
                        pattern, ops.system.vals))
            sols_fam, iters = run_time_loop(
                ops_fam, u0[perm], mesh_data=fam_view, matvec=matvec,
                ka_matvec=ka_matvec, precond=precond, **base,
            )
            return stride_rows(sols_fam)[:, inv], iters, None

        return solve_stencil

    def _uniform_family_ops(self, pattern, perm):
        """``ops -> (ops_fam, matvec, ka_matvec)`` of the uniform scan route:
        from the assembled operator's 15 scalars, or with patch assembly
        (``pattern`` None) from the patch scalars alone, with the mass and
        diagonal vectors made from their 3 family constants and no global
        operator (``ops`` is None). Dirichlet rows of those vectors are
        read only after the loop's row masking."""
        if pattern is not None:
            spec = uniform_mod.build_uniform_spec(pattern)

            def family_ops(ops):
                return uniform_mod.uniform_family_operators(
                    spec, pattern, ops, self.time_scheme_order)

            return family_ops
        spec, sys_c, ka_c, mass_c, diag_c = self._patch_pieces()
        bmask_fam = self.mesh_data.boundary_mask[perm]

        def family_ops(_ops):
            matvec = linalg.BoundMatvec(
                lambda x, c: uniform_mod.uniform_matvec(spec, c, x), sys_c)
            ka_matvec = (partial(uniform_mod.uniform_matvec, spec, ka_c,
                                 boundary="drop")
                         if self.time_scheme_order == 2 else None)
            ops_fam = GlobalOperators(
                mass_diag=uniform_mod.family_const_vector(spec, mass_c),
                stiffness=None, advection=None, ka=None, system=None,
                system_diag=uniform_mod.family_diag_vector(spec, diag_c,
                                                           bmask_fam))
            return ops_fam, matvec, ka_matvec

        return family_ops

    def _fused_plan(self, method=None):
        """``(uniform, kernel)`` of the fused route for ``method`` (default
        the solver's), the JAX solver's rules: the uniform operator (15
        scalars) unless the problem or ``fused_operator='canvas'`` needs
        per-DOF coefficients; then B1 (whole loop, Chebyshev or
        "B1-BiCGStab") while the state fits the routing budget, else B2 (one
        step per launch, Chebyshev only); on the canvas operator Chebyshev
        always takes B4 (one step per launch) and BiCGStab B5 (whole loop,
        zero source) when it fits. Raises ValueError for an invalid
        route."""
        md = self.mesh_data
        if md.structured_n is None:
            raise ValueError("stencil matvec requires a structured mesh "
                             "(create_mesh-produced)")
        method = method or self.solver_method
        bicgstab = method != "chebyshev"
        uniform = (self.fused_operator != "canvas"
                   and not self._variable_coefficients
                   and not self._robin and not self._obstacles)
        if uniform and md.structured_n < 3:
            if self.fused_operator == "uniform":
                raise ValueError("uniform fused operator requires "
                                 "n_points_per_axis >= 3")
            uniform = False  # degenerate mesh: the canvas operator
        sourced = not getattr(self.problem, "zero_source", False)
        if sourced and not uniform and bicgstab:
            raise ValueError(
                "the whole-loop canvas kernel is zero-source: a sourced "
                "canvas-operator solve needs solver_method='chebyshev' (the "
                "canvas step kernel takes the load), fused_operator="
                "'uniform' (or 'auto' on a non-degenerate structured mesh), "
                "or matvec_impl='stencil' for the scan path"
            )
        steady = sourced and bool(getattr(self.problem, "steady_source",
                                          False))
        use_hbm = (self.matvec_impl == "fused_hbm" or not _fused_fits(
            md.structured_n, self.extrapolate_warm_start, uniform=uniform,
            method=method, source_steady=steady))
        if not uniform and not bicgstab:
            use_hbm = True  # canvas + Chebyshev is always the step kernel
        if use_hbm and bicgstab:
            reason = ("matvec_impl='fused_hbm' was requested"
                      if self.matvec_impl == "fused_hbm"
                      else "mesh too large for the whole-loop fused solver")
            raise ValueError(
                f"{reason}, but the per-step stripe kernels need "
                "solver_method='chebyshev' (its reduction-free iterations "
                "keep tiles independent) — or use matvec_impl='stencil'"
            )
        if uniform:
            if use_hbm:
                return True, "B2"
            return True, "B1-BiCGStab" if bicgstab else "B1"
        return False, "B4" if use_hbm else "B5"

    def _build_fused_fn(self, store_solutions: bool, collect_iters: bool):
        """The fused paths, routed by :meth:`_fused_plan`: B1 / B2 on the
        uniform operator, B4 / B5 on the canvas operator. The final state,
        or with ``snapshot_every`` the strided trajectory: one kernel sweep
        per chunk of ``snapshot_every`` steps, each starting its
        extrapolated warm start afresh (u_prev = the chunk's first state)
        and its loads at the chunk's start time, as the JAX solver does;
        the divergence guard then works per chunk, and once it trips the
        later chunks are skipped."""
        from airpollution_tpu_torch.ops import fused_hbm, fused_solver

        md = self.mesh_data
        n_steps = md.nt - 1
        k_snap = self.snapshot_every
        strided = store_solutions and k_snap is not None
        if (store_solutions and not strided) or collect_iters:
            raise ValueError(
                "fused solver returns the final state only — pass "
                "snapshot_every=k to CRBESolver for strided snapshots with "
                "store_solutions=True (collect_iters is not available fused)"
            )
        if strided and n_steps % k_snap:
            raise ValueError(
                "snapshot_every must divide nt-1 for the fused paths")
        uniform, kernel = self._fused_plan()
        self.fused_kernel = kernel
        patch = self._use_patch()
        pattern = None if patch else self._stencil_pattern()
        perm, inv = self._family_perm_tensors()
        use_ka = self.time_scheme_order == 2
        ext = self.extrapolate_warm_start
        dt = self.dt
        problem = self.problem
        # Under Robin the mask is the reduced Dirichlet set; obstacle dead
        # DOFs join it with a zero lift. A state that enters a kernel as 0
        # on a dead DOF (an identity row with zero columns) stays exactly 0.
        dmask = robin_terms(md, problem)[0]
        _, dead = obstacle_masks(md, problem)
        if dead is not None:
            dmask = dmask | dead
        lift_at = lifting.make_lift(problem, md.midpoints, dmask,
                                    zero_mask=dead)
        spec = None
        if patch:
            spec = self._patch_pieces()[0]
        elif uniform:
            spec = uniform_mod.build_uniform_spec(pattern)
        rect = (fused_hbm.robin_rect_bounds(pattern.c, self._robin)
                if self._robin else None)
        # Loads: the problem's hooks, evaluated in torch on the structured
        # grid's coordinates (ops/loads.py).
        src = {}
        if not getattr(problem, "zero_source", False):
            src = dict(source_fn=problem.source_xy,
                       source_steady=bool(getattr(problem, "steady_source",
                                                  False)),
                       source_lumped=self.source_quadrature == "mass_lumped")
        if self._robin_g_fused:
            src.update(robin_g_fn=problem.robin_g_xy,
                       robin_sides=tuple(sorted(self._robin)))
        if src:
            src.update(grid=structured_grid(md), dt=dt)
        bicgstab = kernel in ("B1-BiCGStab", "B5")
        cheb = {} if bicgstab else dict(bounds=self._cheb_bounds)
        n_iters = self.fused_iters if bicgstab else self.chebyshev_iters

        def prepare(ops):
            """``run(u_fam, steps, t0, guard) -> (u_fam, bad or None)`` on
            this operator."""
            kw = dict(n_iters=n_iters, use_ka=use_ka, extrapolate=ext, **cheb)
            if uniform:
                if patch:  # no assembled operator: ops is None
                    _, consts, _, mass_c, diag_c = self._patch_pieces()
                    inv_diag_c = 1.0 / diag_c
                else:
                    consts = uniform_mod.extract_constants(spec,
                                                           ops.system.vals)
                    mass_c = uniform_mod.family_constants(spec, ops.mass_diag)
                    inv_diag_c = 1.0 / uniform_mod.family_constants(
                        spec, ops.system_diag)
                args = (spec, consts, mass_c, inv_diag_c)
                if kernel == "B2":
                    def run(u, steps, t0, guard):
                        return _with_flag(fused_hbm.fused_solve_uniform_hbm(
                            *args, u, n_steps=steps, guard_every=guard,
                            t0=t0, **kw, **src), guard)
                else:
                    method = "bicgstab" if bicgstab else "chebyshev"

                    def run(u, steps, t0, guard):
                        return fused_solver.fused_solve_uniform(
                            *args, u, n_steps=steps, method=method, t0=t0,
                            **kw, **src), None
                return run
            coeffs = stencil_mod.extract_coefficients(pattern,
                                                      ops.system.vals)
            bmask_fam = dmask[perm]
            mass_fam = torch.where(bmask_fam,
                                   torch.zeros_like(ops.mass_diag[perm]),
                                   ops.mass_diag[perm])
            inv_diag_fam = 1.0 / ops.system_diag[perm]
            args = (pattern, coeffs, mass_fam, inv_diag_fam)
            if kernel == "B4":
                dead_fam = None if dead is None else dead[perm]

                def run(u, steps, t0, guard):
                    return _with_flag(fused_hbm.fused_solve_canvas_hbm(
                        *args, u, n_steps=steps, rect=rect,
                        guard_every=guard, t0=t0, dead_fam=dead_fam, **kw,
                        **src), guard)
                return run
            interior = 1.0 - bmask_fam.to(mass_fam.dtype)

            def run(u, steps, t0, guard):
                return fused_solver.fused_solve(
                    *args, u, interior, n_steps=steps, **kw), None
            return run

        def solve_fused(ops, u0):
            with span("crbe.prepare"):
                if dead is not None:
                    u0 = torch.where(dead, torch.zeros_like(u0), u0)
                # u0 goes in full (boundary values included): CN's first
                # RHS reads boundary columns; the kernels mask the warm
                # start.
                u0_fam = u0[perm]
                run = prepare(ops)
            ref_norm = torch.linalg.norm(u0_fam)
            if strided:
                u, rows = u0_fam, []
                bad = torch.tensor(-1, dtype=torch.int32, device=u.device)
                for i in range(n_steps // k_snap):
                    # One host read per chunk: a diverged run stops here.
                    if int(bad) < 0:
                        u, _ = run(u, k_snap, dt * k_snap * i, None)
                        tripped = linalg.diverged_state(u, ref_norm)
                        bad = torch.where(tripped, (i + 1) * k_snap, bad)
                    rows.append(u)
                sols = lifting.strided_trajectory(
                    lift_at, u0, torch.stack(rows)[:, inv], dt, k_snap,
                    n_steps)
                return sols, None, bad
            if kernel in ("B2", "B4"):
                u, bad = run(u0_fam, n_steps, 0.0,
                             fused_hbm.guard_stride(n_steps))
            else:
                # One launch: divergence is caught after the solve.
                u, _ = run(u0_fam, n_steps, 0.0, None)
                bad = torch.where(linalg.diverged_state(u, ref_norm),
                                  n_steps, -1).to(torch.int32)
            with span("crbe.lift"):
                sols = lifting.lifted_final_state(lift_at, u[inv], dt,
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
        if ops is None:
            # Patch route: the uniform matvec on the patch scalars, the
            # diagonal built from its 3 family constants.
            spec, consts, _, _, diag_c = self._patch_pieces()
            perm, _ = self._family_perm_tensors()
            diag = uniform_mod.family_diag_vector(spec, diag_c,
                                                  md.boundary_mask[perm])
            matvec = partial(uniform_mod.uniform_matvec, spec, consts)
            scale = 1.0 / torch.sqrt(diag)
            example = torch.zeros_like(diag)
        elif (self.matvec_impl in ("uniform", "fused", "fused_hbm")
                and not self._variable_coefficients
                and not self._robin and not self._obstacles
                and self._use_stencil() and md.structured_n >= 3):
            # Family-layout uniform matvec: the same spectrum (similarity
            # by permutation) at a fraction of the ELL gather's cost.
            pattern = self._stencil_pattern()
            spec = uniform_mod.build_uniform_spec(pattern)
            consts = uniform_mod.extract_constants(spec, ops.system.vals)
            matvec = partial(uniform_mod.uniform_matvec, spec, consts)
            perm, _ = self._family_perm_tensors()
            scale = 1.0 / torch.sqrt(ops.system_diag[perm])
            example = torch.zeros_like(ops.system_diag)
        else:
            matvec = partial(sparse.ell_matvec, ops.system)
            scale = 1.0 / torch.sqrt(ops.system_diag)
            example = torch.zeros_like(ops.system_diag)
        with span("crbe.interval"):
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
        switches to BiCGStab with a warning where that configuration has a
        BiCGStab route: the scan paths, and 'fused' through B1's BiCGStab
        variant (uniform operator) or B5 (canvas operator). The per-step
        kernels (fused_hbm), inhomogeneous Robin flux data, a sourced
        canvas solve and a mesh past the whole-loop budget have none; there
        it raises and names a working configuration, as the JAX solver
        does."""
        factor = self._cheb_factor
        lo, hi = self._cheb_bounds
        detail = (
            f"Chebyshev worst-case convergence factor {factor:.3f} >= "
            f"{linalg.CHEBYSHEV_FACTOR_GATE} for this operator (interval "
            f"[{lo:.3f}, {hi:.3f}], skew {self._cheb_skew:.3f})"
        )
        why_not = None
        if self.matvec_impl == "fused_hbm":
            why_not = "the per-step stripe kernels are Chebyshev-only"
        elif self.matvec_impl == "fused":
            if self._robin_g_fused:
                why_not = ("inhomogeneous Robin flux data runs on the "
                           "Chebyshev-only canvas step kernel")
            else:
                try:
                    self._fused_plan(method="bicgstab")
                except ValueError as e:
                    why_not = f"no whole-loop BiCGStab kernel takes it ({e})"
        if why_not is not None:
            raise ValueError(
                f"{detail} — the solve would diverge, and {why_not}. "
                f"Working configurations: matvec_impl='stencil' with "
                f"solver_method='bicgstab', or reduce dt / refine the "
                f"mesh until dt*|v|/h < ~0.4. chebyshev_policy='warn' "
                f"forces the solve anyway."
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

    def _apply_large_mesh_solver_policy(self, ops):
        """Past :data:`LARGE_MESH_DOFS`, once per solver, a float32
        BiCGStab solve gets a configuration that can finish: its relative
        residual target ``tol |b|`` is out of float32's reach at that size,
        so BiCGStab would run ``solver_maxiter`` iterations every step.

        - If the Chebyshev applicability check passes, switch to Chebyshev
          with k = min(24, max(chebyshev_iters, ceil(log 1e-4 / log
          factor))) iterations: a 1e-4 residual reduction per step, far
          below the discretisation error at these sizes.
        - Else keep BiCGStab and floor the tolerance at float32's rounding
          level ``sqrt(N) eps / 4``.

        A float64 solve can reach tight tolerances and is left as it is."""
        if self.mesh_data.midpoints.dtype != torch.float32:
            return
        n = self.mesh_data.number_of_segments
        try:
            self._check_chebyshev_applicable(ops, warn=False)
            factor = self._cheb_factor
        except (ValueError, RuntimeError):
            factor = 1.0  # no estimate: keep BiCGStab, floor its tolerance
        if factor < linalg.CHEBYSHEV_FACTOR_GATE:
            k = int(min(24.0, max(
                self.chebyshev_iters,
                math.ceil(math.log(1e-4) / math.log(max(factor, 1e-6))),
            )))
            warnings.warn(
                f"auto-switching solver_method to 'chebyshev' "
                f"(chebyshev_iters={k}) at {n} DOFs: BiCGStab's float32 "
                f"residual tolerance {self.solver_tol:g} is unreachable "
                f"at this size, and the Chebyshev convergence factor "
                f"{factor:.3f} passes the applicability check. "
                f"Construct the solver with solver_method='chebyshev' "
                f"(or a larger solver_tol) to silence this.",
                stacklevel=3,
            )
            self.solver_method = "chebyshev"
            self.chebyshev_iters = k
        else:
            floor = math.sqrt(n) * float(np.finfo(np.float32).eps) / 4
            if self.solver_tol < floor:
                warnings.warn(
                    f"raising solver_tol {self.solver_tol:g} -> {floor:.2e} "
                    f"at {n} DOFs: the float32 residual target is "
                    f"unreachable below ~sqrt(N)*eps and BiCGStab would "
                    f"burn maxiter every step (Chebyshev fallback not "
                    f"applicable: convergence factor {factor:.3f}).",
                    stacklevel=3,
                )
                self.solver_tol = floor

    def _large_mesh_policy_due(self) -> bool:
        return (self.solver_method == "bicgstab"
                and self.mesh_data.number_of_segments > LARGE_MESH_DOFS
                and not self._large_mesh_policy_applied)

    def solve(self, store_solutions: bool = True, collect_iters: bool = False):
        """Run the full time horizon; returns (nt, n_seg) solutions (or the
        (1, n_seg) final state when ``store_solutions=False``)."""
        with span("crbe.solve", solve=True):
            ops = None if self._use_patch() else self._require_ops()
            if self._large_mesh_policy_due():
                self._large_mesh_policy_applied = True
                self._apply_large_mesh_solver_policy(ops)
            if self.solver_method == "chebyshev":
                reroute = self.chebyshev_policy == "reroute"
                self._check_chebyshev_applicable(ops, warn=not reroute)
                if reroute:
                    if not self._cheb_factor < linalg.CHEBYSHEV_FACTOR_GATE:
                        self._reroute_divergent_chebyshev()
                        # Rerouted to BiCGStab: at the large-mesh size its
                        # float32 tolerance floor still applies.
                        if self._large_mesh_policy_due():
                            self._large_mesh_policy_applied = True
                            self._apply_large_mesh_solver_policy(ops)
                    elif not self._cheb_warn_evaluated:
                        self._cheb_warn_evaluated = True
                        self._warn_cheb_factor()
            if self._u0_cache is None:
                self._u0_cache = self.set_initial_condition()
            u0 = self._u0_cache
            key = (store_solutions, collect_iters) + self._config_key()
            if key not in self._solve_fn_cache:
                count("solve_fn_builds")
                with span("crbe.solve_fn"):
                    self._solve_fn_cache[key] = self._build_solve_fn(
                        store_solutions, collect_iters)
            sync = (torch.cuda.synchronize if self.device.type == "cuda"
                    else (lambda: None))
            start = time.perf_counter()
            solutions, iters, bad = self._solve_fn_cache[key](ops, u0)
            with span("crbe.sync"):
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
                with span("crbe.guard_read"):
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

    # --- plotting (reporting/plots.py; skipped without matplotlib) ---

    def plot_solution(self, analytical_sol_fn=None, time_index=None,
                      save_dir="results"):
        from airpollution_tpu_torch.reporting import plots

        plots.plot_solution_on_midpoints(self, analytical_sol_fn,
                                         time_index, save_dir)

    def plot_interpolated_solution(self, analytical_sol_fn=None,
                                   time_index=None, save_dir="results",
                                   name=""):
        from airpollution_tpu_torch.reporting import plots

        plots.plot_interpolated_solution(self, analytical_sol_fn,
                                         time_index, save_dir, name)

    def plot_error_evolution(self, errors, save_dir="results"):
        from airpollution_tpu_torch.reporting import plots

        plots.plot_error_evolution(self, errors, save_dir)


def _with_flag(out, guard):
    """A per-step solve's ``(state, bad)``: it returns the flag only when
    it was given a guard stride."""
    return out if guard is not None else (out, None)


def _fused_fits(n: int, extrapolate: bool, uniform: bool = True,
                method: str = "chebyshev",
                source_steady: bool = False) -> bool:
    """The JAX package's ``_pallas_fused_fits`` routing budget, kept so that
    one configuration picks the same kernel in both packages: the canvas
    operator's 15 coefficient + 12 input + 3 output + 18 Krylov canvases,
    or the uniform operator's 3 state + 9 Chebyshev (18 BiCGStab)
    canvases, +3 with extrapolation, +3 for a steady source's hoisted
    load, of n^2 float32 under 14 MiB."""
    if not uniform:
        n_canvases = 15 + 12 + 3 + 18
    elif method == "chebyshev":
        n_canvases = 3 + 9
    else:
        n_canvases = 3 + 18
    n_canvases += 3 if extrapolate else 0
    n_canvases += 3 if source_steady else 0
    return n_canvases * n * n * 4 < 14 * 1024 * 1024


# Reference-compatible alias (crbe.py:225).
BESCRFEM = CRBESolver
