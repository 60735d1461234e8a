"""Iterative linear solvers for the implicit time step, PyTorch counterpart
of ``airpollution_tpu/ops/linalg.py``.

``matvec`` is a closure (ELL SpMV or the family-layout stencils), or a
:class:`BoundMatvec` that names the tensors it is built from. BiCGStab and
CG stop on the residual norm, which they read on the host once per
iteration, restarted GMRES once per cycle; Chebyshev runs a fixed number
of iterations with no inner products. The
transposes that the spectral estimates and the adjoint solves need come
from the vector-Jacobian product of the linear map (a backward pass
through one recorded application), which for a linear map is exactly
``A^T``.

:func:`differentiable_solve` and :func:`differentiable_chebyshev_solve`
are the counterparts of ``lax.custom_linear_solve``: one
``torch.autograd.Function`` whose forward runs the solve with no graph,
whose backward is one transposed solve (the implicit-function theorem), and
whose forward-mode rule is one more solve.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # unpreconditioned ||b - Ax||


def _identity(x):
    return x


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Optional[Callable] = None,
) -> SolveResult:
    """Preconditioned conjugate gradient for SPD systems; stops when
    ``||r|| <= max(tol ||b||, atol)`` or after ``maxiter`` iterations."""
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    target = max(tol * float(torch.linalg.norm(b)), atol)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter and float(torch.linalg.norm(r)) > target:
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return SolveResult(x=x, iterations=k, residual_norm=torch.linalg.norm(r))


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 20,
    maxiter: int = 50,
    precond: Optional[Callable] = None,
) -> SolveResult:
    """Restarted GMRES(m), right-preconditioned, as the JAX version: each
    cycle builds a ``restart``-vector Arnoldi basis (Gram-Schmidt against
    the whole basis, division guards instead of early exits) and solves
    the small Hessenberg least-squares problem by its regularised normal
    equations. ``maxiter`` counts restart cycles; the stopping test is the
    true residual ``||b - A x|| <= max(tol ||b||, atol)``."""
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = restart
    target = max(tol * float(torch.linalg.norm(b)), atol)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def guard(a):
        return torch.where(a == 0, eps, a)

    rows = torch.arange(m + 1, device=b.device)

    def cycle(x):
        r = b - matvec(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / guard(beta)
        H = torch.zeros((m + 1, m), dtype=b.dtype, device=b.device)
        for j in range(m):
            w = matvec(M(V[j]))
            h = torch.where(rows <= j, V @ w, 0.0)
            w = w - h @ V
            hnorm = torch.linalg.norm(w)
            h[j + 1] = hnorm
            H[:, j] = h
            V[j + 1] = w / guard(hnorm)
        e1 = torch.zeros(m + 1, dtype=b.dtype, device=b.device)
        e1[0] = beta
        A_small = H.T @ H + 1e-30 * torch.eye(m, dtype=b.dtype,
                                              device=b.device)
        y = torch.linalg.solve(A_small, H.T @ e1)
        return x + M(y @ V[:m])

    k = 0
    while k < maxiter and float(torch.linalg.norm(b - matvec(x))) > target:
        x = cycle(x)
        k += 1
    return SolveResult(x=x, iterations=k,
                       residual_norm=torch.linalg.norm(b - matvec(x)))


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Optional[Callable] = None,
    dot: Optional[Callable] = None,
    norm: Optional[Callable] = None,
) -> SolveResult:
    """Preconditioned BiCGStab (van der Vorst, right preconditioning) with
    the same divide-by-zero guards as the JAX version. ``dot`` / ``norm``
    replace ``torch.dot`` / ``torch.linalg.norm``: sums over the blocks of
    a row-sharded state (parallel/stencil_shard.py), as the JAX version's
    injected psums."""
    M = precond or _identity
    dot = dot or torch.dot
    norm = norm or torch.linalg.norm
    x = torch.zeros_like(b) if x0 is None else x0
    target = max(tol * float(norm(b)), atol)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def guard(a):
        return torch.where(a == 0, eps, a)

    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    k = 0
    while k < maxiter and float(norm(r)) > target:
        rho_new = dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / guard(dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        omega = dot(t, s) / guard(dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return SolveResult(x=x, iterations=k, residual_norm=norm(r))


def bicgstab_members(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Optional[Callable] = None,
) -> SolveResult:
    """:func:`bicgstab` over K independent systems at once, the
    counterpart of JAX's ``vmap`` of its ``bicgstab``: ``b`` and ``x0`` are
    (K, n), ``matvec`` and ``precond`` map (K, n) to (K, n) member by
    member (a stacked operator, ``sparse.ell_matvec_stacked``).

    Each member has its own target ``max(tol ||b_k||, atol)``, its own
    rho, alpha and omega and its own division guards. A member that meets
    its target, or has run ``maxiter`` iterations, keeps its iterate and
    its count unchanged from then on, as the ``select`` of JAX's batched
    ``while_loop`` keeps them, so each member's result and count are
    those of its serial solve. The loop reads the host once per
    iteration, whether any member is still active, for all of them.
    Returns ``iterations`` and ``residual_norm`` as (K,) tensors."""
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    target = torch.clamp(tol * torch.linalg.norm(b, dim=-1), min=atol)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    def guard(a):
        return torch.where(a == 0, eps, a)

    def dot(u, w):
        return torch.sum(u * w, dim=-1)

    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    ones = torch.ones(b.shape[0], dtype=b.dtype, device=b.device)
    rho, alpha, omega = ones, ones, ones
    iters = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    k = 0
    while k < maxiter:
        # Every active member has run k iterations, so k < maxiter is each
        # one's own count test.
        active = torch.linalg.norm(r, dim=-1) > target
        if not bool(active.any()):
            break
        rho_new = dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p_new = r + beta[:, None] * (p - omega[:, None] * v)
        phat = M(p_new)
        v_new = matvec(phat)
        alpha_new = rho_new / guard(dot(rhat, v_new))
        s = r - alpha_new[:, None] * v_new
        shat = M(s)
        t = matvec(shat)
        omega_new = dot(t, s) / guard(dot(t, t))
        x_new = x + alpha_new[:, None] * phat + omega_new[:, None] * shat
        r_new = s - omega_new[:, None] * t
        col = active[:, None]
        x = torch.where(col, x_new, x)
        r = torch.where(col, r_new, r)
        p = torch.where(col, p_new, p)
        v = torch.where(col, v_new, v)
        rho = torch.where(active, rho_new, rho)
        alpha = torch.where(active, alpha_new, alpha)
        omega = torch.where(active, omega_new, omega)
        iters = iters + active.to(torch.int64)
        k += 1
    return SolveResult(x=x, iterations=iters,
                       residual_norm=torch.linalg.norm(r, dim=-1))


def chebyshev(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    bounds,
    iters: int,
    precond: Optional[Callable] = None,
) -> SolveResult:
    """Preconditioned Chebyshev iteration (Saad, Iterative Methods,
    Alg. 12.1): ``iters`` matvec + axpy steps, no inner products, for a
    spectral interval ``bounds`` of the preconditioned operator."""
    lo, hi = bounds
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    theta = 0.5 * (hi + lo)
    delta = 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - matvec(x)
    d = M(r) / theta
    for _ in range(iters):
        x = x + d
        r = r - matvec(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * M(r)
        rho = rho_new
    return SolveResult(x=x, iterations=iters,
                       residual_norm=torch.linalg.norm(r))


def _transpose(matvec: Callable, example: torch.Tensor) -> Callable:
    """``y -> A^T y`` of a linear matvec: one application recorded on a zero
    input, then one backward pass through the retained graph per call (the
    vector-Jacobian product of a linear map is its transpose). A plain
    autograd backward costs the host a small fraction of what the function
    ``torch.func.vjp`` returns does, per call, with the same values."""
    with torch.enable_grad():
        x = torch.zeros_like(example, requires_grad=True)
        y = matvec(x)

    def vecmat(w):
        return torch.autograd.grad(y, x, w, retain_graph=True)[0]

    return vecmat


def _scaled_and_transpose(matvec, example, scale, transpose_matvec=None):
    """``B x = s * A(s * x)`` and its transpose ``B^T``: ``s *
    transpose_matvec(s * x)`` when ``A^T`` is given, else the autograd
    transpose of ``B``."""
    s = torch.ones_like(example) if scale is None else scale

    def scaled(x):
        return s * matvec(s * x)

    if transpose_matvec is None:
        return scaled, _transpose(scaled, example)

    def scaled_transpose(x):
        return s * transpose_matvec(s * x)

    return scaled, scaled_transpose


def power_bounds(
    matvec: Callable,
    example: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    iters: int = 48,
    margin: float = 0.05,
    transpose_matvec: Optional[Callable] = None,
):
    """``[lambda_min, lambda_max]`` of the Hermitian part of
    ``diag(scale) A diag(scale)``, widened by ``margin`` (an interval that
    slightly contains the spectrum keeps Chebyshev convergent). Two power
    iterations: one for ``lambda_max``, one shifted for ``lambda_min``.
    ``transpose_matvec``: ``A^T`` as a matvec of its own (a kernel that
    autograd cannot transpose); by default ``A^T`` is the autograd
    transpose of ``matvec``. Returns two 0-d tensors."""
    scaled, transpose = _scaled_and_transpose(matvec, example, scale,
                                              transpose_matvec)

    def sym(x):
        return 0.5 * (scaled(x) + transpose(x))

    idx = torch.arange(example.shape[0], dtype=example.dtype,
                       device=example.device)
    v0 = torch.sin(1.7 * idx + 0.3) + 0.01

    def power(op):
        v = v0 / torch.linalg.norm(v0)
        for _ in range(iters):
            w = op(v)
            v = w / torch.linalg.norm(w)
        return torch.dot(v, op(v))  # Rayleigh quotient

    lam_max = power(sym)
    shift = 1.05 * lam_max
    lam_min = shift - power(lambda x: shift * x - sym(x))
    return (1.0 - margin) * lam_min, (1.0 + margin) * lam_max


def skew_norm(
    matvec: Callable,
    example: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    iters: int = 32,
):
    """``||(B - B^T)/2||_2`` with ``B = diag(scale) A diag(scale)``: the
    imaginary extent of the preconditioned spectrum (power iteration on
    ``-K^2``, K skew)."""
    scaled, transpose = _scaled_and_transpose(matvec, example, scale)

    def skew(x):
        return 0.5 * (scaled(x) - transpose(x))

    idx = torch.arange(example.shape[0], dtype=example.dtype,
                       device=example.device)
    v = torch.sin(2.3 * idx + 0.7) + 0.01
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = skew(skew(v))
        v = -w / torch.linalg.norm(w)
    return torch.sqrt(torch.abs(torch.dot(v, -skew(skew(v)))))


def chebyshev_convergence_factor(lo, hi, beta) -> float:
    """Worst-case asymptotic Chebyshev factor for a spectrum in the box
    ``[lo, hi] x [-beta, beta]i`` (< 1 means convergent)."""
    lo, hi, beta = float(lo), float(hi), float(beta)
    d = 0.5 * (hi + lo)
    c = 0.5 * (hi - lo)
    num = beta + math.sqrt(beta * beta + c * c)
    den = d + math.sqrt(max(d * d - c * c, 0.0))
    return num / max(den, 1e-30)


#: Worst-case factor above which a Chebyshev solve is divergence-prone.
CHEBYSHEV_FACTOR_GATE = 0.97


def chebyshev_gate(lo, hi, beta, iters: int):
    """``(factor, k_rec, marginal)``: the worst-case factor, the iteration
    count for a 10x per-step residual reduction, and whether ``iters``
    buys less than a 2x reduction although the factor passes the gate."""
    factor = chebyshev_convergence_factor(lo, hi, beta)
    marginal = bool(0.0 < factor < CHEBYSHEV_FACTOR_GATE
                    and factor ** iters > 0.5)
    k_rec = (int(math.ceil(math.log(0.1) / math.log(factor)))
             if 0.0 < factor < 1.0 else 0)
    return factor, k_rec, marginal


#: A state norm beyond this factor x (1 + the initial norm) can only be a
#: diverging fixed-iteration solve (the problems are dissipative).
DIVERGENCE_NORM_FACTOR = 1e15


def diverged_state(u, ref_norm):
    """0-d bool tensor: the state is non-finite or has exploded."""
    return ~(torch.linalg.norm(u) <= DIVERGENCE_NORM_FACTOR * (1.0 + ref_norm))


def divergence_message(where: str, step, n_steps: int, iters=None) -> str:
    """Error text for a divergence caught by the runtime guards."""
    k = f"chebyshev_iters={iters}" if iters is not None else \
        "the fixed iteration count"
    return (
        f"{where}: solution diverged at step ~{step}/{n_steps} "
        f"(non-finite, or amplitude beyond 1e15x the initial state) — "
        f"per-step iteration error of the fixed-iteration solve amplified "
        f"over the horizon (dt too large for this mesh spacing at {k}). "
        f"Fixes: scale dt with h (try doubling nt); raise chebyshev_iters; "
        f"or use solver_method='bicgstab' on matvec_impl='ell'/'stencil'."
    )


class BoundMatvec:
    """A matvec ``x -> fn(x, *params)`` whose operator tensors ``params``
    are explicit, so that a differentiable solve can make them inputs of
    its autograd Function (the JAX package's ``custom_linear_solve`` finds
    the tensors a closure captures by tracing; here they are named).
    Calling it is ``fn(x, *params)``."""

    def __init__(self, fn: Callable, *params: torch.Tensor):
        self.fn = fn
        self.params = tuple(params)

    def __call__(self, x):
        return self.fn(x, *self.params)

    def detached(self) -> "BoundMatvec":
        """The same operator on detached tensors (no gradient, no tangent):
        what the spectral estimates and the solves themselves use."""
        return BoundMatvec(self.fn, *(p.detach() for p in self.params))


class _Solver:
    """What :class:`_ImplicitSolve` needs besides its tensors: the operator
    ``fn(x, *params)`` and the solve of A and of A^T, each a function
    ``(rhs, bound_matvec) -> x`` given the operator on detached tensors."""

    def __init__(self, fn, solve, transpose_solve):
        self.fn = fn
        self.solve = solve
        self.transpose_solve = transpose_solve


def _operator_vjp(fn, x, params, lam, needs):
    """``vjp(theta -> A(theta) x)(lam)`` for the params flagged in
    ``needs`` (None for the others)."""
    wanted = [i for i, need in enumerate(needs) if need]
    if not wanted:
        return [None] * len(params)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(i in wanted)
              for i, p in enumerate(params)]
        y = fn(x.detach(), *ps)
        grads = torch.autograd.grad(y, [ps[i] for i in wanted], lam,
                                    allow_unused=True)
    out = [None] * len(params)
    for i, g in zip(wanted, grads):
        out[i] = torch.zeros_like(params[i]) if g is None else g
    return out


def _operator_jvp(fn, x, params, tangents):
    """``(d/dtheta A(theta) x) . theta_dot``, by a vector-Jacobian product
    of the vector-Jacobian product (torch has no nested forward mode):
    ``g(w) = J^T w`` is linear in w, and its own transpose applied to the
    tangents is ``J theta_dot``."""
    pairs = [(i, t) for i, t in enumerate(tangents) if t is not None]
    if not pairs:
        return torch.zeros_like(x)
    with torch.enable_grad():
        ps = [p.detach().requires_grad_(True) for p in params]
        y = fn(x.detach(), *ps)
        w = torch.zeros_like(y, requires_grad=True)
        grads = torch.autograd.grad(y, [ps[i] for i, _ in pairs], w,
                                    create_graph=True, allow_unused=True)
        used = [(g, t) for g, (_, t) in zip(grads, pairs) if g is not None]
        if not used:
            return torch.zeros_like(x)
        (jx,) = torch.autograd.grad([g for g, _ in used], w,
                                    [t for _, t in used], allow_unused=True)
    return torch.zeros_like(x) if jx is None else jx


class _ImplicitSolve(torch.autograd.Function):
    """``x = solve(b)`` for the operator ``A(theta) = fn(., *theta)``, with
    the semantics of ``lax.custom_linear_solve``: the forward keeps no
    graph through the iterations; the backward is ``lam = solve_T(x_bar)``,
    ``b_bar = lam`` and ``theta_bar = -vjp(theta -> A(theta) x)(lam)``; the
    forward-mode rule is ``x_dot = solve(b_dot - A_dot x)``. ``x`` is the
    computed solution, so the gradient is the exact adjoint of what the
    solve computed when ``solve_T`` is the exact transpose of ``solve``
    (the Chebyshev polynomial), and of ``A^-1`` to the solve tolerance
    otherwise."""

    @staticmethod
    def forward(b, solver, *params):
        mv = BoundMatvec(solver.fn, *(p.detach() for p in params))
        return solver.solve(b.detach(), mv)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, solver, *params = inputs
        ctx.solver = solver
        ctx.save_for_backward(output, *params)
        ctx.save_for_forward(output, *params)

    @staticmethod
    def backward(ctx, x_bar):
        x, *params = ctx.saved_tensors
        solver = ctx.solver
        mv = BoundMatvec(solver.fn, *(p.detach() for p in params))
        lam = solver.transpose_solve(x_bar.detach(), mv)
        grads = _operator_vjp(solver.fn, x, params, lam,
                              ctx.needs_input_grad[2:])
        return (lam, None, *(None if g is None else -g for g in grads))

    @staticmethod
    def jvp(ctx, b_dot, _solver_dot, *param_dots):
        x, *params = ctx.saved_tensors
        solver = ctx.solver
        rhs = (torch.zeros_like(x) if b_dot is None else b_dot) \
            - _operator_jvp(solver.fn, x, params, param_dots)
        mv = BoundMatvec(solver.fn, *(p.detach() for p in params))
        return solver.solve(rhs, mv)


def _bound(matvec) -> BoundMatvec:
    if not isinstance(matvec, BoundMatvec):
        raise TypeError(
            "a differentiable solve needs a linalg.BoundMatvec, whose "
            "operator tensors are explicit (a plain closure would hide them "
            "from the gradient)")
    return matvec


def differentiable_solve(
    matvec: BoundMatvec,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-8,
    maxiter: int = 1000,
    precond: Optional[Callable] = None,
) -> torch.Tensor:
    """BiCGStab solve with the implicit-function gradient
    (:class:`_ImplicitSolve`): the backward is one BiCGStab solve with
    ``A^T`` (the vector-Jacobian product of the matvec) and the same Jacobi
    preconditioner (diag(A^T) == diag(A)), and gradients reach every tensor
    of ``matvec.params`` (the assembled operator's dependence on D and v).
    ``x0`` is only a warm start: no gradient flows through it. Gradient
    accuracy is bounded by ``tol``."""
    mv0 = _bound(matvec)
    x0 = None if x0 is None else x0.detach()

    def solve(rhs, mv):
        return bicgstab(mv, rhs, x0=x0, tol=tol, maxiter=maxiter,
                        precond=precond).x

    def transpose_solve(y, mv):
        return bicgstab(_transpose(mv, y), y, tol=tol, maxiter=maxiter,
                        precond=precond).x

    return _ImplicitSolve.apply(b, _Solver(mv0.fn, solve, transpose_solve),
                                *mv0.params)


def differentiable_chebyshev_solve(
    matvec: BoundMatvec,
    b: torch.Tensor,
    *,
    bounds,
    iters: int,
    precond: Optional[Callable] = None,
    solve_impl: Optional[Callable] = None,
    transpose_solve_impl: Optional[Callable] = None,
) -> torch.Tensor:
    """Fixed-iteration Chebyshev, ``x = p(A) b``, with the gradient of
    :class:`_ImplicitSolve`. Its exact adjoint is the same polynomial of
    ``A^T`` (same interval, same Jacobi diagonal), so the gradient is the
    exact discrete adjoint of the computed primal. Warm starts go outside,
    by the delta trick (``x = x0 + solve(b - A x0)``), so that the map stays
    linear in b (models/crbe.run_time_loop).

    ``solve_impl`` / ``transpose_solve_impl``: optional ``rhs -> x``
    replacements applying the same polynomial, such as kernel B4's raw
    mode over the coefficient canvases and their transpose
    (ops/fused_hbm.chebyshev_apply_canvas_hbm); they hold detached
    canvases, so the operator's gradient comes from ``matvec.params``
    alone. The defaults run :func:`chebyshev` on the matvec and on its
    transpose."""
    mv0 = _bound(matvec)

    def solve(rhs, mv):
        if solve_impl is not None:
            return solve_impl(rhs)
        return chebyshev(mv, rhs, bounds=bounds, iters=iters,
                         precond=precond).x

    def transpose_solve(y, mv):
        if transpose_solve_impl is not None:
            return transpose_solve_impl(y)
        return chebyshev(_transpose(mv, y), y, bounds=bounds, iters=iters,
                         precond=precond).x

    return _ImplicitSolve.apply(b, _Solver(mv0.fn, solve, transpose_solve),
                                *mv0.params)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """Diagonal (Jacobi) preconditioner M^{-1} r = r / diag."""
    inv = 1.0 / diag

    def apply(r):
        return inv * r

    return apply
