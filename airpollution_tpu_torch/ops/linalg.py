"""Iterative linear solvers for the implicit time step, PyTorch counterpart
of ``airpollution_tpu/ops/linalg.py``.

``matvec`` is a closure (ELL SpMV or the family-layout stencils). BiCGStab
stops on the residual norm, which it reads on the host once per iteration;
Chebyshev runs a fixed number of iterations with no inner products. The
transposes that the spectral estimates need come from the vector-Jacobian
product of the linear map (``torch.func.vjp``), which for a linear map is
exactly ``A^T``.
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


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    tol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 1000,
    precond: Optional[Callable] = None,
) -> SolveResult:
    """Preconditioned BiCGStab (van der Vorst, right preconditioning) with
    the same divide-by-zero guards as the JAX version."""
    M = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    target = max(tol * float(torch.linalg.norm(b)), atol)
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
    while k < maxiter and float(torch.linalg.norm(r)) > target:
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / guard(torch.dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        omega = torch.dot(t, s) / guard(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    return SolveResult(x=x, iterations=k, residual_norm=torch.linalg.norm(r))


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


def _scaled_and_transpose(matvec, example, scale):
    """``B x = s * A(s * x)`` and its transpose ``B^T`` (via the VJP)."""
    s = torch.ones_like(example) if scale is None else scale

    def scaled(x):
        return s * matvec(s * x)

    _, vjp_fn = torch.func.vjp(scaled, example)

    def transpose(x):
        return vjp_fn(x)[0]

    return scaled, transpose


def power_bounds(
    matvec: Callable,
    example: torch.Tensor,
    *,
    scale: Optional[torch.Tensor] = None,
    iters: int = 48,
    margin: float = 0.05,
):
    """``[lambda_min, lambda_max]`` of the Hermitian part of
    ``diag(scale) A diag(scale)``, widened by ``margin`` (an interval that
    slightly contains the spectrum keeps Chebyshev convergent). Two power
    iterations: one for ``lambda_max``, one shifted for ``lambda_min``.
    Returns two 0-d tensors."""
    scaled, transpose = _scaled_and_transpose(matvec, example, scale)

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


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """Diagonal (Jacobi) preconditioner M^{-1} r = r / diag."""
    inv = 1.0 / diag

    def apply(r):
        return inv * r

    return apply
