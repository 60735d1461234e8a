"""PDE-residual autodiff on tensors, PyTorch counterpart of
``airpollution_tpu/ops/autodiff.py``.

A field ``u_fn`` maps a batch of points (N, 3) in (x, y, t) to N values,
each depending on its own point only (an MLP applied row by row, with or
without the hard-IC ansatz). Then one reverse pass of ``u.sum()`` gives
every point's gradient, and one more reverse pass gives both Hessian rows
H e_x and H e_y (the points evaluated twice over, :func:`derivatives`):
two ``torch.autograd.grad`` calls in all, with the graph kept so that a
loss built on the residual stays differentiable in the network's
parameters. The Laplacian is the correct ``d2u/dx2 + d2u/dy2`` (the
reference's defect D1 mis-slices it).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _grad(out, x, create_graph):
    """d out.sum() / dx, zeros where ``out`` does not depend on ``x``."""
    if not out.requires_grad:
        return torch.zeros_like(x)
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=create_graph,
                               retain_graph=True, allow_unused=True,
                               materialize_grads=True)
    return g


def derivatives(u_fn: Callable[[torch.Tensor], torch.Tensor],
                pts: torch.Tensor, *, create_graph: bool = True,
                n_hessian: int | None = None):
    """``(u (N,), grad (N, 3), H e_x (M, 3), H e_y (M, 3))`` of the field
    at each point, the Hessian rows for the first ``M = n_hessian`` points
    (default all). With ``create_graph`` every output stays
    differentiable in whatever ``u_fn`` depends on (the network's
    parameters).

    The two Hessian rows come from one reverse pass: the first M points
    are evaluated twice, in one batch with all N, and the pass
    differentiates the first copy's d/dx column plus the second copy's
    d/dy column (each value depends on its own row only), so it yields
    H e_x on the first M rows and H e_y on the next M."""
    m = pts.shape[0] if n_hessian is None else int(n_hessian)
    with torch.enable_grad():
        base = pts.detach()
        x = torch.cat([base[:m], base]).requires_grad_(True)
        u = u_fn(x).reshape(-1)
        # The Hessian pass differentiates the gradient: keep its graph.
        g = _grad(u, x, create_graph=True)
        h = _grad(torch.cat([g[:m, 0], g[m:2 * m, 1]]), x, create_graph)
    return u[m:], g[m:], h[:m], h[m:2 * m]


def gradient_and_laplacian_xy(
    u_fn: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor,
    *, create_graph: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grad_xy (N, 2), grad_t (N, 1), laplacian_xy (N, 1)) at each point."""
    _, g, hx, hy = derivatives(u_fn, pts, create_graph=create_graph)
    return g[:, :2], g[:, 2:3], (hx[:, 0] + hy[:, 1])[:, None]


def gradient_and_hessian_xy(
    u_fn: Callable[[torch.Tensor], torch.Tensor], pts: torch.Tensor,
    *, create_graph: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like :func:`gradient_and_laplacian_xy` with the full spatial
    Hessian (N, 2, 2), rows H e_x and H e_y: the residual of a diffusion
    tensor needs the cross term."""
    _, g, hx, hy = derivatives(u_fn, pts, create_graph=create_graph)
    return g[:, :2], g[:, 2:3], torch.stack([hx[:, :2], hy[:, :2]], dim=1)


def _ndim(x) -> int:
    return 0 if isinstance(x, (int, float)) else torch.as_tensor(x).dim()


def _check_diffusion(D):
    if _ndim(D) == 3:
        raise NotImplementedError(
            "spatially varying diffusion TENSORS are supported by the "
            "FEM weak form only (the PINN strong-form residual would "
            "need div D, which the problem hooks do not supply)"
        )


def residual_from_derivatives(u, g, hx, hy, v, D, source, *, reaction=0.0,
                              D_grad=None) -> torch.Tensor:
    """The residual of :func:`pde_residual` from the field's value,
    gradient and Hessian rows at the points (:func:`derivatives`)."""
    _check_diffusion(D)
    nd = _ndim(D)
    grad_xy, grad_t = g[:, :2], g[:, 2:3]
    if nd == 2 and tuple(torch.as_tensor(D).shape) == (2, 2):
        hess = torch.stack([hx[:, :2], hy[:, :2]], dim=1)
        D_t = torch.as_tensor(D, dtype=g.dtype, device=g.device)
        diff_term = torch.einsum("ij,nij->n", D_t, hess).reshape(-1, 1)
    else:
        lap = (hx[:, 0] + hy[:, 1])[:, None]
        D_col = D.reshape(-1, 1) if nd == 1 else D
        diff_term = D_col * lap
    if isinstance(v, torch.Tensor):
        v2 = v.to(g.dtype)
        v2 = v2[None, :2] if v2.dim() == 1 else v2[:, :2]
        v_dot_grad = torch.sum(v2 * grad_xy, dim=1, keepdim=True)
    else:
        # A constant wind of two numbers: no tensor made from it, so no
        # host-to-device copy per residual.
        v_dot_grad = v[0] * grad_xy[:, 0:1] + v[1] * grad_xy[:, 1:2]
    res = grad_t + v_dot_grad - diff_term - source.reshape(-1, 1)
    if D_grad is not None:
        res = res - torch.sum(D_grad.to(g.dtype) * grad_xy, dim=1,
                              keepdim=True)
    if not (isinstance(reaction, (int, float)) and reaction == 0.0):
        res = res + reaction * u.reshape(-1, 1)
    return res


def pde_residual(u_fn, pts, v, D, source, *, reaction=0.0, D_grad=None,
                 create_graph: bool = True) -> torch.Tensor:
    """Advection-diffusion(-reaction) residual
    ``dc/dt + v . grad c - div(D grad c) + r c - s`` at each point, (N, 1).

    ``v`` is a constant wind (two numbers or a (2,) tensor) or a per-point
    (N, 2) field; ``D`` a number, a per-point (N,) field (then ``D_grad``
    (N, 2) supplies grad D for ``-div(D grad c) = -D lap c - grad D .
    grad c``) or a constant (2, 2) tensor, whose diffusion term is the
    full Hessian contraction ``sum_ij D_ij d2u/dxi dxj``. A spatially
    varying tensor raises NotImplementedError, as in the JAX package. A
    reaction rate equal to the number 0 adds nothing."""
    _check_diffusion(D)
    return residual_from_derivatives(
        *derivatives(u_fn, pts, create_graph=create_graph), v, D, source,
        reaction=reaction, D_grad=D_grad)


def problem_coefficients(problem, pts):
    """``(v, D, D_grad)`` of a problem at the points: ``problem.v``,
    ``problem.D`` and None for a constant-coefficient problem; for a
    ``variable_coefficients`` one the ``velocity_at``, ``diffusion_at``
    and ``diffusion_grad_at`` hooks at each point, with each point's own t
    where the problem is ``time_varying``."""
    if not getattr(problem, "variable_coefficients", False):
        return problem.v, problem.D, None
    xy = pts[..., :2].detach()
    targs = ((pts[..., 2].detach(),)
             if getattr(problem, "time_varying", False) else ())
    D_at = problem.diffusion_at(xy, *targs)
    if D_at.dim() >= 3:
        raise NotImplementedError(
            "spatially varying diffusion TENSORS are supported by "
            "the FEM weak form only (the PINN strong-form residual "
            "would need div D, which the problem hooks do not "
            "supply)"
        )
    return (problem.velocity_at(xy, *targs), D_at,
            problem.diffusion_grad_at(xy, *targs))


def problem_pde_residual(u_fn, pts, problem, source, *, reaction=0.0,
                         create_graph: bool = True) -> torch.Tensor:
    """:func:`pde_residual` with the coefficients read from the problem
    (:func:`problem_coefficients`)."""
    v, D, D_grad = problem_coefficients(problem, pts)
    return pde_residual(u_fn, pts, v, D, source, reaction=reaction,
                        D_grad=D_grad, create_graph=create_graph)
