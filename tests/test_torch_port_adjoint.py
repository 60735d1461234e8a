"""The port's differentiable solves against the JAX package: the
transposed coefficient canvases, kernel B4's raw mode (its plain version,
against the JAX kernel in interpret mode), the two solve Functions
(gradcheck, reverse and forward mode) and the differentiable time loop.

The same numpy-seeded inputs go through both packages, in float64."""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from airpollution_tpu.models import crbe as jcrbe  # noqa: E402
from airpollution_tpu.ops import linalg as jlinalg  # noqa: E402
from airpollution_tpu.ops import pallas_hbm as jhbm  # noqa: E402
from airpollution_tpu.ops import stencil as jstencil  # noqa: E402
from airpollution_tpu.problems import Problem as JProblem  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.models import crbe as tcrbe  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm, linalg  # noqa: E402
from airpollution_tpu_torch.ops import stencil as tstencil  # noqa: E402

from torch_port_helpers import mesh_pair, rel_diff  # noqa: E402

F64 = torch.float64


def _coefficient_pair(ms, dt=0.13, order=2):
    """The JAX and the port's coefficient grids of one assembled operator
    (the port's from the JAX values, through numpy)."""
    jmd, tmd = mesh_pair(ms)
    jops = jcrbe.assemble(jmd, JProblem(), dt, order)
    jpat = jstencil.get_pattern(jmd)
    jc = jstencil.extract_coefficients(jpat, jops.system.vals)
    tc = tuple(torch.tensor(np.asarray(g)) for g in jc)
    return jmd, tmd, jops, jpat, jc, tc


def test_transpose_coefficients_equal_jax_bit_for_bit():
    _, _, _, _, jc, tc = _coefficient_pair(9)
    got = tstencil.transpose_coefficients(tc)
    want = jstencil.transpose_coefficients(jc)
    assert len(got) == 15
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    twice = tstencil.transpose_coefficients(got)
    for g, w in zip(twice, tc):
        assert torch.equal(g, w)


def test_transposed_matvec_is_the_adjoint():
    """stencil_matvec(transpose(c), x) . y == x . stencil_matvec(c, y)."""
    _, tmd, _, _, _, tc = _coefficient_pair(9)
    pattern = tstencil.get_pattern(tmd)
    rng = np.random.default_rng(3)
    x, y = (torch.tensor(rng.standard_normal(tmd.number_of_segments))
            for _ in range(2))
    ATx = tstencil.stencil_matvec(pattern, tstencil.transpose_coefficients(tc),
                                  x)
    Ay = tstencil.stencil_matvec(pattern, tc, y)
    # Relative to the sum's scale: the dot products cancel to ~0.2 from
    # terms of size ~|x| |Ay|.
    scale = float(torch.linalg.norm(x) * torch.linalg.norm(Ay))
    assert abs(float(torch.dot(ATx, y) - torch.dot(x, Ay))) <= 1e-13 * scale


def test_plain_raw_mode_matches_the_jax_kernel():
    """chebyshev_apply_canvas_hbm's plain version (CPU) against the JAX
    raw_b kernel in interpret mode at 17^2, k=6, over the coefficients
    and their transpose."""
    jmd, tmd = mesh_pair(17)
    jops = jcrbe.assemble(jmd, JProblem(), 0.05, 1)
    pat = jstencil.get_pattern(jmd)
    perm = jnp.asarray(pat.perm)
    jc = jstencil.extract_coefficients(pat, jops.system.vals)
    inv_diag = (1.0 / jops.system_diag)[perm]
    bounds = jlinalg.power_bounds(
        partial(jstencil.stencil_matvec, pat, jc), jnp.zeros_like(inv_diag),
        scale=1.0 / jnp.sqrt(jops.system_diag[perm]))
    bounds = tuple(float(v) for v in bounds)
    b = np.random.default_rng(0).standard_normal(jmd.number_of_segments)
    tpat = tstencil.get_pattern(tmd)
    for transposed in (False, True):
        jcc = jstencil.transpose_coefficients(jc) if transposed else jc
        want = jhbm.chebyshev_apply_canvas_hbm(
            pat, jcc, inv_diag, jnp.asarray(b), n_iters=6, bounds=bounds,
            interpret=True)
        got = fused_hbm.chebyshev_apply_canvas_hbm(
            tpat, tuple(torch.tensor(np.asarray(g)) for g in jcc),
            torch.tensor(np.asarray(inv_diag)), torch.tensor(b), n_iters=6,
            bounds=bounds)
        assert rel_diff(got, want) <= 1e-12, transposed


def _dense_operator(n, seed):
    """A non-symmetric, diagonally dominant operator with two parameters:
    A(a, s) x = (M + a I) x + s roll(x, 1)."""
    rng = np.random.default_rng(seed)
    M = torch.tensor(rng.standard_normal((n, n)) + 6.0 * np.eye(n))

    def fn(x, a, s):
        return M @ x + a * x + s * torch.roll(x, 1)

    return fn


def test_differentiable_solve_gradcheck():
    fn = _dense_operator(6, 0)
    b = torch.tensor(np.random.default_rng(1).standard_normal(6),
                     requires_grad=True)
    a = torch.tensor(0.3, dtype=F64, requires_grad=True)
    s = torch.tensor(0.2, dtype=F64, requires_grad=True)

    def solve(b, a, s):
        return linalg.differentiable_solve(linalg.BoundMatvec(fn, a, s), b,
                                           tol=1e-14, maxiter=200)

    assert torch.autograd.gradcheck(solve, (b, a, s), check_forward_ad=True)


def test_differentiable_chebyshev_solve_gradcheck():
    """The Chebyshev Function's gradient is the exact adjoint of the
    polynomial it computes: gradcheck holds at any iteration count."""
    fn = _dense_operator(6, 2)
    b = torch.tensor(np.random.default_rng(3).standard_normal(6),
                     requires_grad=True)
    a = torch.tensor(0.3, dtype=F64, requires_grad=True)
    s = torch.tensor(0.2, dtype=F64, requires_grad=True)
    mv = linalg.BoundMatvec(fn, a.detach(), s.detach())
    diag = torch.diagonal(torch.stack(
        [mv(e) for e in torch.eye(6, dtype=F64)], dim=1))
    bounds = linalg.power_bounds(mv, torch.zeros(6, dtype=F64),
                                 scale=1.0 / torch.sqrt(diag))
    precond = linalg.jacobi_preconditioner(diag)

    def solve(b, a, s):
        return linalg.differentiable_chebyshev_solve(
            linalg.BoundMatvec(fn, a, s), b, bounds=bounds, iters=5,
            precond=precond)

    # b enters linearly through p(A); (a, s) through the implicit-function
    # term, exact only for the converged solve: check b at 5 iterations,
    # the operator at a converged count.
    assert torch.autograd.gradcheck(lambda b: solve(b, a.detach(),
                                                    s.detach()), (b,),
                                    check_forward_ad=True)

    def converged(b, a, s):
        return linalg.differentiable_chebyshev_solve(
            linalg.BoundMatvec(fn, a, s), b, bounds=bounds, iters=60,
            precond=precond)

    assert torch.autograd.gradcheck(converged, (b, a, s),
                                    check_forward_ad=True)


def test_differentiable_solve_needs_a_bound_matvec():
    with pytest.raises(TypeError, match="BoundMatvec"):
        linalg.differentiable_solve(lambda x: x, torch.ones(3))


@pytest.mark.parametrize("solver,kw", [
    ("bicgstab", {}), ("chebyshev", {"chebyshev_iters": 30})])
def test_differentiable_time_loop_gradient_matches_jax(solver, kw):
    """d sum(u_T^2) / dD through run_time_loop(differentiable=True) on the
    ELL operator, against jax.grad of the same loss (9^2, nt=9)."""
    jmd, tmd = mesh_pair(9, nt=9)
    dt = 10.0 / 8

    def jloss(D):
        p = JProblem(D=D)
        ops = jcrbe.assemble(jmd, p, dt, 1)
        sols, _ = jcrbe.run_time_loop(
            ops, p.initial_condition_fn(jmd.midpoints), mesh_data=jmd,
            problem=p, dt=dt, order=1, tol=1e-12, maxiter=500,
            store_solutions=False, differentiable=True, solver=solver, **kw)
        return jnp.sum(sols[-1] ** 2)

    jval, jgrad = jax.value_and_grad(jloss)(0.1)
    D = torch.tensor(0.1, dtype=F64, requires_grad=True)
    p = tapt.Problem(D=D)
    ops = tcrbe.assemble(tmd, p, dt, 1)
    sols, iters = tcrbe.run_time_loop(
        ops, p.initial_condition_fn(tmd.midpoints), mesh_data=tmd, problem=p,
        dt=dt, order=1, tol=1e-12, maxiter=500, store_solutions=False,
        differentiable=True, solver=solver, **kw)
    loss = torch.sum(sols[-1] ** 2)
    (grad,) = torch.autograd.grad(loss, D)
    assert iters is None
    assert abs(float(loss.detach()) - float(jval)) <= 1e-9 * abs(float(jval))
    assert abs(float(grad) - float(jgrad)) <= 1e-9 * abs(float(jgrad))


def test_differentiable_loop_refuses_iteration_counts():
    _, tmd = mesh_pair(5, nt=3)
    p = tapt.Problem()
    ops = tcrbe.assemble(tmd, p, 0.1, 1)
    with pytest.raises(ValueError, match="iteration"):
        tcrbe.run_time_loop(ops, p.initial_condition_fn(tmd.midpoints),
                            mesh_data=tmd, problem=p, dt=0.1, order=1,
                            tol=1e-8, maxiter=10, differentiable=True,
                            collect_iters=True)
