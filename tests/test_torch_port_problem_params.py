"""Tensor parameters of ``RotatingPlumeProblem`` and
``SquarePulseProblem`` (airpollution_tpu_torch/problems.py) stay in the
autograd graph, as in the JAX package: the closed form's derivative in
omega, and gradients through the differentiable solve, against jax.grad
in float64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from airpollution_tpu import problems as jproblems  # noqa: E402
from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402

from airpollution_tpu_torch import problems as tproblems  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402

from torch_port_helpers import mesh_pair, rel_diff  # noqa: E402

F64 = torch.float64
XYT = np.array([[3.0, 2.0, 1.0], [4.0, -1.0, 2.0]])


def test_rotating_plume_closed_form_derivative_in_omega():
    def jsum(omega):
        p = jproblems.RotatingPlumeProblem(omega=omega, D=0.05)
        return jnp.sum(p.analytical_solution(jnp.asarray(XYT)))

    jg = float(jax.grad(jsum)(0.1))
    omega = torch.tensor(0.1, dtype=F64, requires_grad=True)
    p = tproblems.RotatingPlumeProblem(omega=omega, D=0.05)
    (g,) = torch.autograd.grad(
        p.analytical_solution(torch.tensor(XYT)).sum(), omega)
    assert abs(float(g) - jg) <= 1e-10
    assert float(g) == pytest.approx(-0.191798, abs=1e-6)


def _rotating(lib, th):
    mod = jproblems if lib == "jax" else tproblems
    return mod.RotatingPlumeProblem(omega=th[0], D=th[1], sigma=th[2],
                                    x0=th[3], y0=-2.0)


def _pulse(lib, th):
    mod = jproblems if lib == "jax" else tproblems
    return mod.SquarePulseProblem(v=(0.5, -0.25), D=th[1], lo=-6.0,
                                  hi=4.0, amplitude=th[0])


@pytest.mark.parametrize("make,theta", [
    (_rotating, [0.05, 0.3, 2.0, 5.0]),
    (_pulse, [1.5, 0.2]),
], ids=["rotating-plume", "square-pulse"])
def test_solve_gradient_in_the_parameters_matches_jax(make, theta):
    """d/dtheta of a weighted sum of solve_final_state at 9^2, nt=9
    (scan engine, f64) against jax.grad."""
    jmd, tmd = mesh_pair(9, nt=9)
    w = np.random.default_rng(3).standard_normal(jmd.number_of_segments)
    kw = dict(engine="scan", tol=1e-13, maxiter=500)

    def jloss(th):
        return jnp.sum(jnp.asarray(w) * jinv.solve_final_state(
            make("jax", th), jmd, **kw))

    jg = jax.jit(jax.grad(jloss))(jnp.asarray(theta))
    th = torch.tensor(theta, dtype=F64, requires_grad=True)
    loss = torch.sum(torch.tensor(w) * tinv.solve_final_state(
        make("torch", th), tmd, **kw))
    (g,) = torch.autograd.grad(loss, th)
    assert bool((g != 0).all())
    assert rel_diff(g, jg) <= 1e-10
