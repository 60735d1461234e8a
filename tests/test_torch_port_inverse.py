"""The port's inverse-problem API (airpollution_tpu_torch/diagnostics/
inverse.py) against the JAX package's: primal and gradient of the
differentiable solves on the scan and fused engines, Adam fits, and the
Gauss-Newton posterior.

The same numpy-seeded inputs go through both packages, in float64. The
JAX fused engine runs its raw_b kernel in interpret mode in one case; in
the others its kernel is replaced, for the test, by the same polynomial
through jax's linalg.chebyshev (what the kernel is tested against in
tests/test_fused_adjoint.py), which keeps the suite fast."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.ops import pallas_hbm as jhbm  # noqa: E402
from airpollution_tpu.problems import (  # noqa: E402
    GaussianSourceProblem as JSource,
    Problem as JProblem,
)

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch import interop  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm  # noqa: E402

from torch_port_helpers import jax_plain_raw, mesh_pair, rel_diff  # noqa: E402

F64 = torch.float64


def _plume(lib, th):
    if lib == "jax":
        return JProblem(D=th[0], v=th[1:3])
    return tapt.Problem(D=th[0], v=th[1:3])


def _emitter(lib, th):
    cls = JSource if lib == "jax" else tapt.GaussianSourceProblem
    exp = jnp.exp if lib == "jax" else torch.exp
    return cls(q=exp(th[0]), xs=th[1], ys=th[2], sigma_s=3.0)


PROBLEMS = {"plume": (_plume, [0.1, 1.0, 0.5]),
            "emitter": (_emitter, [np.log(2.0), -1.0, 1.5])}
ENGINES = {"scan": dict(engine="scan", tol=1e-12, maxiter=500),
           "fused": dict(engine="fused_hbm", chebyshev_iters=24),
           "fused-interpret": dict(engine="fused_hbm", chebyshev_iters=24)}


@pytest.mark.parametrize("pname,engine,order,extrapolate,snapshots", [
    ("plume", "scan", 1, False, False),
    ("plume", "scan", 2, True, True),
    ("emitter", "scan", 1, True, True),
    ("emitter", "scan", 2, False, False),
    ("plume", "fused", 1, True, False),
    ("plume", "fused", 2, False, True),
    ("emitter", "fused", 2, True, True),
    ("emitter", "fused-interpret", 1, False, True),
])
def test_solve_primal_and_gradient_match_jax(monkeypatch, pname, engine,
                                             order, extrapolate, snapshots):
    """solve_final_state / solve_snapshots and the gradient of sum(u^2) in
    the problem's parameters, 9^2, nt=9: primal within 1e-9, gradient
    within 1e-7 of JAX's."""
    if engine == "fused":
        monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm",
                            jax_plain_raw)
    jmd, tmd = mesh_pair(9, nt=9)
    make, theta = PROBLEMS[pname]
    kw = dict(ENGINES[engine], time_scheme_order=order,
              extrapolate=extrapolate)
    idx = [2, 5, 8]

    def jsolve(th):
        p = make("jax", th)
        if snapshots:
            return jinv.solve_snapshots(p, jmd, indices=idx, **kw)
        return jinv.solve_final_state(p, jmd, **kw)

    def jloss(th):
        u = jsolve(th)
        return jnp.sum(u ** 2), u

    (_, ju), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(theta))
    th = torch.tensor(theta, dtype=F64, requires_grad=True)
    p = make("torch", th)
    if snapshots:
        u = tinv.solve_snapshots(p, tmd, indices=idx, **kw)
    else:
        u = tinv.solve_final_state(p, tmd, **kw)
    (g,) = torch.autograd.grad(torch.sum(u ** 2), th)
    assert u.shape == ju.shape
    assert rel_diff(u.detach(), ju) <= 1e-9
    assert rel_diff(g, jg) <= 1e-7


def test_u0_gradient_matches_jax(monkeypatch):
    """The gradient in an overriding initial state (the 4D-Var control)
    through the fused engine, against JAX's."""
    monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm", jax_plain_raw)
    jmd, tmd = mesh_pair(9, nt=9)
    u0 = np.random.default_rng(4).standard_normal(jmd.number_of_segments)
    kw = dict(engine="fused_hbm", chebyshev_iters=24)
    jg = jax.grad(lambda x: jnp.sum(jinv.solve_final_state(
        JProblem(), jmd, u0=x, **kw) ** 2))(jnp.asarray(u0))
    x = torch.tensor(u0, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(tinv.solve_final_state(
        tapt.Problem(), tmd, u0=x, **kw) ** 2), x)
    assert rel_diff(g, jg) <= 1e-7


class _RobinPlume(tapt.Problem):
    robin_sides = {"bottom": 0.05, "top": 0.0}


class _JRobinPlume(JProblem):
    robin_sides = {"bottom": 0.05, "top": 0.0}


def test_fused_engine_keeps_robin_rows(monkeypatch):
    """With Robin walls the fused engine masks the residual with the
    widened rectangle: it agrees with the scan engine (primal and D
    gradient) as on an all-Dirichlet problem. The JAX package's fused
    engine masks with the Dirichlet rectangle and sits ~5e-3 from its scan
    here (a fault of the reference, ROADMAP.md C)."""
    monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm", jax_plain_raw)
    jmd, tmd = mesh_pair(17, nt=17)
    out = {}
    for engine, kw in (("scan", dict(tol=1e-12, maxiter=500)),
                       ("fused_hbm", dict(chebyshev_iters=24))):
        D = torch.tensor(0.1, dtype=F64, requires_grad=True)
        u = tinv.solve_final_state(_RobinPlume(D=D, sigma=3.0, v=(0.3, -0.8)),
                                   tmd, engine=engine, **kw)
        (g,) = torch.autograd.grad(torch.sum(u ** 2), D)
        out[engine] = (u.detach(), g)
    assert rel_diff(out["fused_hbm"][0], out["scan"][0].numpy()) <= 1e-8
    assert rel_diff(out["fused_hbm"][1], out["scan"][1].numpy()) <= 1e-7
    jp = _JRobinPlume(D=0.1, sigma=3.0, v=jnp.asarray([0.3, -0.8]))
    jscan = jinv.solve_final_state(jp, jmd, engine="scan", tol=1e-12,
                                   maxiter=500)
    jfused = jinv.solve_final_state(jp, jmd, engine="fused_hbm",
                                    chebyshev_iters=24)
    assert rel_diff(out["scan"][0], jscan) <= 1e-9
    assert rel_diff(jfused, jscan) > 1e-3


def test_engine_routing_and_unported_options(monkeypatch):
    """'auto' keeps meshes below FUSED_ENGINE_MIN_N on the scan engine;
    'fused_hbm' runs every primal and adjoint sweep through B4's raw mode
    (its plain version on the CPU, no launch); the Robin overrides are
    ported (tests/test_torch_port_inverse_robin.py): they must name the
    problem's Robin sides."""
    assert tinv.FUSED_ENGINE_MIN_N == 320
    calls = []
    real = fused_hbm.plain_canvas_raw

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_hbm, "plain_canvas_raw", spy)
    _, tmd = mesh_pair(9, nt=5)
    D = torch.tensor(0.1, dtype=F64, requires_grad=True)
    tinv.solve_final_state(tapt.Problem(D=D), tmd, engine="auto")
    assert not calls
    u = tinv.solve_final_state(tapt.Problem(D=D), tmd, engine="fused_hbm")
    assert len(calls) == 4  # one sweep per step
    torch.sum(u ** 2).backward()
    # backward: the checkpointed steps re-run their sweeps, then the adjoint
    assert len(calls) == 4 + 4 + 4 and D.grad is not None
    assert fused_hbm.CANVAS_RAW_KERNEL.launches == 0
    with pytest.raises(ValueError, match="engine"):
        tinv.solve_final_state(tapt.Problem(), tmd, engine="pallas")
    with pytest.raises(ValueError, match="robin_sides"):
        tinv.solve_final_state(_RobinPlume(), tmd,
                               robin_alpha={"bottom": 0.1})
    calls.clear()
    alpha = torch.tensor(0.1, dtype=F64, requires_grad=True)
    u = tinv.solve_final_state(_RobinPlume(), tmd, engine="fused_hbm",
                               robin_alpha={"bottom": alpha, "top": 0.0},
                               robin_g_const={"bottom": 0.01})
    (g,) = torch.autograd.grad(torch.sum(u ** 2), alpha)
    assert len(calls) == 12 and torch.isfinite(g)


def test_problems_keep_tensor_parameters():
    """A float argument stays a float; a tensor keeps its graph through
    the initial condition, the boundary values and the source."""
    p = tapt.Problem(v=(1.0, 0.5), D=0.1)
    assert p.v == (1.0, 0.5) and isinstance(p.D, float)
    assert isinstance(p.reaction, float) and isinstance(p.sigma, float)
    D = torch.tensor(0.2, dtype=F64, requires_grad=True)
    vx = torch.tensor(0.7, dtype=F64, requires_grad=True)
    q = torch.tensor(1.5, dtype=F64, requires_grad=True)
    xyt = torch.tensor([[0.5, -1.0, 2.0], [3.0, 1.0, 1.0]], dtype=F64)
    tp = tapt.Problem(v=(vx, 0.5), D=D)
    jp = JProblem(v=jnp.asarray([0.7, 0.5]), D=0.2)
    np.testing.assert_allclose(tp.boundary_fn(xyt).detach().numpy(),
                               np.asarray(jp.boundary_fn(jnp.asarray(
                                   xyt.numpy()))), rtol=1e-14)
    gD, gv = torch.autograd.grad(tp.boundary_fn(xyt).sum(), (D, vx))
    jgD, jgv = jax.grad(lambda d, v: JProblem(
        v=jnp.stack([v, 0.5]), D=d).boundary_fn(jnp.asarray(
            xyt.numpy())).sum(), argnums=(0, 1))(0.2, 0.7)
    assert abs(float(gD) - float(jgD)) <= 1e-12 * abs(float(jgD))
    assert abs(float(gv) - float(jgv)) <= 1e-12 * abs(float(jgv))
    ts = tapt.GaussianSourceProblem(q=q, xs=1.0, ys=-0.5, sigma_s=2.0)
    (gq,) = torch.autograd.grad(ts.source_term(xyt).sum(), q)
    jgq = jax.grad(lambda qq: JSource(q=qq, xs=1.0, ys=-0.5, sigma_s=2.0)
                   .source_term(jnp.asarray(xyt.numpy())).sum())(1.5)
    assert abs(float(gq) - float(jgq)) <= 1e-12 * abs(float(jgq))


def test_params_from_numpy():
    params = {"log_q": np.asarray(0.3), "xy": np.asarray([-2.0, 1.0])}
    out = interop.params_from_numpy(params, dtype=F64, device="cpu",
                                    requires_grad=True)
    assert set(out) == {"log_q", "xy"}
    assert out["log_q"].shape == () and out["log_q"].requires_grad
    assert out["xy"].dtype == F64 and out["xy"].tolist() == [-2.0, 1.0]
