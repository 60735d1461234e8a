"""The port's traced Robin overrides (``robin_alpha`` in the assembly,
``robin_g_const`` in run_time_loop's load) and the fits built on them,
``fit_deposition`` and ``fit_surface_exchange``
(airpollution_tpu_torch/diagnostics/inverse.py), against the JAX
package's, in float64 from the same inputs.

On a Robin problem the port's fused engine keeps the Robin rows (the
widened rectangle), and the JAX fused engine drops them (ROADMAP.md C), so
the port's fused engine is held against its own scan engine and against
the JAX scan engine, never against the JAX fused engine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.models import crbe as jcrbe  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402
from airpollution_tpu_torch.models import crbe as tcrbe  # noqa: E402

from torch_port_helpers import (  # noqa: E402,F401 (autouse fixture)
    mesh_pair,
    one_torch_thread,
    port_operators,
    rel_diff,
)

F64 = torch.float64
SIDES = ("right", "top")
SCAN = dict(engine="scan", tol=1e-12, maxiter=500)
FUSED = dict(engine="fused_hbm", chebyshev_iters=24)


def _walled(lib, alphas=(0.3, 0.1), v=(0.3, -0.2), D=0.5):
    cls = japt.SquarePulseProblem if lib == "jax" else tapt.SquarePulseProblem
    p = cls(v=v, D=D, lo=4.0, hi=16.0)
    p.robin_sides = dict(zip(SIDES, alphas))
    return p


def _overrides(lib, log_alpha, c_comp):
    exp = jnp.exp if lib == "jax" else torch.exp
    alphas = {s: exp(log_alpha[i]) for i, s in enumerate(SIDES)}
    g = {s: alphas[s] * c_comp[i] for i, s in enumerate(SIDES)}
    return alphas, g


LOG_ALPHA = np.log([0.4, 0.2])
C_COMP = np.array([0.05, 0.2])


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX scan engine's snapshots and gradient in (log alpha, c_comp)
    of sum(u^2), per time scheme, at 12^2, nt=9: one jitted program each,
    shared by the cases."""
    jmd, _ = mesh_pair(12, nt=9)
    jp = _walled("jax")
    out = {}
    for order in (1, 2):
        def loss(la, cc, order=order):
            alphas, g = _overrides("jax", la, cc)
            u = jinv.solve_snapshots(jp, jmd, indices=[2, 5, 8],
                                     robin_alpha=alphas, robin_g_const=g,
                                     time_scheme_order=order, **SCAN)
            return jnp.sum(u ** 2), u

        (_, u), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(jnp.asarray(LOG_ALPHA),
                                                 jnp.asarray(C_COMP))
        out[order] = (np.asarray(u), np.concatenate([g[0], g[1]]))
    return out


@pytest.mark.parametrize("engine,order,extrapolate", [
    ("scan", 1, False), ("scan", 2, True),
    ("fused_hbm", 1, True), ("fused_hbm", 2, False),
])
def test_robin_overrides_match_jax_scan(jax_reference, engine, order,
                                        extrapolate):
    """Snapshots and the gradient in the traced alphas and compensation
    points, through the scan engine and through the fused engine (the
    alphas reach B4's raw mode in the coefficient canvases): primal within
    1e-9 and gradient within 1e-7 of the JAX scan engine's."""
    _, tmd = mesh_pair(12, nt=9)
    la = torch.tensor(LOG_ALPHA, dtype=F64, requires_grad=True)
    cc = torch.tensor(C_COMP, dtype=F64, requires_grad=True)
    alphas, g = _overrides("torch", la, cc)
    kw = SCAN if engine == "scan" else FUSED
    u = tinv.solve_snapshots(_walled("torch"), tmd, indices=[2, 5, 8],
                             robin_alpha=alphas, robin_g_const=g,
                             time_scheme_order=order,
                             extrapolate=extrapolate, **kw)
    gl, gc = torch.autograd.grad(torch.sum(u ** 2), (la, cc))
    ju, jg = jax_reference[order]
    assert rel_diff(u, ju) <= 1e-9
    assert rel_diff(torch.cat([gl, gc]), jg) <= 1e-7


def test_fused_engine_on_robin_overrides_matches_port_scan():
    """The port's fused engine against its own scan engine with the
    overrides in place (deposition only, so the load has no g): 1e-9 on
    the final state, 1e-7 on d/d(log alpha)."""
    _, tmd = mesh_pair(17, nt=9)
    out = {}
    for engine, kw in (("scan", SCAN), ("fused_hbm", FUSED)):
        la = torch.tensor(LOG_ALPHA, dtype=F64, requires_grad=True)
        alphas = {s: torch.exp(la[i]) for i, s in enumerate(SIDES)}
        u = tinv.solve_final_state(_walled("torch"), tmd,
                                   robin_alpha=alphas, **kw)
        (g,) = torch.autograd.grad(torch.sum(u ** 2), la)
        out[engine] = (u.detach(), g)
    assert rel_diff(out["fused_hbm"][0], out["scan"][0].numpy()) <= 1e-9
    assert rel_diff(out["fused_hbm"][1], out["scan"][1].numpy()) <= 1e-7


def test_run_time_loop_robin_g_const_matches_jax():
    """run_time_loop's ``robin_g_const`` replaces ``problem.robin_g`` on
    the named sides only (the ELL loop, CN, the same operator in both
    packages)."""
    jmd, tmd = mesh_pair(9, nt=7)
    jp, tp = _walled("jax"), _walled("torch")
    dt = float(jmd.domain.T) / (jmd.nt - 1)
    jops = jcrbe.assemble(jmd, jp, dt, 2)
    u0 = np.asarray(jp.initial_condition_fn(jmd.midpoints))
    kw = dict(dt=dt, order=2, tol=1e-12, maxiter=500)
    want, _ = jcrbe.run_time_loop(jops, jnp.asarray(u0), mesh_data=jmd,
                                  problem=jp, robin_g_const={"top": 0.02},
                                  **kw)
    got, _ = tcrbe.run_time_loop(port_operators(jops), torch.tensor(u0),
                                 mesh_data=tmd, problem=tp,
                                 robin_g_const={"top": 0.02}, **kw)
    assert rel_diff(got, want) <= 1e-9
    plain, _ = tcrbe.run_time_loop(port_operators(jops), torch.tensor(u0),
                                   mesh_data=tmd, problem=tp, **kw)
    assert rel_diff(plain, want) > 1e-6


def _twin(lib, md, exchange):
    p = _walled(lib, alphas=(0.6, 0.15), v=(0.0, 0.0), D=1.0)
    solve = jinv.solve_snapshots if lib == "jax" else tinv.solve_snapshots
    g = ({"right": 0.6 * 0.05, "top": 0.15 * 0.2} if exchange else None)
    obs = np.asarray(solve(p, md, indices=[4, 8, 12, 16],
                           robin_g_const=g, **SCAN))
    rng = np.random.default_rng(0)
    return p, obs * (1.0 + 0.01 * rng.standard_normal(obs.shape))


def _mesh_pair_t2():
    jmd = japt.MeshData(japt.create_mesh(10, 20.0), japt.Domain(T=2.0),
                        nt=17, dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(10, 20.0), tapt.Domain(T=2.0),
                        nt=17, dtype=F64, device="cpu")
    return jmd, tmd


@pytest.mark.parametrize("exchange", [False, True],
                         ids=["deposition", "exchange"])
def test_fits_adam_steps_match_jax(exchange):
    """Three Adam steps of fit_deposition / fit_surface_exchange on the
    JAX tests' twin (10^2, nt=17, Domain(T=2), truth alphas {right 0.6,
    top 0.15}, c_comp {0.05, 0.2}, 1% noise): losses and fitted values
    within 1e-9 relative of the JAX fits'."""
    jmd, tmd = _mesh_pair_t2()
    jp, obs = _twin("jax", jmd, exchange)
    tp, tobs = _twin("torch", tmd, exchange)
    np.testing.assert_allclose(tobs, obs, rtol=1e-9)
    kw = dict(alpha0=0.25, snapshot_indices=[4, 8, 12, 16], steps=3,
              lr=0.05, **SCAN)
    if exchange:
        jout, jl = jinv.fit_surface_exchange(obs, jmd, jp, c_comp0=0.01,
                                             **kw)
        steps = []
        tout, tl = tinv.fit_surface_exchange(
            obs, tmd, tp, c_comp0=0.01, on_step=lambda i, v: steps.append(i),
            **kw)
        assert steps == [0, 1, 2]
        for s in SIDES:
            np.testing.assert_allclose(tout[s], jout[s], rtol=1e-9)
    else:
        jout, jl = jinv.fit_deposition(obs, jmd, jp, **kw)
        tout, tl = tinv.fit_deposition(obs, tmd, tp, **kw)
        assert set(tout) == set(SIDES)
        for s in SIDES:
            assert tout[s] == pytest.approx(jout[s], rel=1e-9)
    assert all(isinstance(v, float) for v in tl)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)


def test_fits_need_robin_sides():
    _, tmd = mesh_pair(5, nt=3)
    for fit in (tinv.fit_deposition, tinv.fit_surface_exchange):
        with pytest.raises(ValueError, match="robin_sides"):
            fit(np.zeros((2, tmd.number_of_segments)), tmd, tapt.Problem(),
                snapshot_indices=[1, 2], steps=1)


def test_fit_deposition_on_the_fused_engine_with_sensors():
    """The fused engine and a sensor network through fit_deposition: the
    loss falls over five steps and the alphas move toward the truth, as
    the scan engine's fit does from the same start."""
    jmd, tmd = _mesh_pair_t2()
    tp, obs = _twin("torch", tmd, False)
    sens = list(range(0, tmd.number_of_segments, 3))
    out = {}
    for name, kw in (("scan", SCAN), ("fused", FUSED)):
        out[name] = tinv.fit_deposition(
            obs[:, sens], tmd, tp, alpha0=0.25, snapshot_indices=[4, 8, 12,
                                                                  16],
            sensor_indices=sens, steps=5, lr=0.05, **kw)
    for name, (alphas, losses) in out.items():
        assert losses[-1] < losses[0], name
        assert alphas["right"] > 0.25, name
    np.testing.assert_allclose(out["fused"][1], out["scan"][1], rtol=1e-6)
