"""The port's differentiable multi-species loop
(models/multispecies.run_multispecies_loop with ``differentiable=True`` and
a traced ``R``), ``solve_multispecies_snapshots`` and ``fit_chemistry``
(diagnostics/inverse.py) against the JAX package's, in float64 from the
same inputs.

The gradient in R goes through the port's problems.expm64 (a Taylor
polynomial with scaling and squaring, differentiated by autograd) where
JAX differentiates its Pade expm by the Frechet JVP: the two agree to
1e-7 relative here (measured ~1e-14)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402
from airpollution_tpu_torch.models import multispecies as tms  # noqa: E402

from torch_port_helpers import (  # noqa: E402,F401 (autouse fixture)
    one_torch_thread,
    rel_diff,
)

F64 = torch.float64
R_TRUE = np.array([[0.25, 0.0], [-0.25, 0.1]])
R_START = np.array([[0.2, 0.01], [-0.2, 0.15]])
IDX = [4, 8, 12, 16]
DR_RTOL = 1e-7  # d/dR: autograd through expm64 against JAX's Frechet JVP


def _meshes(ms=12, nt=17, structured=True):
    if structured:
        jmesh, tmesh = japt.create_mesh(ms, 20.0), tapt.create_mesh(ms, 20.0)
    else:
        jmesh = japt.create_unstructured_mesh(ms, 20.0, seed=1)
        tmesh = tapt.create_unstructured_mesh(ms, 20.0, seed=1)
    jmd = japt.MeshData(jmesh, japt.Domain(T=4.0), nt=nt, dtype=jnp.float64)
    tmd = tapt.MeshData(tmesh, tapt.Domain(T=4.0), nt=nt, dtype=F64,
                        device="cpu")
    return jmd, tmd


def _species(lib, shared=True):
    cls = japt.Problem if lib == "jax" else tapt.Problem
    return (cls(sigma=1.0), cls(sigma=2.0, D=0.1 if shared else 0.2))


@pytest.mark.parametrize("layout,order", [
    ("family", 1), ("family", 2), ("stacked", 1), ("stacked", 2),
    ("unstructured", 1),
])
def test_snapshots_and_R_gradient_match_jax(layout, order):
    """solve_multispecies_snapshots and d sum(u^2)/dR, the JAX chain test's
    problem (12^2, nt=17, Domain(T=4)): shared transport in family layout,
    per-species operators stacked on the ELL path, and an unstructured
    mesh (ELL, shared). Primal within 1e-9, gradient within DR_RTOL."""
    jmd, tmd = _meshes(structured=layout != "unstructured",
                       ms=12 if layout != "unstructured" else 9)
    shared = layout != "stacked"
    jmsp = japt.MultiSpeciesProblem(_species("jax", shared), R_TRUE)
    tmsp = tapt.MultiSpeciesProblem(_species("torch", shared), R_TRUE)
    kw = dict(indices=IDX if layout != "unstructured" else None,
              time_scheme_order=order, tol=1e-12, maxiter=500)

    def jloss(R):
        u = jinv.solve_multispecies_snapshots(jmsp, jmd, R=R, **kw)
        return jnp.sum(u ** 2), u

    (_, ju), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(R_START))
    R = torch.tensor(R_START, dtype=F64, requires_grad=True)
    u = tinv.solve_multispecies_snapshots(tmsp, tmd, R=R, **kw)
    (g,) = torch.autograd.grad(torch.sum(u ** 2), R)
    assert u.shape == ju.shape
    assert rel_diff(u, ju) <= 1e-9
    assert rel_diff(g, jg) <= DR_RTOL


def test_final_state_and_default_R():
    """``store_solutions=False`` gives the (1, K, n) final state, and
    without ``R`` the problem's own mechanism is used."""
    _, tmd = _meshes(ms=8, nt=9)
    msp = tapt.MultiSpeciesProblem(_species("torch"), R_TRUE)
    kw = dict(tol=1e-12, maxiter=500)
    final = tinv.solve_multispecies_snapshots(msp, tmd,
                                              store_solutions=False, **kw)
    rows = tinv.solve_multispecies_snapshots(msp, tmd, R=torch.tensor(
        R_TRUE, dtype=F64), **kw)
    assert final.shape == (1, 2, tmd.number_of_segments)
    assert rows.shape == (9, 2, tmd.number_of_segments)
    assert rel_diff(final[0], rows[-1].numpy()) <= 1e-12


def test_differentiable_loop_is_bicgstab_only():
    """As in the JAX package: the differentiable loop wraps the Krylov
    solve, so Chebyshev raises ValueError; without ``differentiable`` the
    R override equals the problem's mechanism."""
    _, tmd = _meshes(ms=6, nt=5)
    msp = tapt.MultiSpeciesProblem(_species("torch"), R_TRUE)
    s = tapt.MultiSpeciesSolver(tmd.domain, msp, tmd, matvec_impl="ell",
                                splitting="strang", device="cpu")
    ops = s.build_global_matrices()
    C0 = s.set_initial_condition()
    base = dict(mesh_data=tmd, problem=msp, dt=s.dt, order=1, tol=1e-12,
                maxiter=200)
    with pytest.raises(ValueError, match="bicgstab"):
        tms.run_multispecies_loop(ops, C0, differentiable=True,
                                  solver="chebyshev", **base)
    a, _ = tms.run_multispecies_loop(ops, C0, **base)
    b, _ = tms.run_multispecies_loop(ops, C0, R=torch.tensor(R_TRUE),
                                     **base)
    assert torch.equal(a, b)


def _chain_R(lib):
    exp, stack = ((jnp.exp, jnp.stack) if lib == "jax"
                  else (torch.exp, torch.stack))

    def make_R(params):
        r1, r2 = exp(params["log_r1"]), exp(params["log_r2"])
        return stack([stack([r1, 0.0 * r1]), stack([-r1, r2])])
    return make_R


@pytest.mark.parametrize("mechanism", ["make_R", "dense", "sensors"])
def test_fit_chemistry_adam_steps_match_jax(mechanism):
    """Three Adam steps of fit_chemistry on the JAX chain test's twin: the
    chain's two log-rates through ``make_R``, a dense R from ``R0``, and a
    sensor network (10^2, nt=9); losses and R within 1e-9 relative."""
    jmd, tmd = _meshes(ms=10, nt=9)
    idx = [2, 4, 6, 8]
    jsp, tsp = _species("jax"), _species("torch")
    obs = np.asarray(jinv.solve_multispecies_snapshots(
        japt.MultiSpeciesProblem(jsp, R_TRUE), jmd, indices=idx, tol=1e-12,
        maxiter=500))
    kw = dict(snapshot_indices=idx, steps=3, lr=0.05, tol=1e-12,
              maxiter=500)
    jkw, tkw = dict(kw), dict(kw)
    if mechanism == "make_R":
        init = {"log_r1": np.log(0.1), "log_r2": np.log(0.3)}
        jkw.update(make_R=_chain_R("jax"),
                   init_params={k: jnp.asarray(v) for k, v in init.items()})
        tkw.update(make_R=_chain_R("torch"), init_params=init)
    else:
        jkw["R0"] = tkw["R0"] = 0.1 * np.eye(2)
    if mechanism == "sensors":
        sens = list(range(0, jmd.number_of_segments, 5))
        obs = obs[..., sens]
        jkw["sensor_indices"] = tkw["sensor_indices"] = sens
    jR, jp, jl = jinv.fit_chemistry(obs, jmd, jsp, **jkw)
    tR, tp, tl = tinv.fit_chemistry(obs, tmd, tsp, **tkw)
    np.testing.assert_allclose(tl, jl, rtol=1e-9)
    assert rel_diff(tR, jR) <= 1e-9
    assert not tR.requires_grad
    assert set(tp) == set(jp)
    with pytest.raises(ValueError, match="init_params"):
        tinv.fit_chemistry(obs, tmd, tsp, make_R=_chain_R("torch"))
