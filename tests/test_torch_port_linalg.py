"""The port's linear solvers and spectral estimates (ops/linalg) against the
JAX package's on one assembled operator, float64, within 1e-10."""

import numpy as np
import jax.numpy as jnp
import pytest
from functools import partial

torch = pytest.importorskip("torch")

import airpollution_tpu as japt
from airpollution_tpu.models import crbe as j_crbe
from airpollution_tpu.ops import linalg as j_linalg
from airpollution_tpu.ops import sparse as j_sparse

from airpollution_tpu_torch.ops import linalg as t_linalg
from airpollution_tpu_torch.ops import sparse as t_sparse

from torch_port_helpers import mesh_pair, port_operators, rel_diff

TOL = 1e-10


@pytest.fixture(scope="module")
def operator():
    jmd, _ = mesh_pair(13, nt=21)
    jops = j_crbe.assemble(jmd, japt.Problem(), 0.5, 1, "reference")
    tops = port_operators(jops)
    b = np.random.default_rng(7).normal(size=jmd.number_of_segments)
    b[np.asarray(jmd.boundary_mask)] = 0.0
    return jops, tops, b


def _pieces(jops, tops):
    jmv = partial(j_sparse.ell_matvec, jops.system)
    tmv = partial(t_sparse.ell_matvec, tops.system)
    jscale = 1.0 / jnp.sqrt(jops.system_diag)
    tscale = 1.0 / torch.sqrt(tops.system_diag)
    return jmv, tmv, jscale, tscale


def test_power_bounds_and_skew_norm_match_jax(operator):
    jops, tops, _ = operator
    jmv, tmv, jscale, tscale = _pieces(jops, tops)
    example_j = jnp.zeros_like(jops.system_diag)
    example_t = torch.zeros_like(tops.system_diag)
    jb = j_linalg.power_bounds(jmv, example_j, scale=jscale)
    tb = t_linalg.power_bounds(tmv, example_t, scale=tscale)
    for a, b in zip(tb, jb):
        assert abs(float(a) - float(b)) <= TOL * abs(float(b))
    js = j_linalg.skew_norm(jmv, example_j, scale=jscale)
    ts = t_linalg.skew_norm(tmv, example_t, scale=tscale)
    assert abs(float(ts) - float(js)) <= TOL * abs(float(js))
    f_t = t_linalg.chebyshev_convergence_factor(*tb, ts)
    f_j = float(j_linalg.chebyshev_convergence_factor(*jb, js))
    assert f_t == pytest.approx(f_j, rel=TOL)
    assert t_linalg.chebyshev_gate(*tb, ts, 4) == pytest.approx(
        j_linalg.chebyshev_gate(*jb, js, 4), rel=TOL)


@pytest.mark.parametrize("iters", [1, 4, 9])
def test_chebyshev_matches_jax(operator, iters):
    jops, tops, b = operator
    jmv, tmv, _, _ = _pieces(jops, tops)
    bounds = (0.55, 1.6)
    x0 = 0.3 * b
    j = j_linalg.chebyshev(jmv, jnp.asarray(b), x0=jnp.asarray(x0),
                           bounds=bounds, iters=iters,
                           precond=j_linalg.jacobi_preconditioner(
                               jops.system_diag))
    t = t_linalg.chebyshev(tmv, torch.tensor(b), x0=torch.tensor(x0),
                           bounds=bounds, iters=iters,
                           precond=t_linalg.jacobi_preconditioner(
                               tops.system_diag))
    assert rel_diff(t.x, j.x) <= TOL
    assert float(t.residual_norm) == pytest.approx(float(j.residual_norm),
                                                   rel=1e-8)


@pytest.mark.parametrize("tol,maxiter", [(1e-10, 200), (1e-3, 200),
                                         (1e-12, 2)])
def test_bicgstab_matches_jax(operator, tol, maxiter):
    jops, tops, b = operator
    jmv, tmv, _, _ = _pieces(jops, tops)
    j = j_linalg.bicgstab(jmv, jnp.asarray(b), tol=tol, maxiter=maxiter,
                          precond=j_linalg.jacobi_preconditioner(
                              jops.system_diag))
    t = t_linalg.bicgstab(tmv, torch.tensor(b), tol=tol, maxiter=maxiter,
                          precond=t_linalg.jacobi_preconditioner(
                              tops.system_diag))
    assert t.iterations == int(j.iterations)
    assert rel_diff(t.x, j.x) <= TOL


def test_divergence_helpers_match_jax():
    u = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    for ref in (0.0, 1.0):
        for scale in (1.0, 1e16, float("nan"), float("inf")):
            got = bool(t_linalg.diverged_state(u * scale, ref))
            want = bool(j_linalg.diverged_state(jnp.asarray(u.numpy() * scale),
                                                ref))
            assert got == want, (ref, scale)
    msg = t_linalg.divergence_message("CRBESolver fused solve", 64, 1000, 4)
    assert "step ~64/1000" in msg and "chebyshev_iters=4" in msg


def _random_spd(n, rng):
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


def _dense_system(kind):
    """The dense systems of tests/test_linalg.py: an SPD matrix (cg) and a
    diagonally dominant nonsymmetric one (gmres), with their RHS."""
    if kind == "spd":
        rng = np.random.default_rng(0)
        A = _random_spd(40, rng)
    else:
        rng = np.random.default_rng(5)
        A = rng.normal(size=(50, 50)) * 0.1 + np.diag(rng.uniform(2, 3, 50))
    return A, rng.normal(size=A.shape[0])


@pytest.mark.parametrize("kw", [dict(tol=1e-12), dict(tol=1e-14, maxiter=3),
                                dict(tol=1e-12, precond=True)],
                         ids=["converged", "maxiter", "jacobi"])
def test_cg_matches_jax(kw):
    A, b = _dense_system("spd")
    kw = dict(kw)
    jpc = tpc = None
    if kw.pop("precond", False):
        jpc = j_linalg.jacobi_preconditioner(jnp.asarray(np.diag(A)))
        tpc = t_linalg.jacobi_preconditioner(torch.tensor(np.diag(A)))
    j = j_linalg.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                    precond=jpc, **kw)
    t = t_linalg.cg(lambda x: torch.tensor(A) @ x, torch.tensor(b),
                    precond=tpc, **kw)
    assert t.iterations == int(j.iterations)
    assert rel_diff(t.x, j.x) <= TOL
    if "maxiter" in kw:
        assert t.iterations == kw["maxiter"]
    else:
        np.testing.assert_allclose(t.x.numpy(), np.linalg.solve(A, b),
                                   rtol=1e-8)


@pytest.mark.parametrize("kw", [dict(tol=1e-10, restart=25, maxiter=20),
                                dict(tol=1e-14, restart=6, maxiter=2)],
                         ids=["converged", "maxiter"])
def test_gmres_matches_jax(kw):
    A, b = _dense_system("nonsymmetric")
    j = j_linalg.gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                       precond=j_linalg.jacobi_preconditioner(
                           jnp.asarray(np.diag(A))), **kw)
    t = t_linalg.gmres(lambda x: torch.tensor(A) @ x, torch.tensor(b),
                       precond=t_linalg.jacobi_preconditioner(
                           torch.tensor(np.diag(A))), **kw)
    assert t.iterations == int(j.iterations)
    assert rel_diff(t.x, j.x) <= TOL
    assert float(t.residual_norm) == pytest.approx(float(j.residual_norm),
                                                   rel=1e-6, abs=1e-14)


def test_gmres_inside_fem_step_matches_jax(operator):
    """GMRES on the masked CRBE system of the shared operator, against the
    JAX GMRES and the port's BiCGStab."""
    jops, tops, b = operator
    jmv, tmv, _, _ = _pieces(jops, tops)
    kw = dict(tol=1e-11, restart=30, maxiter=30)
    j = j_linalg.gmres(jmv, jnp.asarray(b), precond=j_linalg.
                       jacobi_preconditioner(jops.system_diag), **kw)
    t = t_linalg.gmres(tmv, torch.tensor(b), precond=t_linalg.
                       jacobi_preconditioner(tops.system_diag), **kw)
    assert rel_diff(t.x, j.x) <= TOL
    ref = t_linalg.bicgstab(tmv, torch.tensor(b), tol=1e-12,
                            precond=t_linalg.jacobi_preconditioner(
                                tops.system_diag))
    assert rel_diff(t.x, ref.x.numpy()) <= 1e-8
