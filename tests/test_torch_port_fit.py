"""The port's Adam fits and Gauss-Newton posterior
(airpollution_tpu_torch/diagnostics/inverse.py) against the JAX package's:
five steps of fit_source and fit_diffusion against optax's Adam, and
posterior_covariance, on the scan engine, in float64 from the same
numpy-seeded observations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.problems import (  # noqa: E402
    GaussianSourceProblem as JSource,
    Problem as JProblem,
)

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import inverse as tinv  # noqa: E402

from torch_port_helpers import mesh_pair, rel_diff  # noqa: E402


def _observations(jmd, sens, idx):
    truth = jinv.solve_snapshots(
        JSource(q=2.0, xs=-1.0, ys=1.5, sigma_s=3.0), jmd, indices=idx,
        engine="scan", tol=1e-12, maxiter=500)
    obs = np.asarray(truth)[:, sens]
    rng = np.random.default_rng(0)
    return obs + 0.01 * np.abs(obs).max() * rng.standard_normal(obs.shape)


@pytest.mark.parametrize("fit_transport", [False, True])
def test_fit_source_adam_steps_match_optax(fit_transport):
    """Adam steps of fit_source (sensors and snapshots, scan engine; with
    fit_transport also D and v): the port's parameters and losses equal
    JAX's (optax.adam)."""
    jmd, tmd = mesh_pair(9, nt=9)
    idx = [3, 6, 8]
    sens = list(range(0, jmd.number_of_segments, 7))
    obs = _observations(jmd, sens, idx)
    steps = 3 if fit_transport else 5
    kw = dict(snapshot_indices=idx, sensor_indices=sens, sigma_s=3.0,
              q0=0.5, xy0=(0.0, 0.0), steps=steps, lr=0.1, engine="scan",
              tol=1e-12, maxiter=500, fit_transport=fit_transport)
    jres, jlosses = jinv.fit_source(jnp.asarray(obs), jmd, **kw)
    tres, tlosses = tinv.fit_source(obs, tmd, **kw)
    assert len(tlosses) == steps
    assert all(isinstance(v, float) for v in tlosses)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-7)
    keys = ("q", "xs", "ys") + (("D",) if fit_transport else ())
    for key in keys:
        assert abs(tres[key] - jres[key]) <= 1e-7 * abs(jres[key]), key
    if fit_transport:
        np.testing.assert_allclose(tres["v"], jres["v"], rtol=1e-7)


def test_fit_diffusion_adam_steps_match_optax():
    jmd, tmd = mesh_pair(9, nt=9)
    final = jinv.solve_final_state(JProblem(D=0.3), jmd, engine="scan",
                                   tol=1e-12, maxiter=500)
    kw = dict(D0=0.1, steps=5, lr=0.1, engine="scan", tol=1e-12,
              maxiter=500)
    jD, jlosses = jinv.fit_diffusion(final, jmd, **kw)
    tD, tlosses = tinv.fit_diffusion(np.asarray(final), tmd, **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-7)
    assert abs(tD - jD) <= 1e-7 * jD


def test_posterior_covariance_matches_jax():
    """cov, std, corr, labels and the residual obs_std at 17^2 (scan)."""
    jmd, tmd = mesh_pair(17, nt=9)
    idx = [3, 8]
    sens = list(range(0, jmd.number_of_segments, 11))
    params = {"log_q": np.asarray(0.6), "xy": np.asarray([-1.2, 1.4])}

    def make(lib):
        cls = JSource if lib == "jax" else tapt.GaussianSourceProblem
        exp = jnp.exp if lib == "jax" else torch.exp

        def make_problem(p):
            return cls(q=exp(p["log_q"]), xs=p["xy"][0], ys=p["xy"][1],
                       sigma_s=3.0)
        return make_problem

    obs = _observations(jmd, sens, idx)
    kw = dict(snapshot_indices=idx, sensor_indices=sens, observed=obs,
              tol=1e-12, maxiter=500)
    juq = jinv.posterior_covariance(
        jmd, make("jax"), {k: jnp.asarray(v) for k, v in params.items()},
        **kw)
    tuq = tinv.posterior_covariance(tmd, make("torch"), params, **kw)
    assert tuq["labels"] == juq["labels"] == ["log_q", "xy[0]", "xy[1]"]
    assert abs(tuq["obs_std"] - juq["obs_std"]) <= 1e-8 * juq["obs_std"]
    for key in ("cov", "corr"):
        assert rel_diff(tuq[key], juq[key]) <= 1e-8, key
    for lab, s in juq["std"].items():
        assert abs(tuq["std"][lab] - s) <= 1e-8 * s, lab
    with pytest.raises(ValueError, match="obs_std"):
        tinv.posterior_covariance(tmd, make("torch"), params,
                                  snapshot_indices=idx)
