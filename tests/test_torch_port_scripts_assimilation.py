"""The port's assimilation scripts against the JAX package's, on the CPU
in float64 at a small size: scripts/torch_port_assimilation_demo.py,
torch_port_da_cycling_demo.py and torch_port_network_design_demo.py
beside scripts/assimilation_demo.py, da_cycling_demo.py and
network_design_demo.py. Both packages' ``enkf_update`` are patched to
draw their observation noise from one numpy sequence (the JAX key and
the torch generator draw different noise), so each analysis is compared
on identical noise: every analysis ensemble within 1e-9 of max|JAX|, and
every CSV cell equal (the scripts round to the same places; the
platform column aside)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from airpollution_tpu.diagnostics import ensemble as jens  # noqa: E402

from airpollution_tpu_torch.diagnostics import ensemble as tens  # noqa: E402

from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_script_helpers import (  # noqa: E402
    TOL, assert_same_cells, f64_meshes, load_script, run_jax_main)


def identical_noise(monkeypatch, jscript, tscript):
    """Patch ``enkf_update`` in both script modules to perturb the
    observations with the same numpy draws; returns the (JAX, port)
    lists of analysis ensembles, in call order."""
    draws = {"jax": np.random.default_rng(99),
             "torch": np.random.default_rng(99)}
    seen = {"jax": [], "torch": []}

    def jax_update(members, y, sensors, obs_std, key, inflation=1.0):
        X = jnp.asarray(members)
        s = np.asarray([int(i) for i in sensors])
        eps = obs_std * draws["jax"].standard_normal((X.shape[0], s.size))
        Xa = jens._enkf_update(X, jnp.asarray(y, X.dtype), jnp.asarray(s),
                               jnp.asarray(obs_std, X.dtype),
                               jnp.asarray(eps), jnp.asarray(inflation,
                                                             X.dtype))
        seen["jax"].append(np.asarray(Xa))
        return Xa

    def torch_update(members, y, sensors, obs_std, generator,
                     inflation=1.0):
        X = torch.as_tensor(members)
        s = torch.as_tensor([int(i) for i in sensors])
        eps = obs_std * draws["torch"].standard_normal((X.shape[0],
                                                        s.numel()))
        Xa = tens._enkf_update(X, torch.as_tensor(y, dtype=X.dtype), s,
                               obs_std, torch.as_tensor(eps), inflation)
        seen["torch"].append(Xa.numpy())
        return Xa

    monkeypatch.setattr(jscript, "enkf_update", jax_update)
    monkeypatch.setattr(tscript, "enkf_update", torch_update)
    return seen


def assert_same_analyses(seen):
    assert len(seen["torch"]) == len(seen["jax"]) > 0
    for got, want in zip(seen["torch"], seen["jax"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_assimilation_demo_matches_jax(monkeypatch, tmp_path):
    jscript = load_script("assimilation_demo.py")
    tscript = load_script("torch_port_assimilation_demo.py")
    seen = identical_noise(monkeypatch, jscript, tscript)
    argv = ["--members", "8", "--mesh_size", "12", "--nt", "9",
            "--stations", "12"]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    res = tscript.main([*argv, "--device", "cpu", "--out",
                        str(tmp_path / "port.csv")])
    assert_same_cells(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert_same_analyses(seen)
    assert res["rel_err_analysis_mean"] < res["rel_err_forecast_mean"]


def test_da_cycling_demo_matches_jax(monkeypatch, tmp_path):
    """Two windows restarted from the analysed and the free states
    (``u0_members=``, ``t0=``), float64 in both packages."""
    jscript = load_script("da_cycling_demo.py")
    tscript = load_script("torch_port_da_cycling_demo.py")
    f64_meshes(monkeypatch, jscript)
    seen = identical_noise(monkeypatch, jscript, tscript)
    argv = ["--mesh_size", "12", "--members", "8", "--cycles", "2",
            "--window_nt", "5", "--sensors", "10"]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    res = tscript.run(12, 8, 2, 1.0, 5, 10, 0.02, 1.1, device="cpu",
                      dtype=torch.float64)
    tscript.write_csv(tmp_path / "port.csv", res, 12, 8, 10, 0.02)
    assert_same_cells(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert_same_analyses(seen)
    assert res["platform"] == "cpu"


def test_network_design_demo_matches_jax(monkeypatch, tmp_path):
    """The greedy network (stations equal) and two random ones per size,
    float64 in both packages."""
    jscript = load_script("network_design_demo.py")
    tscript = load_script("torch_port_network_design_demo.py")
    f64_meshes(monkeypatch, jscript)
    seen = identical_noise(monkeypatch, jscript, tscript)
    picked = {}
    real = jscript.place_sensors

    def spy(*a, **k):
        picked["jax"] = real(*a, **k)
        return picked["jax"]

    monkeypatch.setattr(jscript, "place_sensors", spy)
    argv = ["--mesh_size", "12", "--nt", "9", "--members", "8", "--sizes",
            "2", "4", "--random_trials", "2"]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    res = tscript.run(12, 9, 8, (2, 4), 2, 0.002, device="cpu",
                      dtype=torch.float64)
    tscript.write_csv(tmp_path / "port.csv", res, 12, 8, 0.002)
    assert_same_cells(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert_same_analyses(seen)
    assert res["stations"] == list(picked["jax"][0])
