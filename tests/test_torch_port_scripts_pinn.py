"""The port's PINN scripts against the JAX package's, on the CPU in
float64 at a small size: scripts/torch_port_pinn_rotating_demo.py,
torch_port_pinn_accuracy_levers.py and torch_port_canyon_pinn_fem.py
beside pinn_rotating_demo.py, pinn_accuracy_levers.py and
canyon_pinn_fem.py. The JAX and torch generators draw different points
and weights, so both packages' samplers are patched to return the same
seeded points (per count; the facades' from the walls' counts) and every
model starts from the same numpy parameters, in float64 (the scripts
build float32 models); the JAX trainer is traced anew. Losses, errors
and every other figure within 1e-12 (relative, the PINN training
tests' tolerance); the FEM field of the canyon within 1e-9."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu.models import pinn as jpinn  # noqa: E402

from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_pinn_helpers import same_points, same_weights  # noqa: E402
from torch_port_script_helpers import (  # noqa: E402
    f64_meshes, load_script, read_rows, run_jax_main)

PINN_TOL = 1e-12


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def test_pinn_rotating_demo_matches_jax(monkeypatch, tmp_path):
    """Three epochs at 5^2 of a 8 x 2 network with 4 Fourier features and
    causal weighting: each epoch's losses and the errors at t = T."""
    jscript = load_script("pinn_rotating_demo.py")
    tscript = load_script("torch_port_pinn_rotating_demo.py")
    f64_meshes(monkeypatch, jscript)
    same_points(monkeypatch)
    jm = same_weights(monkeypatch, jscript, jpinn.PINN, "jax")
    same_weights(monkeypatch, tscript, tscript.PINN, "torch")
    argv = ["--mesh_size", "5", "--epochs", "3", "--width", "8", "--depth",
            "2", "--fourier", "4"]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    row = tscript.run(5, 3, 2e-3, 8, 2, 4, device="cpu",
                      dtype=torch.float64)
    (model,) = jm
    for k in ("total_loss", "pde_loss", "ic_loss", "bc_loss"):
        np.testing.assert_allclose(row["history"][k], model.history[k],
                                   rtol=PINN_TOL)
    want = read_rows(tmp_path / "jax.csv")[0]
    assert float(want["rel_l2"]) == pytest.approx(row["rel_l2"], abs=5e-7)
    assert int(want["n_col"]) == row["n_col"]
    jmd = jscript.apt.MeshData(jscript.apt.create_mesh(5, 20.0),
                               jscript.apt.Domain(), nt=128)
    rl, l2, mx = model.compute_errors(jmd, jscript.RotatingPlumeProblem()
                                      .analytical_solution)
    assert rel(row["rel_l2"], float(rl)) <= PINN_TOL
    assert rel(row["max_error"], float(mx)) <= PINN_TOL


LEVERS = ["base", "adaptive", "fourier+causal+hardic", "hpo-tuned",
          "base-flat-lambdas"]


def test_pinn_accuracy_levers_match_jax(monkeypatch, tmp_path):
    """Five variants (plain, grad-norm weights, Fourier + causal + hard
    IC, the tuned wide net, flat weights) for 3 epochs at 5^2: each row's
    final loss and errors; the merged CSV's columns."""
    jscript = load_script("pinn_accuracy_levers.py")
    tscript = load_script("torch_port_pinn_accuracy_levers.py")
    f64_meshes(monkeypatch, jscript)
    same_points(monkeypatch)
    same_weights(monkeypatch, jscript, jpinn.PINN, "jax")
    same_weights(monkeypatch, tscript, tscript.PINN, "torch")
    assert list(tscript.VARIANTS) == list(_jax_variants(jscript))
    argv = ["--epochs", "3", "--mesh_size", "5", "--variants", *LEVERS]
    want = jscript.main([*argv, "--out", str(tmp_path / "jax.csv")])
    got = tscript.run(3, 5, LEVERS, device="cpu", dtype=torch.float64)
    tscript.write_merged(str(tmp_path / "port.csv"), got)
    assert [r["variant"] for r in got] == [r["variant"] for r in want]
    for g, w in zip(got, want):
        assert g["epochs"] == w["epochs"] == 3
        for k in ("final_loss", "rel_l2", "l2", "max_error"):
            assert rel(g[k], float(w[k])) <= PINN_TOL, (g["variant"], k)
    assert list(read_rows(tmp_path / "port.csv")[0]) == \
        list(read_rows(tmp_path / "jax.csv")[0])


def _jax_variants(jscript):
    """The JAX script's variant names, read from its source."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(jscript.main))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "variants":
            return [k.value for k in node.value.keys]
    raise AssertionError("no variants table")


def test_canyon_pinn_fem_matches_jax(monkeypatch, tmp_path):
    """The FEM at 9^2, nt=9 (within 1e-9), then the base, the facade-weight
    and the output-scale configurations for 3 Adam epochs with 4 Fourier
    features: every figure of each row. (The JAX L-BFGS polish compiles
    for minutes on the CPU: both packages' polish is held in
    tests/test_torch_port_pinn_lbfgs.py; here it runs 0 steps.)"""
    jscript = load_script("canyon_pinn_fem.py")
    tscript = load_script("torch_port_canyon_pinn_fem.py")
    f64_meshes(monkeypatch, jscript)
    same_points(monkeypatch)
    same_weights(monkeypatch, jscript, jpinn.PINN, "jax")
    same_weights(monkeypatch, tscript, tscript.PINN, "torch")
    monkeypatch.setattr(jscript, "log", lambda *a: None)
    monkeypatch.setattr(tscript, "log", lambda *a: None)
    assert tscript.CONFIGS == jscript.CONFIGS
    configs = ("base", "facade20", "scale")
    argv = ["--mesh_size", "9", "--nt", "9", "--epochs", "3", "--lbfgs",
            "0", "--fourier", "4", "--configs", *configs]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.json")])
    res = tscript.run(9, 9, 3.0, 3, 2e-3, 4, 1.0, 0, configs, device="cpu",
                      dtype=torch.float64)
    tscript.write(str(tmp_path / "port.json"), res)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    with open(tmp_path / "port.json") as f:
        got = json.load(f)
    assert got["problem"] == want["problem"]
    fem_keys = ("fem_wake_mean", "fem_free_mean", "fem_wake_deficit")
    assert len(got["configs"]) == len(want["configs"]) == 3
    for g, w in zip(got["configs"], want["configs"]):
        assert set(g) == set(w)
        for k, v in w.items():
            if k == "train_s":
                continue
            if isinstance(v, float):
                tol = 1e-9 if k in fem_keys else PINN_TOL
                digits = tscript.ROUNDING.get(k)
                if digits is not None:
                    # Rounded in both documents: equal unless a rounding
                    # boundary falls between the two.
                    assert abs(g[k] - v) <= 10.0 ** -digits, k
                else:
                    assert rel(g[k], v) <= tol, (w["config"], k)
            else:
                assert g[k] == v, k
