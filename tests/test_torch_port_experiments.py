"""The port's experiment drivers (airpollution_tpu_torch.experiments)
against the JAX package's (experiments/): the CRBE sweep's errors to
1e-10 in f64 on both mesh kinds; for the PINN, sensitivity,
fixed-runtime and search drivers, whose random streams differ from
JAX's, the CSV schema and the schedules; the pipeline's stages."""

import ast
import csv
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402,F401

from airpollution_tpu.models.crbe import CRBESolver as JCRBESolver  # noqa: E402
from experiments import common as jcommon  # noqa: E402
from experiments import crbe_experiments as jcrbe  # noqa: E402
from experiments import fixed_runtime_experiments as jfixed  # noqa: E402
from experiments import sensitivity_analysis as jsens  # noqa: E402
from airpollution_tpu_torch.experiments import __main__ as pipeline  # noqa: E402
from airpollution_tpu_torch.experiments import (  # noqa: E402
    common, crbe_experiments, fixed_runtime_experiments,
    optimal_hyperparams_search, pinn_experiments, sensitivity_analysis)
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.models.pinn import PINN  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SNAPSHOT = REPO / "results_snapshot"


def header(path):
    with open(path, newline="") as f:
        return next(csv.reader(f))


def table(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture
def no_solution_plots(monkeypatch):
    """The drivers' per-mesh figures are held by
    tests/test_torch_port_reporting.py; here they would only take time."""
    for cls in (JCRBESolver, CRBESolver):
        monkeypatch.setattr(cls, "plot_interpolated_solution",
                            lambda *a, **k: None)
    monkeypatch.setattr(PINN, "plot_interpolated_solution",
                        lambda *a, **k: None)
    monkeypatch.setattr(PINN, "plot_history", lambda *a, **k: None)


@pytest.mark.parametrize("kind,suffix", [("structured", ""),
                                         ("unstructured", "_unstructured")])
def test_crbe_driver_matches_jax(tmp_path, monkeypatch, no_solution_plots,
                                 kind, suffix):
    """Both drivers at ms=4 and 8, f64: the same CSV name and columns
    (those of results_snapshot/'s table), the same mesh columns, and
    rel_l2, l2 and max errors within 1e-10."""
    argv = ["--mesh_sizes", "4", "8", "--dtype", "float64", "--mesh_kind",
            kind]
    name = f"experimental_results/crbe/df_crbe_training_results{suffix}.csv"
    for pkg, main in (("jax", jcrbe.main), ("port", crbe_experiments.main)):
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        if pkg == "port":
            rows = main(argv, device="cpu")
        else:
            main(argv)
    want, got = table(tmp_path / "jax" / name), table(tmp_path / "port" / name)
    assert header(tmp_path / "port" / name) == header(
        tmp_path / "jax" / name) == header(
        SNAPSHOT / f"df_crbe_training_results{suffix}.csv")
    assert [r["mesh_size"] for r in rows] == [4, 8]
    for w, g in zip(want, got, strict=True):
        for col in ("", "mesh_size", "n_dofs", "n_boundary_dofs",
                    "number_of_collocation_points"):
            assert g[col] == w[col], col
        for col in ("rel_l2_error", "l2_error", "max_error"):
            assert abs(float(g[col]) - float(w[col])) <= 1e-10 * max(
                1.0, abs(float(w[col]))), col
        assert float(g["steps_per_sec"]) > 0


def test_pinn_schedule_is_the_reference_drivers():
    """Per mesh: the layers, epochs, patience and lr of the JAX driver's
    loop (from experiments/common.py), the collocation budget of each
    mesh, and each override."""
    args = pinn_experiments.parse(["--width", "3"])
    for i, ms in enumerate(jcommon.MESH_SIZES):
        layers, epochs, patience, lr = pinn_experiments.schedule(args, i)
        assert layers == [3] + [jcommon.N_NEURONS[i]] * 3 + [1]
        assert (epochs, patience, lr) == (
            jcommon.EPOCHS_LIST[i], jcommon.EARLY_STOPPING_PATIENCE_LIST[i],
            jcommon.LR_LIST[i])
    args = pinn_experiments.parse(["--neurons", "7", "--epochs", "9",
                                   "--patience", "5", "--lr", "0.01"])
    assert pinn_experiments.schedule(args, 5) == ([3, 7, 7, 7, 7, 1], 9, 5,
                                                  0.01)
    for n_dofs in (33, 161, 705, 2945, 12033, 48641):
        assert common.collocation_budget(n_dofs) == \
            jcommon.collocation_budget(n_dofs)
    with pytest.raises(SystemExit):
        pinn_experiments.parse(["--mesh_sizes", "5"])
    assert [common.str2bool(v) for v in ("True", "false", "1", "no")] == \
        [jcommon.str2bool(v) for v in ("True", "false", "1", "no")]


def test_pinn_driver_retries_diverged_seeds(tmp_path, monkeypatch,
                                            no_solution_plots):
    """--seed_retries 2 with a threshold nothing meets: both seeds run,
    both count as diverged, and the row keeps the better one."""
    monkeypatch.chdir(tmp_path)
    rows = pinn_experiments.main(
        ["--mesh_sizes", "4", "--epochs", "2", "--seed_retries", "2",
         "--diverged_threshold", "0"], device="cpu")
    assert rows[0]["diverged_seeds"] == 2
    assert rows[0]["seed"] in (common.SEED, common.SEED + 1)


def test_sensitivity_driver_schema(tmp_path, monkeypatch):
    """One row per D of the JAX driver's list, the columns of
    results_snapshot/df_sensitivity_data.csv, finite errors (the mesh cut
    to ms=4 here; the driver's is JAX's index 4, ms=64)."""
    assert sensitivity_analysis.D_LIST == jsens.D_LIST
    assert sensitivity_analysis.IDX_MESH_SIZE == jsens.IDX_MESH_SIZE
    monkeypatch.setattr(sensitivity_analysis, "IDX_MESH_SIZE", 0)
    monkeypatch.chdir(tmp_path)
    rows = sensitivity_analysis.main(["--epochs", "2"], device="cpu")
    path = "experimental_results/sensibility/df_sensitivity_data.csv"
    assert header(tmp_path / path) == header(
        SNAPSHOT / "df_sensitivity_data.csv")
    assert [r["diffusion_coef"] for r in rows] == jsens.D_LIST
    for r in rows:
        assert r["mesh_size"] == 4
        assert all(np.isfinite(r[k]) for k in (
            "pinn_l2_error", "max_error", "cr_l2_error", "cr_max_error"))


def test_fixed_runtime_budget_stops_and_schema(tmp_path, monkeypatch):
    """A 1-s budget stops after whole chunks; the driver's CSVs have the
    columns of results_snapshot/fixed_runtime_comparison.csv and the
    flattened summary (JAX's meshes and widths; budgets cut here)."""
    assert fixed_runtime_experiments.FR_MESH_SIZES == jfixed.FR_MESH_SIZES
    assert fixed_runtime_experiments.BASE_NEURONS == jfixed.BASE_NEURONS
    import airpollution_tpu_torch as apt

    md = apt.MeshData(apt.create_mesh(4, 20.0), apt.Domain(), nt=128,
                      device="cpu")
    r = fixed_runtime_experiments.run_pinn_with_time_budget(
        apt.Domain(), apt.Problem(sigma=1.0), md, 1.0, 2, 3e-4, True, 25)
    assert r["epochs_completed"] > 0 and r["epochs_completed"] % 25 == 0
    assert len(r["convergence_history"]) == r["epochs_completed"]
    assert 1.0 <= r["actual_runtime"] < 30.0
    assert np.isfinite(r["rel_l2_error"])

    monkeypatch.setattr(fixed_runtime_experiments, "FR_MESH_SIZES", [4])
    monkeypatch.setattr(fixed_runtime_experiments, "TESTING_BUDGETS", [0.2])
    monkeypatch.chdir(tmp_path)
    rows = fixed_runtime_experiments.main(
        ["--run_for_testing", "True", "--epochs_per_chunk", "5"],
        device="cpu")
    assert [r["method"] for r in rows] == ["PINN", "CRBE"]
    out = tmp_path / "experimental_results" / "fixed_runtime"
    assert header(out / "fixed_runtime_comparison.csv") == header(
        SNAPSHOT / "fixed_runtime_comparison.csv")
    summary = table(out / "fixed_runtime_summary_stats.csv")
    assert list(summary[0]) == [
        "method", "time_budget", "rel_l2_error_mean", "rel_l2_error_std",
        "actual_runtime_mean", "actual_runtime_std",
        "epochs_completed_mean"]
    assert [s["method"] for s in summary] == ["CRBE", "PINN"]
    assert float(summary[0]["epochs_completed_mean"]) == 1.0


def test_search_driver_table_and_failed_trials(tmp_path, monkeypatch):
    """Two trials on two threads write the columns of
    results_snapshot/optuna_pinn_results_32.csv; a trial whose training
    raises scores inf and the study goes on (mesh cut to ms=8 here)."""
    monkeypatch.setattr(optimal_hyperparams_search, "MESH_SIZE", 8)
    monkeypatch.chdir(tmp_path)
    train = PINN.train

    def train_or_fail(self, *a, **k):
        if self.generator.initial_seed() == common.SEED + 1:
            raise FloatingPointError("injected")
        return train(self, *a, **k)

    monkeypatch.setattr(PINN, "train", train_or_fail)
    rows = optimal_hyperparams_search.main(
        ["--n_trials", "2", "--epochs", "2", "--n_jobs", "2", "--width",
         "4"], device="cpu")
    assert header(tmp_path / "optuna_pinn_results_4.csv") == header(
        SNAPSHOT / "optuna_pinn_results_32.csv")
    assert [r["number"] for r in rows] == [0, 1]
    assert np.isfinite(rows[0]["value"]) and rows[1]["value"] == np.inf
    assert [r["state"] for r in rows] == ["COMPLETE", "COMPLETE"]


def _jax_stages():
    """The (module, args) of run_experiments.py's ``run`` calls."""
    tree = ast.parse((REPO / "run_experiments.py").read_text())
    stages = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "run"):
            stages.append([ast.literal_eval(e) if not isinstance(
                e, ast.JoinedStr) else "".join(
                    str(v.value) if isinstance(v, ast.Constant) else "1"
                    for v in e.values) for e in node.args[1].elts])
    return stages


def test_pipeline_runs_the_reference_stages(monkeypatch, capsys):
    """The port's stages are run_experiments.py's, in order, on the
    port's modules; a failed stage makes the pipeline exit 1."""
    rename = {"experiments.": "airpollution_tpu_torch.experiments.",
              "airpollution_tpu.": "airpollution_tpu_torch."}
    want = []
    for module, *args in _jax_stages():
        for old, new in rename.items():
            if module.startswith(old):
                module = new + module[len(old):]
                break
        want.append([module, *args])
    assert [args for _, args in pipeline.STAGES] == want
    for module, *_ in want:
        assert importlib.util.find_spec(module) is not None, module
    assert pipeline.main([("ok", ["json.tool", "--help"])]) == 0
    assert pipeline.main([("ok", ["json.tool", "--help"]),
                          ("bad", ["json.tool", "/nonexistent.json"])]) == 1
    assert "FAILED stages: [('json.tool', 2)]" in capsys.readouterr().out
