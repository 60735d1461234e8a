"""The port's reporting layer and search engine against the JAX
package's: the LaTeX tables byte for byte on results_snapshot/'s CSVs,
the CSV frames against pandas, the TPE study's suggestions, and every
plot function's file names."""

import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402,F401  (the JAX package needs x64)

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.hpo import search as jsearch  # noqa: E402
from airpollution_tpu.reporting import plots as jplots  # noqa: E402
from airpollution_tpu.reporting import table_generator as jtables  # noqa: E402
import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import analysis  # noqa: E402
from airpollution_tpu_torch.hpo import search  # noqa: E402
from airpollution_tpu_torch.reporting import (  # noqa: E402
    data_visualization, frames, plots, table_generator)

SNAPSHOT = Path(__file__).resolve().parents[1] / "results_snapshot"
CSVS = {
    "crbe": "df_crbe_training_results.csv",
    "pinn": "df_pinn_training_results.csv",
    "sensibility": "df_sensitivity_data.csv",
    "fixed_runtime": "fixed_runtime_comparison.csv",
}


def both_frames(name):
    path = SNAPSHOT / CSVS[name]
    return pd.read_csv(path), frames.read_csv(path)


def jax_memory(df_crbe, df_pinn):
    """The memory frame as the JAX package's ``main`` builds it."""
    return pd.DataFrame({
        "cr_memory_mb": list(df_crbe["cpu_memory_usage_MB"].values),
        "pinn_memory_mb": list(df_pinn["gpu_memory_usage_MB"].values),
    })


@pytest.mark.parametrize("optional", ["all", "no_sensitivity",
                                      "no_fixed_runtime", "none"])
def test_latex_tables_equal_jax_bytewise(optional):
    """On the snapshot's CSVs the port's tables are the JAX package's text
    (compared with the JAX function: results_snapshot's .tex is older
    than it), with each optional input present or skipped."""
    (jc, tc), (jp, tp) = both_frames("crbe"), both_frames("pinn")
    js, ts = both_frames("sensibility")
    jf, tf = both_frames("fixed_runtime")
    if optional in ("no_sensitivity", "none"):
        js = ts = None
    if optional in ("no_fixed_runtime", "none"):
        jf = tf = None
    want = jtables.generate_latex_tables(
        jc, jp, memory_data=jax_memory(jc, jp), sensitivity_data=js,
        df_fixed_runtime=jf)
    got = table_generator.generate_latex_tables(
        tc, tp, memory_data=table_generator.memory_frame(tc, tp),
        sensitivity_data=ts, df_fixed_runtime=tf)
    assert list(got) == list(want)
    assert len(got) == 6 + (js is not None) + (jf is not None)
    for name in want:
        assert got[name] == want[name], name


def _results_tree(root):
    for sub, name in CSVS.items():
        (root / "experimental_results" / sub).mkdir(parents=True)
        shutil.copy(SNAPSHOT / name, root / "experimental_results" / sub)


def test_table_main_writes_the_jax_file(tmp_path, monkeypatch):
    """Both ``main``s over the same experimental_results/ tree write the
    same convergence_tables.tex; without the CRBE CSV both stop."""
    for pkg in ("jax", "port"):
        (tmp_path / pkg).mkdir()
        _results_tree(tmp_path / pkg)
    monkeypatch.chdir(tmp_path / "jax")
    jtables.main([])
    monkeypatch.chdir(tmp_path / "port")
    tables = table_generator.main([])
    assert len(tables) == 8
    tex = "experimental_results/tables/convergence_tables.tex"
    assert (tmp_path / "port" / tex).read_bytes() == \
        (tmp_path / "jax" / tex).read_bytes()
    (tmp_path / "port" / "experimental_results" / "crbe" / CSVS["crbe"]
     ).unlink()
    with pytest.raises(SystemExit, match="Missing CRBE/PINN"):
        table_generator.main([])


def test_format_sci_and_rates_equal_jax():
    cases = [0, 5e-5, 0.496, 57.1, 123.4, 1234.5, 12345.0, -3.2e-7,
             -0.75, 1e-4, 9999.99, 1e4, 2.0, np.float64(86.48316192626953)]
    for x in cases:
        assert table_generator.format_sci(x) == jtables.format_sci(x), x
    assert table_generator.format_sci(5e-5) == "$5\\cdot 10^{-5}$"
    jc, tc = both_frames("crbe")
    assert np.allclose(table_generator.convergence_rates(tc),
                       jtables.convergence_rates(jc), rtol=0, atol=1e-15)


def test_frames_read_and_write_as_pandas(tmp_path):
    """read_csv types each column as pandas does; write_csv writes rows as
    ``DataFrame.to_csv`` (index column or not)."""
    for name in CSVS:
        path = SNAPSHOT / CSVS[name]
        # float() rounds correctly, as pandas' round-trip parser does.
        want = pd.read_csv(path, float_precision="round_trip")
        got = frames.read_csv(path)
        assert list(got) == list(want.columns)
        for col in want.columns:
            w, g = want[col].to_numpy(), got[col]
            assert g.dtype.kind == w.dtype.kind, (name, col)
            if w.dtype.kind == "f":
                assert np.array_equal(g, w, equal_nan=True), (name, col)
            else:
                assert [str(v) for v in g] == [str(v) for v in w], (name,
                                                                    col)
    rows = [{"method": "PINN", "a": 1, "x": 0.1, "h": [0.5, 0.25]},
            {"method": "CRBE", "a": 2, "x": float("nan"), "h": None,
             "late": 3.0}]
    for index in (True, False):
        frames.write_csv(tmp_path / "got.csv", rows, index=index)
        pd.DataFrame(rows).to_csv(tmp_path / "want.csv", index=index)
        assert (tmp_path / "got.csv").read_text() == \
            (tmp_path / "want.csv").read_text()


def test_group_mean_equals_pandas_groupby():
    jf, tf = both_frames("fixed_runtime")
    cols = ["rel_l2_error", "actual_runtime", "epochs_completed"]
    got = frames.group_mean(tf, ["method", "time_budget"],
                            [(c, s) for c in cols for s in ("mean", "std")])
    want = jf.groupby(["method", "time_budget"]).agg(
        {c: ["mean", "std"] for c in cols}).reset_index()
    assert list(got["method"]) == list(want["method"])
    assert list(got["time_budget"]) == list(want["time_budget"])
    for c in cols:
        for s in ("mean", "std"):
            assert np.allclose(got[f"{c}_{s}"], want[(c, s)], rtol=1e-12,
                               atol=0, equal_nan=True)


def _objective(trial):
    x = trial.suggest_float("x", 1e-3, 1e3, log=True)
    y = trial.suggest_float("y", -2.0, 2.0)
    k = trial.suggest_int("k", 1, 6)
    c = trial.suggest_categorical("c", ["a", "b", "c"])
    trial.set_user_attr("k2", k * k)
    return (np.log10(x) - 1.0) ** 2 + y * y + 0.1 * k + (c != "b")


def test_serial_study_suggests_what_jax_does():
    """A seeded serial study (10 random trials, then the TPE) proposes the
    JAX engine's values, trial by trial, and keeps its table's columns."""
    want = jsearch.create_study(seed=7)
    got = search.create_study(seed=7)
    want.optimize(_objective, n_trials=16)
    got.optimize(_objective, n_trials=16)
    for w, g in zip(want.trials, got.trials):
        assert (g.number, g.params, g.value, g.state) == \
            (w.number, w.params, w.value, w.state)
    assert got.best_trial.params == want.best_trial.params
    rows = got.trials_dataframe()
    assert list(rows[0]) == list(want.trials_dataframe().columns)


def test_parallel_study_and_failed_trials(tmp_path):
    """Four threads run every trial once; a trial that raises scores inf
    (state FAIL) and is never the best; the table writes as pandas'."""
    study = search.create_study(seed=2)

    def objective(trial):
        x = trial.suggest_float("lr", 1e-4, 1e-1, log=True)
        trial.set_user_attr("train_time", 0.1)
        if trial.number % 3 == 0:
            raise RuntimeError("boom")
        return x

    study.optimize(objective, n_trials=12, n_jobs=4)
    numbers = sorted(t.number for t in study.trials)
    assert numbers == list(range(12))
    failed = [t for t in study.trials if t.state == "FAIL"]
    assert len(failed) == 4 and all(t.value == np.inf for t in failed)
    assert np.isfinite(study.best_trial.value)
    rows = study.trials_dataframe()
    frames.write_csv(tmp_path / "got.csv", rows, index=False)
    pd.DataFrame(rows).to_csv(tmp_path / "want.csv", index=False)
    assert (tmp_path / "got.csv").read_text() == \
        (tmp_path / "want.csv").read_text()


def test_vertex_average_equals_jax():
    md = tapt.MeshData(tapt.create_mesh(6, 20.0), tapt.Domain(), nt=3,
                       dtype=torch.float64, device="cpu")
    vals = np.random.default_rng(0).standard_normal(md.number_of_segments)
    got = plots.vertex_average(md.points, md.segments, torch.tensor(vals))
    want = jplots.vertex_average(md.points.numpy(), md.segments.numpy(),
                                 vals)
    assert np.array_equal(got, want)


@pytest.fixture
def low_dpi(monkeypatch):
    """Every figure still drawn and saved, at a low resolution: the test
    is of names, not of pixels."""
    pytest.importorskip("matplotlib")
    from matplotlib.figure import Figure

    save = Figure.savefig
    monkeypatch.setattr(Figure, "savefig",
                        lambda self, fname, **kw: save(
                            self, fname, **{**kw, "dpi": 20}))


def test_plot_functions_write_the_jax_file_names(tmp_path, monkeypatch,
                                                 low_dpi):
    """Every plot function of the port at ms=4: the solver, PINN, mesh,
    ensemble and footprint figures, the analysis figures and the five
    publication figures, under the JAX package's file names."""
    monkeypatch.chdir(tmp_path)
    dom, prob = tapt.Domain(), tapt.Problem(sigma=1.0)
    md = tapt.MeshData(tapt.create_mesh(4, 20.0), dom, nt=5,
                       dtype=torch.float64, device="cpu")
    s = tapt.CRBESolver(dom, prob, md, device="cpu")
    s.solve()
    out = tmp_path / "out"
    s.plot_solution(prob.analytical_solution, save_dir=str(out))
    s.plot_solution(time_index=2, save_dir=str(out))
    s.plot_interpolated_solution(prob.analytical_solution, save_dir=str(out),
                                 name="c")
    s.plot_error_evolution({"l2_errors": np.linspace(1, 2, 5),
                            "linf_errors": np.linspace(2, 3, 5)},
                           save_dir=str(out))
    m = tapt.PINN([3, 4, 1], prob, dom, device="cpu")
    m.history = {k: [1.0, 0.5] for k in ("total_loss", "pde_loss",
                                         "ic_loss", "bc_loss")}
    m.plot_history(save_dir=str(out), name="p")
    m.plot_solution(10.0, md, prob.analytical_solution, save_dir=str(out))
    m.plot_interpolated_solution(10.0, md, save_dir=str(out), name="p")
    md.show(str(out / "mesh.pdf"))
    n = md.number_of_segments
    exc = np.linspace(0.0, 1.0, 2 * n).reshape(2, n)
    assert plots.plot_exceedance_maps(md, exc, (0.1, 0.2),
                                      save_dir=str(out)) == \
        f"{out}/exceedance.png"
    assert plots.plot_footprint(md, torch.linspace(0, 1, n), 3,
                                save_dir=str(out)) == f"{out}/footprint.png"
    a = analysis.ComprehensiveAnalysis(prob, dom, md, s, m)
    a.run_all_analyses()
    a.plot_all_results(str(tmp_path / "analysis"))
    _results_tree(tmp_path)
    data_visualization.main([])
    assert {p.name for p in out.iterdir()} == {
        "solution_t4.png", "solution_t2.png",
        "solution_t4_interpolated_c.png", "solution_t4_interpolated_c.pdf",
        "error_evolution.png", "loss_history_p.pdf", "loss_history_p.png",
        "solution_10.0.pdf", "solution_10.0.png",
        "solution_10.0_interpolated_solution_p.pdf",
        "solution_10.0_interpolated_solution_p.png", "mesh.pdf",
        "exceedance.png", "footprint.png"}
    assert {p.name for p in (tmp_path / "analysis").iterdir()} == {
        f"{name}.{ext}" for ext in ("png", "pdf") for name in (
            "mass_conservation", "center_of_mass", "spreading_rate",
            "peak_concentration", "concentration_profiles")}
    assert {p.name for p in (tmp_path / "experimental_results" / "figures"
                             ).iterdir()} == {
        "convergence_analysis.pdf", "computational_efficiency.pdf",
        "sensitivity_analysis.pdf", "memory_comparison_cpu_gpu.pdf",
        "runtime_budget_analysis.pdf"}
    with pytest.raises(ValueError, match="not a stored snapshot"):
        jplots._solution_row(SimpleSolver(s, 2), 3)
    with pytest.raises(ValueError, match="not a stored snapshot"):
        plots._solution_row(SimpleSolver(s, 2), 3)


class SimpleSolver:
    """A strided stand-in: every ``stride``-th row of a solver's states."""

    def __init__(self, solver, stride):
        self.mesh_data = solver.mesh_data
        self.solutions = solver.solutions[::stride]
        self.snapshot_every = stride
        self.dt = solver.dt


def test_figures_skip_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib a figure is the one thing skipped: one printed
    line names each, nothing is written, nothing raises."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    _results_tree(tmp_path)
    data_visualization.main([])
    md = tapt.MeshData(tapt.create_mesh(4, 20.0), tapt.Domain(), nt=3,
                       device="cpu")
    md.show(str(tmp_path / "mesh.pdf"))
    assert plots.plot_footprint(md, torch.zeros(md.number_of_segments), 0,
                                save_dir=str(tmp_path)) is None
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("skipped figure")]
    assert len(lines) == 7
    assert all(ln.endswith("matplotlib is not installed") for ln in lines)
    assert not (tmp_path / "mesh.pdf").exists()
    assert not any((tmp_path / "experimental_results" / "figures"
                    ).iterdir())
