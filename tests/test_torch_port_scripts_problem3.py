"""The port's last two problem-3 scripts against the JAX package's, on
the CPU in float64 at a small size:
scripts/torch_port_problem3_comparative_analysis.py beside
scripts/problem3_comparative_analysis.py (the CRBE solve and a PINN per
mesh size, on the same seeded points and starting parameters in both
packages: the discrepancy columns within 1e-9, the table's columns and
the rows of the frame that ``reporting/frames.py`` writes equal to what
pandas writes for the same rows), and
torch_port_problem3_comprehensive_analysis2.py, the triangle-quadrature
wrapper."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pd = pytest.importorskip("pandas")

from airpollution_tpu.models import pinn as jpinn  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import analysis  # noqa: E402
from airpollution_tpu_torch.reporting import frames  # noqa: E402

from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_pinn_helpers import same_points, same_weights  # noqa: E402
from torch_port_script_helpers import (  # noqa: E402
    TOL, f64_meshes, load_script, read_rows)

ERRORS = ("l2_error_diff", "max_error_diff")


def test_problem3_comparative_matches_jax(monkeypatch, tmp_path):
    """Mesh sizes 4 and 8, 3 PINN epochs: the same columns in the same
    order, m_size and the epochs run equal, the discrepancies within
    1e-9; the frame of the port's rows byte for byte pandas'."""
    monkeypatch.chdir(tmp_path)
    jscript = load_script("problem3_comparative_analysis.py")
    tscript = load_script("torch_port_problem3_comparative_analysis.py")
    f64_meshes(monkeypatch, jscript)
    monkeypatch.setattr(tscript.apt, "MeshData",
                        functools.partial(tapt.MeshData,
                                          dtype=torch.float64))
    same_points(monkeypatch)
    same_weights(monkeypatch, jscript, jpinn.PINN, "jax")
    same_weights(monkeypatch, tscript, tscript.PINN, "torch")
    argv = ["--mesh_sizes", "4", "8", "--epochs", "3"]
    jscript.main(argv)
    out = tmp_path / "problem3_analysis_results" / tscript.OUT_NAME
    want = read_rows(out)
    rows = tscript.main(argv, device="cpu")
    got = read_rows(out)
    assert list(got[0]) == list(want[0])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["m_size"] == w["m_size"]
        assert g["pinn_epochs_run"] == w["pinn_epochs_run"] == "3"
        for k in ERRORS:
            assert float(g[k]) == pytest.approx(float(w[k]), rel=TOL), k
    pandas_csv = tmp_path / "pandas.csv"
    pd.DataFrame(rows).to_csv(pandas_csv, index=False)
    assert out.read_text() == pandas_csv.read_text()
    frames.write_csv(str(tmp_path / "again.csv"), rows, index=False)
    assert (tmp_path / "again.csv").read_text() == out.read_text()


def test_problem3_comprehensive_analysis2_pins_the_triangle_quadrature(
        monkeypatch, tmp_path):
    """The wrapper adds ``--quadrature triangle`` unless given, and runs
    the port's diagnostics (ms=6, 2 PINN epochs) with it."""
    tscript = load_script("torch_port_problem3_comprehensive_analysis2.py")
    monkeypatch.chdir(tmp_path)
    for cls, names in ((tapt.CRBESolver, ["plot_interpolated_solution"]),
                       (tapt.PINN, ["plot_interpolated_solution"]),
                       (analysis.ComprehensiveAnalysis,
                        ["plot_all_results"])):
        for name in names:
            monkeypatch.setattr(cls, name, lambda *a, **k: None)
    seen = []
    real = analysis.ComprehensiveAnalysis.__init__

    def spy(self, *a, **k):
        seen.append(k.get("quadrature"))
        real(self, *a, **k)

    monkeypatch.setattr(analysis.ComprehensiveAnalysis, "__init__", spy)
    results, stats = tscript.main(["--epochs", "2", "--m_size", "6"],
                                  device="cpu")
    assert seen == ["triangle"]
    assert all(np.isfinite(v) for v in stats.values())
    assert len(results["mass_conservation"]["times"]) == 128
