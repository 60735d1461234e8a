"""The port's inverse scripts against the JAX package's, on the CPU in
float64 at a small size: scripts/torch_port_wind_inversion_demo.py
(``inverse.fit_wind`` with its omega grid, jointly with D) and
torch_port_multispecies_demo.py (the chain's convergence rows, then
``inverse.fit_chemistry``), each beside its JAX script (the wind demo's
MeshData patched to float64: it runs float32). Every figure within 1e-9
(relative) of the JAX one, timings and the platform aside."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402

from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_script_helpers import (  # noqa: E402
    TOL, assert_same_cells, f64_meshes, load_script, read_rows,
    run_jax_main)


class Recorded:
    """The JAX inverse module with its fits recorded."""

    def __init__(self, fits):
        self.fits = fits

    def __getattr__(self, name):
        return getattr(jinv, name)

    def fit_wind(self, *a, **k):
        self.fits.append(jinv.fit_wind(*a, **k))
        return self.fits[-1]


def test_wind_inversion_matches_jax(monkeypatch, tmp_path):
    """9^2, nt=16, 10 sensors, 3 Adam steps from the grid's start: every
    step's loss within 1e-9, the CSV's cells equal."""
    jscript = load_script("wind_inversion_demo.py")
    tscript = load_script("torch_port_wind_inversion_demo.py")
    f64_meshes(monkeypatch, jscript)
    fits = []
    monkeypatch.setattr(jscript, "inverse", Recorded(fits))
    monkeypatch.setattr(tscript, "log", lambda *a: None)
    argv = ["--mesh_size", "9", "--nt", "16", "--sensors", "10", "--steps",
            "3"]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    row = tscript.run(9, 16, 10, 3, device="cpu", dtype=torch.float64)
    tscript.write_csv(tmp_path / "port.csv", row)
    (want, want_losses), = fits
    assert row["omega0"] == want["omega0"]
    np.testing.assert_allclose(row["losses"], want_losses, rtol=TOL)
    assert row["est_omega"] == pytest.approx(want["omega"], rel=TOL)
    assert row["est_D"] == pytest.approx(want["D"], rel=TOL)
    assert_same_cells(tmp_path / "port.csv", tmp_path / "jax.csv",
                      skip=("fit_time_s", "s_per_step", "platform"))


def test_multispecies_demo_matches_jax(monkeypatch, tmp_path):
    """Convergence rows at 5^2 and 9^2 (nt=9) and 3 steps of the rate fit
    at 5^2: every cell of the CSV within 1e-9."""
    jscript = load_script("multispecies_demo.py")
    tscript = load_script("torch_port_multispecies_demo.py")
    argv = ["--mesh_sizes", "5", "9", "--nt", "9", "--inv_mesh_size", "5",
            "--inv_nt", "9", "--steps", "3"]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    tscript.main([*argv, "--device", "cpu", "--out",
                  str(tmp_path / "port.csv")])
    got, want = read_rows(tmp_path / "port.csv"), read_rows(
        tmp_path / "jax.csv")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k in ("solve_time_s", "fit_time_s") or v in ("", g[k]):
                assert g[k] == v or k.endswith("_time_s"), k
                continue
            assert float(g[k]) == pytest.approx(float(v), rel=TOL), k
