"""The port's street-canyon and convergence scripts against the JAX
package's, on the CPU in float64 at a small size:
scripts/torch_port_obstacle_canyon_demo.py (both rows: the stencil scan,
and kernel B4's plain version with the buildings' dead DOFs, the street
source and the Robin rows in its load plane) and
torch_port_rotating_convergence.py, each beside its JAX script. The JAX
canyon runs float32: its MeshData is patched to float64. Every figure of
a row within 1e-9 (relative) of the JAX one, timings aside; the fused
row on the JAX solvers' Chebyshev intervals."""

import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu.models.crbe import CRBESolver as JaxSolver  # noqa: E402

from torch_port_helpers import one_torch_thread  # noqa: E402,F401
from torch_port_script_helpers import (  # noqa: E402
    TOL, assert_same_cells, assert_same_figures, capture, f64_meshes,
    load_script, quiet, run_jax_main)

F64 = torch.float64


@pytest.mark.parametrize("impl", ["stencil", "fused_hbm"])
def test_obstacle_canyon_matches_jax(monkeypatch, impl):
    """Both rows at 17^2 with snapshots every 5 steps (nt 21; the fused
    row nt 41, where Chebyshev applies): every budget term,
    the street and shadow means, the shielding ratio and the facade dose;
    the solids exactly 0.0. The fused row (Chebyshev-8, the 2k check)
    runs on the JAX solvers' intervals."""
    jscript = load_script("obstacle_canyon_demo.py")
    tscript = load_script("torch_port_obstacle_canyon_demo.py")
    f64_meshes(monkeypatch, jscript)
    quiet(monkeypatch, jscript, tscript)
    made = capture(monkeypatch, jscript, "CRBESolver", JaxSolver)
    nt = 21 if impl == "stencil" else 41
    want = jscript.run(17, nt, 5, warm=False, matvec_impl=impl)
    bounds = None
    if impl == "fused_hbm":
        bounds = {"canyon": made[0]._cheb_bounds, "flat": made[2]._cheb_bounds}
        assert made[1]._cheb_bounds == made[0]._cheb_bounds
    got = tscript.run(17, nt, 5, warm=False, matvec_impl=impl, device="cpu",
                      dtype=F64, cheb_bounds=bounds)
    solvers = got.pop("solvers")
    assert_same_figures(got, want)
    assert got["solid_max_abs"] == want["solid_max_abs"] == 0.0
    if impl == "fused_hbm":
        assert solvers["canyon"].fused_kernel == "B4"
        assert got["k_vs_2k_rel_maxdiff"] < 5e-3


def test_obstacle_canyon_divergence_stops_the_run(monkeypatch):
    """A non-finite solve ends the script (SystemExit), as in JAX."""
    tscript = load_script("torch_port_obstacle_canyon_demo.py")
    quiet(monkeypatch, tscript)
    real = tscript.CRBESolver.solve

    def blown(self, *a, **k):
        return real(self, *a, **k) * float("nan")

    monkeypatch.setattr(tscript.CRBESolver, "solve", blown)
    with pytest.raises(SystemExit, match="diverged"):
        tscript.run(9, 5, 2, warm=False, device="cpu", dtype=F64)


@pytest.mark.parametrize("problem", ["rotating", "anisotropic"])
def test_rotating_convergence_matches_jax(monkeypatch, tmp_path, problem):
    """BE and CN at 5^2 and 9^2: each error within 1e-9, and the CSV's
    cells equal (solve times and the platform aside)."""
    jscript = load_script("rotating_convergence.py")
    tscript = load_script("torch_port_rotating_convergence.py")
    made = capture(monkeypatch, jscript, "CRBESolver", JaxSolver)
    argv = ["--mesh_sizes", "5", "9", "--nt", "9", "--problem", problem]
    run_jax_main(monkeypatch, jscript, [*argv, "--out",
                                        str(tmp_path / "jax.csv")])
    rows = tscript.main([*argv, "--device", "cpu", "--out",
                         str(tmp_path / "port.csv")])
    p = jscript.RotatingPlumeProblem() if problem == "rotating" else \
        jscript.AnisotropicPlumeProblem(Dx=0.2, Dy=0.02)
    want = [s.compute_errors(p.analytical_solution) for s in made]
    assert len(rows) == len(want) == 4
    for row, (rel, l2, mx) in zip(rows, want):
        assert row["rel_l2"] == pytest.approx(float(rel), rel=TOL)
        assert row["max_error"] == pytest.approx(float(mx), rel=TOL)
    assert_same_cells(tmp_path / "port.csv", tmp_path / "jax.csv",
                      skip=("solve_time_s", "platform"))
