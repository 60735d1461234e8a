"""The port's fused-kernel scripts against the JAX package's, on the CPU
in float64 at a small size: scripts/torch_port_extrapolate_ab.py (kernel
B4's raw mode through the differentiable fused engine, on the JAX
kernel's plain polynomial: interpret mode is the slow tail of the suite)
and torch_port_multispecies_fused_demo.py (kernel B6 and, unfused, B4,
on the JAX fused solver's Chebyshev interval), each beside its JAX
script, whose MeshData is patched to float64 (they run float32). Every
figure within 1e-9 (relative) of the JAX one, timings aside."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu.diagnostics import inverse as jinv  # noqa: E402
from airpollution_tpu.models.multispecies import (  # noqa: E402
    MultiSpeciesSolver as JaxMultiSpecies,
)
from airpollution_tpu.ops import pallas_hbm as jhbm  # noqa: E402

from torch_port_helpers import jax_plain_raw, one_torch_thread  # noqa: E402,F401
from torch_port_script_helpers import (  # noqa: E402
    TOL, assert_same_figures, capture, f64_meshes, load_script, quiet,
    run_jax_main)

F64 = torch.float64


def test_extrapolate_ab_matches_jax(monkeypatch):
    """The four (extrapolate, k) rows at 9^2, nt=9: the tight scan solve,
    each fixed-k final state and each timed fit's losses."""
    monkeypatch.setattr(jhbm, "chebyshev_apply_canvas_hbm", jax_plain_raw)
    jscript = load_script("extrapolate_ab.py")
    tscript = load_script("torch_port_extrapolate_ab.py")
    f64_meshes(monkeypatch, jscript)
    seen = {"final": [], "fits": []}

    class Spy:
        def __getattr__(self, name):
            return getattr(jinv, name)

        def solve_final_state(self, *a, **k):
            u = jinv.solve_final_state(*a, **k)
            seen["final"].append(np.asarray(u))
            return u

        def fit_source(self, *a, **k):
            res, losses = jinv.fit_source(*a, **k)
            seen["fits"].append(np.asarray(losses))
            return res, losses

    monkeypatch.setattr(jscript, "inverse", Spy())
    quiet(monkeypatch, jscript, tscript)
    run_jax_main(monkeypatch, jscript, [
        "--mesh_size", "9", "--nt", "9", "--sensors", "12", "--timed_steps",
        "1", "--out", "/dev/null"])
    tspy = {"final": []}
    treal = tscript.inverse.solve_final_state

    def tfinal(*a, **k):
        u = treal(*a, **k)
        tspy["final"].append(u.detach().numpy())
        return u

    monkeypatch.setattr(tscript.inverse, "solve_final_state", tfinal)
    res = tscript.run(9, 9, 12, 1, device="cpu", dtype=F64)
    assert len(tspy["final"]) == len(seen["final"]) == 5
    for got, want in zip(tspy["final"], seen["final"]):
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    tight = seen["final"][0]
    for row, want_u, want_losses in zip(res["rows"], seen["final"][1:],
                                        seen["fits"][1::2]):
        acc = np.abs(want_u - tight).max() / np.abs(tight).max()
        assert row["primal_rel_maxdiff_vs_tight"] == pytest.approx(
            acc, rel=1e-6)
        np.testing.assert_allclose(row["losses"], want_losses, rtol=TOL)
    assert [(r["extrapolate"], r["chebyshev_iters"]) for r in res["rows"]] \
        == [(False, 12), (False, 8), (True, 12), (True, 8)]


@pytest.mark.parametrize("K,scan,warm", [(3, True, True), (4, False, False)])
def test_multispecies_fused_matches_jax(monkeypatch, K, scan, warm):
    """One row at 9^2, nt=9 on the JAX fused solver's interval: the chain
    masses, k against 2k, and (K = 3, warm) the fuse A/B and the stencil
    scan's cross-check on its own interval; K = 4 is a row of the K
    sweep."""
    jscript = load_script("multispecies_fused_demo.py")
    tscript = load_script("torch_port_multispecies_fused_demo.py")
    f64_meshes(monkeypatch, jscript)
    quiet(monkeypatch, jscript, tscript)
    made = capture(monkeypatch, jscript, "MultiSpeciesSolver",
                   JaxMultiSpecies)
    want = jscript.run(9, 9, 6, scan_check=scan, K=K, warm=warm)
    bounds = made[0]._fused_bounds_cache[1]
    got = tscript.run(9, 9, 6, scan_check=scan, K=K, warm=warm,
                      device="cpu", dtype=F64, cheb_bounds=bounds)
    solvers = got.pop("solvers")
    assert_same_figures(got, want)
    assert set(solvers) == {"fused", "fused_2k"} | (
        {"unfused", "scan"} if scan else set())


def test_multispecies_oracle_matches_jax(monkeypatch):
    jscript = load_script("multispecies_fused_demo.py")
    tscript = load_script("torch_port_multispecies_fused_demo.py")
    quiet(monkeypatch, jscript, tscript)
    want = jscript.run_oracle(9, 9)
    got = tscript.run_oracle(9, 9, device="cpu")
    assert_same_figures(got, want)
