"""The port's physics diagnostics (diagnostics/analysis.py) against the
JAX package's: the same CRBE trajectory (each package's own solve at
ms=8, nt=9, f64, 2.6e-16 apart) and the same PINN parameters (carried
over by ``interop.pinn_params_from_numpy``), both quadratures and a
strided trajectory; every quantity within 1e-12 of its max."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.diagnostics import analysis as janalysis  # noqa: E402
from airpollution_tpu.models.crbe import CRBESolver as JCRBESolver  # noqa: E402
from airpollution_tpu.models.pinn import PINN as JPINN  # noqa: E402
import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.diagnostics import analysis  # noqa: E402
from airpollution_tpu_torch.interop import pinn_params_from_numpy  # noqa: E402

from tests.torch_port_pinn_helpers import jax_params, np_params  # noqa: E402

F64 = torch.float64
TOL = 1e-12
LAYERS = [3, 8, 8, 1]


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape
    if not want.size:
        return
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= tol * scale


def close_tree(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            close_tree(got[k], want[k])
    else:
        close(got, want)


@pytest.fixture(scope="module")
def pair():
    """(JAX, port) mesh data, solved trajectories by snapshot stride, and
    PINNs."""
    problem = dict(sigma=1.0)
    jmd = japt.MeshData(japt.create_mesh(8, 20.0), japt.Domain(), nt=9,
                        dtype=jnp.float64)
    tmd = tapt.MeshData(tapt.create_mesh(8, 20.0), tapt.Domain(), nt=9,
                        dtype=F64, device="cpu")
    js = JCRBESolver(japt.Domain(), japt.Problem(**problem), jmd,
                     stiffness_convention="reference", solver_tol=1e-13)
    ts = tapt.CRBESolver(tapt.Domain(), tapt.Problem(**problem), tmd,
                         stiffness_convention="reference", solver_tol=1e-13,
                         device="cpu")
    js.solve()
    ts.solve()
    close(ts.solutions, np.asarray(js.solutions), 1e-14)
    # A strided trajectory (snapshot_every=2: 5 rows of 9), the same rows
    # for both packages.
    solvers = {None: (js, ts), 2: (
        SimpleNamespace(solutions=js.solutions[::2], snapshot_every=2),
        SimpleNamespace(solutions=ts.solutions[::2], snapshot_every=2))}
    params = np_params(LAYERS, "tanh", seed=3)
    jm = JPINN(LAYERS, japt.Problem(**problem), japt.Domain(),
               activation="tanh", dtype=jnp.float64)
    jm.params = jax_params(params)
    tm = tapt.PINN(LAYERS, tapt.Problem(**problem), tapt.Domain(),
                   activation="tanh", dtype=F64, device="cpu")
    tm.mlp = pinn_params_from_numpy(params, "tanh", dtype=F64, device="cpu")
    return {"md": (jmd, tmd), "solvers": solvers, "pinn": (jm, tm)}


def test_functions_match_jax(pair):
    jmd, tmd = pair["md"]
    jm, tm = pair["pinn"]
    js, ts = pair["solvers"][None]
    w = analysis.quadrature_weights(tmd)
    jw = janalysis.quadrature_weights(jmd)
    close(w, jw)
    # The weights are the diagonal of the CR mass matrix: they sum to the
    # box's area.
    assert abs(float(w.sum()) - 40.0 ** 2) <= 1e-9
    times = np.asarray(jmd.time_discr)[::4]
    close(analysis.evaluate_pinn_on_grid(tm, tmd, times),
          janalysis.evaluate_pinn_on_grid(jm, jmd, times))
    U, jU = ts.solutions, jnp.asarray(js.solutions)
    close(analysis.mass_over_time(U, w), janalysis.mass_over_time(jU, jw))
    for got, want in zip(
            analysis.center_of_mass_over_time(U, w, tmd.midpoints),
            janalysis.center_of_mass_over_time(jU, jw, jmd.midpoints)):
        close(got, want)
    for got, want in zip(analysis.variance_over_time(U, w, tmd.midpoints),
                         janalysis.variance_over_time(jU, jw,
                                                      jmd.midpoints)):
        close(got, want)
    for got, want in zip(analysis.peak_tracking(U, tmd.midpoints),
                         janalysis.peak_tracking(jU, jmd.midpoints)):
        close(got, want)
    close_tree(analysis.concentration_profiles(U, tmd, 0.0, tol=2.0),
               janalysis.concentration_profiles(jU, jmd, 0.0, tol=2.0))


@pytest.mark.parametrize("quadrature,stride", [
    ("triangle", None), ("segment", None), ("triangle", 2)])
def test_comprehensive_analysis_matches_jax(pair, quadrature, stride):
    """Every result of ``run_all_analyses`` and ``summary_statistics``,
    with each quadrature and on a strided trajectory (5 rows of 9)."""
    jmd, tmd = pair["md"]
    jm, tm = pair["pinn"]
    js, ts = pair["solvers"][stride]
    problem = (japt.Problem(sigma=1.0), tapt.Problem(sigma=1.0))
    want = janalysis.ComprehensiveAnalysis(
        problem[0], japt.Domain(), jmd, js, jm, quadrature=quadrature)
    got = analysis.ComprehensiveAnalysis(
        problem[1], tapt.Domain(), tmd, ts, tm, quadrature=quadrature)
    w_res = want.run_all_analyses()
    g_res = got.run_all_analyses()
    assert len(g_res["mass_conservation"]["times"]) == (5 if stride else 9)
    close_tree(g_res, w_res)
    w_sum, g_sum = want.summary_statistics(), got.summary_statistics()
    assert list(g_sum) == list(w_sum)
    for k in w_sum:
        assert abs(g_sum[k] - w_sum[k]) <= TOL * max(abs(w_sum[k]), 1.0), k


def test_misaligned_trajectory_raises(pair):
    _, tmd = pair["md"]
    _, tm = pair["pinn"]
    _, ts = pair["solvers"][None]

    class Truncated:
        solutions = ts.solutions[:4]
        snapshot_every = 3

    with pytest.raises(ValueError, match="cannot align"):
        analysis.ComprehensiveAnalysis(tapt.Problem(), tapt.Domain(), tmd,
                                       Truncated(), tm)
    with pytest.raises(ValueError, match="unknown quadrature"):
        analysis.ComprehensiveAnalysis(tapt.Problem(), tapt.Domain(), tmd,
                                       ts, tm, quadrature="gauss")


def test_problem3_scripts_run_on_the_cpu(tmp_path, monkeypatch):
    """scripts/torch_port_problem3.py and its comprehensive analysis at
    ms=6 with 2 PINN epochs (figures held by the reporting tests): a
    finite PINN-against-CRBE discrepancy, every diagnostic over the 128
    steps, and the summary block's keys."""
    from scripts import torch_port_problem3 as p3
    from scripts import torch_port_problem3_comprehensive_analysis as p3c

    monkeypatch.chdir(tmp_path)
    for cls, names in ((tapt.CRBESolver, ["plot_interpolated_solution"]),
                       (tapt.PINN, ["plot_history",
                                    "plot_interpolated_solution"]),
                       (analysis.ComprehensiveAnalysis,
                        ["plot_all_results"])):
        for name in names:
            monkeypatch.setattr(cls, name, lambda *a, **k: None)
    l2, mx = p3.main(["--epochs", "2", "--m_size", "6"], device="cpu")
    assert np.isfinite(l2) and 0 < mx <= l2
    results, stats = p3c.main(["--epochs", "2", "--m_size", "6",
                               "--quadrature", "segment"], device="cpu")
    assert len(results["mass_conservation"]["times"]) == p3c.N_STEPS
    assert set(stats) == {
        "mass_loss_crbe_pct", "mass_loss_pinn_pct", "com_error_x_crbe",
        "com_error_x_pinn", "peak_decay_crbe_pct", "peak_decay_pinn_pct"}
    assert all(np.isfinite(v) for v in stats.values())
    assert p3.batch_sizes(705) == {"pde": 504, "ic": 176, "bc": 25}


@pytest.mark.parametrize("activation,fourier,amp", [
    ("adaptive_tanh", 0, None), ("tanh", 4, 0.3), ("sine", 0, 2.0),
    ("swish", 3, None)])
def test_mlp_functions_match_jax(activation, fourier, amp):
    """``models.init_mlp_params`` gives the JAX package's layout (keys and
    shapes; the draws are torch's), and ``models.mlp_apply`` on one set of
    parameters is JAX's forward pass to 1e-12."""
    import jax

    from airpollution_tpu.models import pinn as jpinn
    from airpollution_tpu_torch import models

    layers = [3, 6, 5, 1]
    want = jpinn.init_mlp_params(jax.random.PRNGKey(0), layers, activation,
                                 dtype=jnp.float64,
                                 fourier_features=fourier,
                                 output_scale=amp or 0.0)
    got = models.init_mlp_params(0, layers, activation, dtype=F64,
                                 fourier_features=fourier,
                                 output_scale=amp or 0.0, device="cpu")
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in got] \
        == [{k: tuple(v.shape) for k, v in layer.items()} for layer in want]
    params = np_params(layers, activation, fourier=fourier, amp=amp, seed=4)
    x = np.random.default_rng(1).uniform(-20, 20, (2, 7, 3))
    out = models.mlp_apply([{k: torch.tensor(v) for k, v in layer.items()}
                            for layer in params], torch.tensor(x),
                           activation)
    close(out, jpinn.mlp_apply(jax_params(params), jnp.asarray(x),
                               activation))
