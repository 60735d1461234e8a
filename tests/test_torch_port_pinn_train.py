"""The port's PINN training (models/pinn.py, ops/sampling.py,
io/checkpoint.py) on the CPU in float64: Adam epochs against the JAX
package's on the same points (the grad-norm weights with a Fourier
embedding included), the samplers' properties, early stopping, warm
starts, chunking, checkpoints (a JAX params file included) and trained
error against the JAX package's in a band."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import airpollution_tpu as japt  # noqa: E402
from airpollution_tpu.io import checkpoint as jckpt  # noqa: E402
from airpollution_tpu.models import pinn as jpinn  # noqa: E402
from airpollution_tpu.ops import sampling as jsampling  # noqa: E402

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch.interop import pinn_params_from_file  # noqa: E402
from airpollution_tpu_torch.io import checkpoint as tckpt  # noqa: E402
from airpollution_tpu_torch.models import pinn as tpinn  # noqa: E402
from airpollution_tpu_torch.ops import sampling as tsampling  # noqa: E402

from torch_port_helpers import mesh_pair, one_torch_thread  # noqa: E402,F401
from torch_port_pinn_helpers import (  # noqa: E402
    F64, boundary_points, jax_params, np_params, points, problem_pair, rel,
    tree_rel)

SIZES = {"pde": 64, "ic": 16, "bc": 16}
LAM = {"pde": 1.0, "ic": 1.0, "bc": 1.0}


def _pinn(layers=(3, 8, 1), seed=0, **kw):
    kw.setdefault("activation", "tanh")
    return tapt.PINN(list(layers), tapt.Problem(), tapt.Domain(), seed=seed,
                     dtype=F64, device="cpu", **kw)


# --- Adam epochs against the JAX trainer on fixed points -------------------

@pytest.mark.parametrize("case", ["plain", "grad_norm_fourier",
                                  "hard_ic_plateau"])
def test_adam_epochs_match_jax(monkeypatch, case):
    """Epochs of both trainers on the same points (the samplers patched):
    the per-epoch losses, the parameters (one Adam step and more) and, for
    grad-norm annealing, the adaptive weights within 1e-12."""
    pde, ic, bc = points(47, 31), points(13, 32)[:, :2], \
        boundary_points(20, 33)
    monkeypatch.setattr(
        jsampling, "lhs_sampling",
        lambda key, n, xy, t=None, dtype=None: jnp.asarray(
            pde if t is not None else ic))
    monkeypatch.setattr(jsampling, "sample_boundary_points",
                        lambda *a, **k: jnp.asarray(bc))
    monkeypatch.setattr(
        tsampling, "lhs_sampling",
        lambda g, n, xy, t=None, dtype=None: torch.tensor(
            pde if t is not None else ic))
    monkeypatch.setattr(tsampling, "sample_boundary_points",
                        lambda *a, **k: torch.tensor(bc))
    # The JAX trainer is cached per configuration: trace it anew here.
    monkeypatch.setattr(jpinn, "_TRAIN_FN_CACHE", {})
    sizes = {"pde": 47, "ic": 13, "bc": 20}
    lam = {"pde": 2.0, "ic": 10.0, "bc": 5.0}
    model_kw, train_kw, epochs = {}, {}, 3
    fourier = 0
    if case == "grad_norm_fourier":
        fourier = 5
        model_kw = {"fourier_features": fourier}
        train_kw = {"adaptive_weights_every": 2}
        epochs = 4
    elif case == "hard_ic_plateau":
        # A min_delta no loss can beat: every epoch after the first counts
        # against patience, and the stop masks the epochs after it.
        model_kw = {"hard_ic": True}
        train_kw = {"early_stopping_patience": 2,
                    "early_stopping_min_delta": 1e10}
        epochs = 6
    params = np_params([3, 8, 8, 1], fourier=fourier, seed=7)
    jp, tp = problem_pair("plume")
    jm = jpinn.PINN([3, 8, 8, 1], jp, japt.Domain(), dtype=jnp.float64,
                    **model_kw)
    jm.params = jax_params(params)
    jh = jm.train(sizes, epochs, 3e-3, lam, **train_kw)
    tm = tapt.PINN([3, 8, 8, 1], tp, tapt.Domain(), dtype=F64,
                   device="cpu", **model_kw)
    tm.params = params
    th = tm.train(sizes, epochs, 3e-3, lam, **train_kw)
    for k in ("total_loss", "pde_loss", "ic_loss", "bc_loss"):
        assert len(th[k]) == len(jh[k])
        np.testing.assert_allclose(th[k], jh[k], rtol=1e-12, atol=1e-300)
    assert tree_rel(tm.params, jm.params, skip=()) <= 1e-12
    carry, jcarry = tm._carry_state, jm._carry_state
    for k in ("lam_ic", "lam_bc", "lr", "es_best", "plateau_best"):
        assert rel(carry[k], getattr(jcarry, k)) <= 1e-12, k
    assert int(carry["step"]) == int(jcarry.step)
    if case == "grad_norm_fourier":
        assert abs(float(carry["lam_ic"]) - 10.0 / 2.0) > 1e-3
    if case == "hard_ic_plateau":
        assert len(th["total_loss"]) == 3  # 1 improving epoch + patience


# --- samplers --------------------------------------------------------------

def _strata(u, n):
    """True when each of the n strata of [0, 1) holds one value."""
    return sorted(np.floor(np.asarray(u) * n).astype(int).tolist()) == \
        list(range(n))


def test_lhs_stratified_and_column_order():
    g = torch.Generator().manual_seed(5)
    u = tsampling.lhs_unit(g, 50, 3, F64)
    assert u.shape == (50, 3) and all(_strata(u[:, j], 50) for j in range(3))
    # The space-time sample takes column 0 of the same LHS draw for t,
    # 1 for x and 2 for y.
    pts = tsampling.lhs_sampling(torch.Generator().manual_seed(9), 50,
                                 (-20.0, 20.0, -10.0, 10.0), (0.0, 4.0), F64)
    ref = tsampling.lhs_unit(torch.Generator().manual_seed(9), 50, 3, F64)
    torch.testing.assert_close(pts[:, 2], 4.0 * ref[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(pts[:, 0], 40.0 * ref[:, 1] - 20.0, rtol=0,
                               atol=1e-14)
    torch.testing.assert_close(pts[:, 1], 20.0 * ref[:, 2] - 10.0, rtol=0,
                               atol=1e-14)
    xy = tsampling.lhs_sampling(g, 30, (-1.0, 1.0, 0.0, 2.0), dtype=F64)
    assert xy.shape == (30, 2)
    assert _strata((xy[:, 0] + 1.0) / 2.0, 30) and _strata(xy[:, 1] / 2.0, 30)


def test_boundary_blocks():
    g = torch.Generator().manual_seed(1)
    pts = tsampling.sample_boundary_points(g, 42, (-20.0, 20.0, -5.0, 5.0),
                                           (0.0, 10.0), F64)
    assert pts.shape == (40, 3)
    k = 10
    left, right, bottom, top = (pts[i * k:(i + 1) * k] for i in range(4))
    assert bool((left[:, 0] == -20.0).all() and (right[:, 0] == 20.0).all())
    assert bool((bottom[:, 1] == -5.0).all() and (top[:, 1] == 5.0).all())
    assert _strata((left[:, 1] + 5.0) / 10.0, k)
    assert _strata((top[:, 0] + 20.0) / 40.0, k)
    assert float(pts[:, 2].min()) >= 0.0 and float(pts[:, 2].max()) < 10.0
    # The same counts and layout as the JAX sampler.
    jpts = jsampling.sample_boundary_points(
        jax.random.PRNGKey(0), 42, (-20.0, 20.0, -5.0, 5.0),
        (0.0, 10.0), jnp.float64)
    assert jpts.shape == pts.shape
    np.testing.assert_array_equal(np.asarray(jpts)[:k, 0], -20.0)


def test_facade_counts_and_normals():
    obstacles = ((-6.0, -1.0, -4.0, 3.0), (4.0, 9.0, 2.0, 5.0))
    g = torch.Generator().manual_seed(2)
    xyt, nrm = tsampling.sample_facade_points(g, 61, obstacles, (0.0, 10.0),
                                              F64)
    jxyt, jnrm = jsampling.sample_facade_points(
        jax.random.PRNGKey(0), 61, obstacles, (0.0, 10.0),
        jnp.float64)
    assert xyt.shape == jxyt.shape and nrm.shape == jnrm.shape
    np.testing.assert_array_equal(nrm.numpy(), np.asarray(jnrm))
    _, counts = tsampling.facade_counts(61, obstacles)
    assert min(counts) >= 1 and len(counts) == 8
    assert bool((nrm.norm(dim=1) == 1.0).all())
    # A step along the normal leaves the solid, a step against it enters.
    tp = tapt.Problem()
    tp.obstacles = obstacles
    out = tp.obstacle_fn(xyt[:, :2] + 1e-3 * nrm)
    inside = tp.obstacle_fn(xyt[:, :2] - 1e-3 * nrm)
    assert not bool(out.any()) and bool(inside.all())


def test_rad_select_unique_and_weighted():
    g = torch.Generator().manual_seed(4)
    w = torch.ones(1000, dtype=F64)
    w[:100] = 50.0
    idx = tpinn.rad_select(g, w, 200)
    assert idx.shape == (200,) and len(set(idx.tolist())) == 200
    heavy = int((idx < 100).sum())
    # 100 heavy points hold 5/6 of the weight: most are drawn.
    assert heavy >= 80


# --- early stopping, warm start, chunks -----------------------------------

def test_early_stopping_cuts_history_at_patience_plus_one():
    h = _pinn().train(SIZES, 200, 1e-3, LAM, early_stopping_patience=5,
                      early_stopping_min_delta=1e10)
    assert len(h["total_loss"]) == 6


def test_restore_gives_best_epochs_post_update_params():
    m = _pinn(seed=1)
    h = m.train(SIZES, 60, 5e-3, LAM, early_stopping_patience=8,
                early_stopping_min_delta=1e-3, scan_chunk=16)
    losses = np.asarray(h["total_loss"])
    assert len(losses) < 60
    # The epoch the criterion last took as best (improvement beyond
    # min_delta over the running best).
    best, best_i = np.inf, -1
    for i, v in enumerate(losses):
        if v < best - 1e-3:
            best, best_i = v, i
    replay = _pinn(seed=1)
    replay.train(SIZES, best_i + 1, 5e-3, LAM)
    torch.testing.assert_close(m.mlp.flat, replay.mlp.flat, rtol=0, atol=0)


def test_warm_start_continues_and_new_lr_wins():
    m = _pinn(seed=2)
    m.train(SIZES, 50, 1e-3, LAM)
    l1 = m.history["total_loss"][-1]
    m.train(SIZES, 50, 1e-3, LAM, warm_start=True)
    assert len(m.history["total_loss"]) == 100
    assert np.isfinite(m.history["total_loss"][-1])
    assert m.history["total_loss"][-1] < 2.0 * l1
    st = m._carry_state
    assert float(st["adam_step"]) == 100 and st["step"] == 100
    assert float(st["lr"]) == 1e-3
    m.train(SIZES, 5, 4e-4, LAM, warm_start=True)
    assert float(m._carry_state["lr"]) == 4e-4
    assert float(m._carry_state["adam_step"]) == 105


@pytest.mark.parametrize("extra", [{}, {"early_stopping_patience": 4,
                                        "early_stopping_min_delta": 1e-3},
                                   {"adaptive_oversample": 2.0,
                                    "causal_eps": 1.0, "causal_bins": 8}])
def test_chunked_equals_monolithic(extra):
    runs = []
    for chunk in (7, 0):
        m = _pinn(seed=3)
        h = m.train(SIZES, 30, 4e-3, LAM, scan_chunk=chunk, **extra)
        runs.append((np.asarray(h["total_loss"]), m.mlp.flat.detach()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    torch.testing.assert_close(runs[0][1], runs[1][1], rtol=0, atol=0)


def test_training_options_run(tmp_path):
    """Obstacles with a split facade term, Robin sides, reaction and a
    variable D train and stay finite; the options the JAX package refuses
    are refused."""
    for name, kw in (("obstacles", {"facade": 3.0}), ("robin", {}),
                     ("reaction", {}), ("variable_D", {})):
        _, tp = problem_pair(name)
        m = tapt.PINN([3, 8, 1], tp, tapt.Domain(), dtype=F64, device="cpu")
        lam = dict(LAM, **kw)
        h = m.train(dict(SIZES, facade=12), 5, 1e-3, lam)
        assert np.isfinite(h["total_loss"]).all()
    _, tp = problem_pair("obstacles")
    m = tapt.PINN([3, 8, 1], tp, tapt.Domain(), dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="facade"):
        m.train(SIZES, 1, 1e-3, dict(LAM, facade=1.0),
                adaptive_weights_every=2)
    with pytest.raises(ValueError, match="causal_bins"):
        _pinn().train({"pde": 8, "ic": 4, "bc": 4}, 1, 1e-3, LAM,
                      causal_eps=1.0)

    class Custom(tapt.Problem):
        def obstacle_fn(self, xy):
            return xy[..., 0] > 100.0

    with pytest.raises(ValueError, match="rectangle"):
        tapt.PINN([3, 4, 1], Custom(), tapt.Domain(), device="cpu").train(
            SIZES, 1, 1e-3, LAM)


# --- checkpoints -----------------------------------------------------------

def test_checkpoint_round_trip_and_resume(tmp_path):
    m = _pinn(layers=(3, 8, 8, 1), seed=4, activation="adaptive_tanh",
              fourier_features=3, output_scale=0.3)
    m.train(SIZES, 20, 1e-3, LAM)
    tckpt.save_pinn(str(tmp_path), m, epoch=20)
    other = _pinn(layers=(3, 8, 8, 1), seed=9, activation="adaptive_tanh",
                  fourier_features=3, output_scale=0.3)
    other.train(SIZES, 0, 1e-3, LAM)
    tckpt.load_pinn(str(tmp_path), other)
    torch.testing.assert_close(other.mlp.flat, m.mlp.flat, rtol=0, atol=0)
    torch.testing.assert_close(other.mlp.B, m.mlp.B, rtol=0, atol=0)
    for k in tpinn.CARRY_FIELDS:
        a, b = other._carry_state[k], m._carry_state[k]
        assert np.array_equal(np.asarray(a), np.asarray(b)), k
    assert tckpt.read_meta(str(tmp_path))["step"] == 20
    with pytest.raises(ValueError):
        tckpt.load_pinn(str(tmp_path), _pinn(layers=(3, 6, 1)))

    ckpt = str(tmp_path / "run")
    first = _pinn(seed=5)
    tckpt.train_with_checkpoints(first, SIZES, 20, 1e-3, LAM, ckpt,
                                 checkpoint_every=10)
    assert len(first.history["total_loss"]) == 20
    resumed = _pinn(seed=5)
    h = tckpt.train_with_checkpoints(resumed, SIZES, 40, 1e-3, LAM, ckpt,
                                     checkpoint_every=10)
    assert len(h["total_loss"]) == 20
    assert tckpt.read_meta(ckpt)["step"] == 40
    assert float(resumed._carry_state["adam_step"]) == 40

    u = np.arange(12.0).reshape(3, 4)
    tckpt.save_field(str(tmp_path / "f.npz"), torch.tensor(u), [0.0, 1.0, 2.0])
    sol, times = tckpt.load_field(str(tmp_path / "f.npz"))
    np.testing.assert_array_equal(sol, u)
    np.testing.assert_array_equal(times, [0.0, 1.0, 2.0])


@pytest.mark.parametrize("fourier", [0, 4])
def test_jax_params_file_loads_into_the_port(tmp_path, fourier):
    jp, tp = problem_pair("plume")
    jm = jpinn.PINN([3, 8, 8, 1], jp, japt.Domain(), dtype=jnp.float64,
                    fourier_features=fourier, output_scale=0.4, seed=3)
    path = jckpt.save_pinn(str(tmp_path), jm)
    x = points(25, 8)
    want = jm.forward(jnp.asarray(x))
    mlp = pinn_params_from_file(path, dtype=F64, device="cpu")
    assert rel(mlp(torch.tensor(x)), want) <= 1e-12
    tm = tapt.PINN([3, 8, 8, 1], tp, tapt.Domain(), dtype=F64,
                   fourier_features=fourier, output_scale=0.4, device="cpu")
    tckpt.load_pinn(str(tmp_path), tm)
    assert rel(tm.forward(x), want) <= 1e-12
    # And the other way: the port's params file into the JAX model.
    tckpt.save_pinn(str(tmp_path / "port"), tm)
    jm2 = jpinn.PINN([3, 8, 8, 1], jp, japt.Domain(), dtype=jnp.float64,
                     fourier_features=fourier, output_scale=0.4, seed=8)
    jckpt.load_pinn(str(tmp_path / "port"), jm2)
    assert rel(tm.forward(x), jm2.forward(jnp.asarray(x))) <= 1e-12


# --- trained error in a band ----------------------------------------------

def test_trained_loss_in_a_band_of_jax():
    """Both packages from the same initial parameters, 300 epochs of their
    own sampling: each loss falls at least 10x, and the port's final loss
    (the mean of the last 20 epochs) lies within a factor of 3 of JAX's;
    the rel-L2 at t = T on ms=8 improves in both."""
    params = np_params([3, 16, 16, 1], "tanh", seed=2)
    for p in params:
        p["b"][:] = 0.0
    jp, tp = problem_pair("plume")
    jmd, tmd = mesh_pair(8)
    sizes = {"pde": 256, "ic": 64, "bc": 64}
    lam = {"pde": 2.0, "ic": 10.0, "bc": 10.0}
    jm = jpinn.PINN([3, 16, 16, 1], jp, japt.Domain(), activation="tanh",
                    dtype=jnp.float64)
    jm.params = jax_params(params)
    tm = tapt.PINN([3, 16, 16, 1], tp, tapt.Domain(), activation="tanh",
                   dtype=F64, device="cpu")
    tm.params = params
    e0 = tm.compute_errors(tmd, tp.analytical_solution)[0]
    finals = []
    for model, md, prob in ((jm, jmd, jp), (tm, tmd, tp)):
        h = np.asarray(model.train(sizes, 300, 2e-3, lam)["total_loss"])
        assert h[-20:].mean() <= h[0] / 10.0
        assert model.compute_errors(md, prob.analytical_solution)[0] < e0
        finals.append(h[-20:].mean())
    assert finals[0] / 3.0 <= finals[1] <= 3.0 * finals[0]


def test_experiments_driver_writes_the_reference_columns(tmp_path):
    """scripts/torch_port_pinn_experiments.py on the CPU at ms=4 and 8 with
    a short schedule and the levers: one row per mesh, with the columns of
    results_snapshot/df_pinn_training_results.csv, and the schedules and
    collocation budget of the reference drivers."""
    import csv
    from pathlib import Path

    from scripts import torch_port_pinn_experiments as ex

    rows = ex.main(["--device", "cpu", "--mesh_sizes", "4", "8",
                    "--epochs", "6", "--fourier_features", "4",
                    "--causal_eps", "1.0", "--finetune_lbfgs", "2",
                    "--out_dir", str(tmp_path), "--out_suffix", "_t"])
    snapshot = Path(__file__).resolve().parents[1] / "results_snapshot"
    with open(snapshot / "df_pinn_training_results.csv") as f:
        want = next(csv.reader(f))
    with open(tmp_path / "df_pinn_training_results_t.csv") as f:
        table = list(csv.reader(f))
    assert table[0] == want and len(table) == 3
    assert [r["mesh_size"] for r in rows] == [4, 8]
    for r in rows:
        # 6 Adam epochs (none stopped early) and 2 L-BFGS steps.
        assert r["epochs_run"] == 8
        assert np.isfinite(r["rel_l2_error"]) and r["epochs_per_sec"] > 0
    # The schedules are the reference drivers' (experiments/common.py).
    from experiments import common

    for name in ("MESH_SIZES", "N_NEURONS", "EPOCHS_LIST",
                 "EARLY_STOPPING_PATIENCE_LIST", "LR_LIST",
                 "LAMBDA_WEIGHTS"):
        assert getattr(ex, name) == getattr(common, name), name
    for n_dofs in [r["n_dofs"] for r in rows] + [48641]:
        assert ex.collocation_budget(n_dofs) == \
            common.collocation_budget(n_dofs)
    assert ex.collocation_budget(48641) == {"pde": 34744, "ic": 6949,
                                            "bc": 6949}
