"""The port's command line (``python -m airpollution_tpu_torch``,
``airpollution_tpu_torch/cli.py``) on the CPU (``APT_PLATFORM=cpu``).

Against the JAX package's CLI: the parser (every subcommand, argument,
default and choice), and the JSON lines of ``solve`` (BE and CN) and
``multispecies`` (float32 solves in both: the numbers to CLI_RTOL). The
rest is the port's own behaviour, at the sizes of the JAX package's
tests/test_cli.py: the saved ``.npz`` fields, ``invert`` and
``fit-source`` recovering their parameters, ``pinn`` with checkpoints,
the other problems and meshes of ``solve``, and the subcommands that
once refused; ``ensemble`` (its numbers) and ``fno`` (its keys) against
the JAX CLI."""

import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu import cli as j_cli

from airpollution_tpu_torch import cli as t_cli
from airpollution_tpu_torch.io.checkpoint import load_field

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

CLI_RTOL = 1e-5  # float32 solves in two packages
DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture()
def port(tmp_path, monkeypatch, capsys):
    """Run the port's CLI on the CPU in a fresh directory; returns
    ``run(argv) -> (JSON line, return value)``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("APT_PLATFORM", "cpu")

    def run(argv):
        result = t_cli.main(argv)
        out = capsys.readouterr().out.strip().splitlines()
        return json.loads(out[-1]), result

    return run


def _jax_line(argv, capsys):
    j_cli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if a.__class__.__name__ == "_SubParsersAction"]
    return action.choices


def _arguments(parser):
    return {a.dest: (tuple(a.option_strings), a.default,
                     tuple(a.choices) if a.choices else None, a.nargs,
                     a.type, a.required, a.metavar)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    j_subs = _subparsers(j_cli.build_parser())
    t_subs = _subparsers(t_cli.build_parser())
    assert list(t_subs) == list(j_subs)
    for name, sp in j_subs.items():
        assert _arguments(t_subs[name]) == _arguments(sp), name


def _compare(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key in ("solve_time_s", "steps_per_sec"):
            continue
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=CLI_RTOL), key
        elif isinstance(w, list) and w and isinstance(w[0], float):
            np.testing.assert_allclose(g, w, rtol=CLI_RTOL, err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("argv", [
    ["solve", "--mesh_size", "8", "--nt", "8", "--D", "0.3"],
    ["solve", "--mesh_size", "12", "--nt", "9", "--order", "2",
     "--extrapolate", "--solver_method", "chebyshev"],
    ["multispecies", "--mesh_size", "8", "--nt", "9", "--matvec_impl",
     "uniform", "--splitting", "strang", "--source_q", "2.0"],
], ids=["solve-be", "solve-cn-chebyshev", "multispecies-uniform"])
def test_json_lines_match_jax(port, capsys, argv):
    want = _jax_line(argv, capsys)
    got, _ = port(argv)
    _compare(got, want)


def test_solve_saves_fields(port):
    line, solver = port(["solve", "--mesh_size", "6", "--nt", "5",
                         "--order", "2", "--extrapolate", "--save", "f.npz",
                         "--save_all"])
    assert line["order"] == 2 and np.isfinite(line["rel_l2"])
    sols, times = load_field("f.npz")
    assert sols.shape == (5, line["n_dofs"]) and times.shape == (5,)
    np.testing.assert_array_equal(sols, solver.solutions.numpy())
    line, _ = port(["solve", "--mesh_size", "6", "--nt", "5", "--save",
                    "g.npz"])
    sols, times = load_field("g.npz")
    assert sols.shape == (line["n_dofs"],) and times is None


@pytest.fixture()
def observed(port):
    """``solve --save`` at the JAX test's size (ms=8, nt=8, D=0.3)."""
    port(["solve", "--mesh_size", "8", "--nt", "8", "--D", "0.3", "--save",
          "obs.npz"])
    return "obs.npz"


def test_invert_recovers_D(port, observed):
    inv, _ = port(["invert", "--mesh_size", "8", "--nt", "8", "--observed",
                   observed, "--D0", "0.08", "--steps", "60", "--lr",
                   "0.15"])
    assert abs(inv["D_est"] - 0.3) / 0.3 < 0.15
    assert inv["misfit_last"] < inv["misfit_first"]


def test_sourced_trajectory_and_fit_source(port):
    """An emitter's strided trajectory (5 rows, its times), then fit-source
    on 40 sensors. The JAX package's test starts at (q 1, (0, 0)) and takes
    500 Adam steps; the port's eager differentiable solve costs ~0.35 s a
    step on one CPU thread here, so this starts nearer, at (1.5, (-3, 2)),
    and takes 50 with the same gates."""
    line, _ = port(["solve", "--problem", "gaussian_source", "--q", "2.0",
                    "--xs", "-4.0", "--ys", "2.5", "--sigma_s", "2.0",
                    "--mesh_size", "16", "--nt", "17", "--snapshot_every",
                    "4", "--save", "src.npz", "--save_all"])
    assert line["rel_l2"] is None
    sols, times = load_field("src.npz")
    assert sols.shape[0] == 5
    np.testing.assert_allclose(times, [0.0, 2.5, 5.0, 7.5, 10.0])
    fit, _ = port(["fit-source", "--observed", "src.npz", "--mesh_size",
                   "16", "--nt", "17", "--sigma_s", "2.0", "--sensors", "40",
                   "--steps", "50", "--lr", "0.15", "--q0", "1.5", "--xy0",
                   "-3", "2"])
    assert fit["n_snapshots"] == 4 and fit["n_sensors"] == 40
    assert abs(fit["q"] - 2.0) / 2.0 < 0.1
    assert abs(fit["xs"] + 4.0) < 0.3 and abs(fit["ys"] - 2.5) < 0.3
    assert fit["misfit_last"] < fit["misfit_first"] * 1e-2


def test_trajectory_rows_match_jax():
    """Saved times -> this run's step indices, t=0 dropped, as the JAX
    CLI maps them; times past this run's grid are refused."""
    import argparse

    import airpollution_tpu as japt
    import airpollution_tpu_torch as tapt

    args = argparse.Namespace(nt=5)
    obs = np.arange(20.0).reshape(5, 4)
    times = np.array([0.0, 2.5, 5.0, 7.5, 10.0])
    t_rows, t_idx = t_cli._trajectory_rows(tapt.Domain(), args, obs, times,
                                           "fit-source")
    j_rows, j_idx = j_cli._trajectory_rows(japt.Domain(), args, obs, times,
                                           "fit-source")
    np.testing.assert_array_equal(t_rows, j_rows)
    assert t_idx == j_idx == [1, 2, 3, 4]
    with pytest.raises(SystemExit, match="outside this run's grid"):
        t_cli._trajectory_rows(tapt.Domain(), args, obs,
                               np.array([0.0, 5.0, 12.5]), "fit-source")


def test_pinn_with_levers_and_checkpoint(port):
    line, model = port(["pinn", "--mesh_size", "6", "--nt", "6", "--epochs",
                        "8", "--neurons", "8", "--hidden_layers", "1",
                        "--fourier_features", "8", "--adaptive_oversample",
                        "2", "--checkpoint_dir", "ck"])
    assert line["epochs_run"] == 8 and np.isfinite(line["final_loss"])
    assert os.path.exists("ck/pinn_latest.npz")
    assert model.device.type == "cpu"


@pytest.mark.parametrize("argv,method", [
    (["--problem", "rotating", "--omega", "0.1", "--reaction", "0.2",
      "--mesh_size", "16", "--nt", "33"], "crbe"),
    (["--problem", "anisotropic", "--Dx", "0.2", "--Dy", "0.02",
      "--mesh_size", "16", "--nt", "33"], "crbe"),
    (["--problem", "turning", "--speed", "1.0", "--omega", "0.5",
      "--mesh_size", "12", "--nt", "13", "--reassemble_every", "3",
      "--save", "t.npz", "--save_all"], "crbe_quasi_static"),
    (["--mesh_size", "8", "--nt", "9", "--matvec_impl", "uniform",
      "--assembly", "patch", "--order", "2"], "crbe"),
], ids=["rotating", "anisotropic", "turning", "uniform-patch"])
def test_solve_problems(port, argv, method):
    line, _ = port(["solve"] + argv)
    assert line["method"] == method
    assert line["rel_l2"] is not None and np.isfinite(line["rel_l2"])
    if method == "crbe_quasi_static":
        assert line["reassemble_every"] == 3
        assert load_field("t.npz")[0].shape[0] == 13


def test_solve_walls_obstacles_and_mesh_files(port):
    from airpollution_tpu_torch.models.crbe import obstacle_masks
    import airpollution_tpu_torch as tapt

    line, _ = port(["solve", "--mesh_size", "8", "--nt", "9", "--problem",
                    "square_pulse", "--v", "0", "0", "--D", "1.0", "--robin",
                    "right=0.5,top=0.5", "--save", "r.npz", "--save_all"])
    assert line["rel_l2"] is None and load_field("r.npz")[0].shape[0] == 9
    with pytest.raises(SystemExit, match="side=alpha"):
        port(["solve", "--mesh_size", "8", "--robin", "right"])
    port(["solve", "--mesh_size", "10", "--nt", "6", "--obstacle", "-4", "4",
          "-4", "4", "--save", "o.npz", "--save_all"])
    p = tapt.Problem()
    p.obstacles = ((-4.0, 4.0, -4.0, 4.0),)
    md = tapt.MeshData(tapt.create_mesh(10, 20.0), tapt.Domain(), nt=6,
                       device="cpu")
    dead = obstacle_masks(md, p)[1].numpy()
    assert np.abs(load_field("o.npz")[0][1:, dead]).max() == 0.0
    line, _ = port(["solve", "--mesh_file", os.path.join(DATA, "square_5.msh"),
                    "--nt", "5"])
    assert line["mesh_size"] is None and line["mesh_file"].endswith(".msh")


@pytest.mark.parametrize("argv,item", [
    (["fit-ic", "--mesh_size", "4", "--observed", "x.npz"], None),
    (["fit-deposition", "--mesh_size", "4", "--robin", "right=0.5",
      "--observed", "x.npz"], None),
    (["fit-exchange", "--mesh_size", "4", "--robin", "right=0.5",
      "--observed", "x.npz"], None),
], ids=["fit-ic", "fit-deposition", "fit-exchange"])
def test_unported_subcommands_raise(port, argv, item):
    """Every subcommand is ported: ``fit-ic``, ``fit-deposition`` and
    ``fit-exchange`` (tests/test_torch_port_cli_fits.py) get as far as
    reading the missing observations; ``ensemble`` and ``fno`` run
    (the tests below)."""
    assert not hasattr(t_cli, "UNPORTED") and not hasattr(
        t_cli, "cmd_unported")
    assert item is None
    with pytest.raises(FileNotFoundError, match="x.npz"):
        port(argv)


@pytest.mark.parametrize("extra", [
    ["--order", "1"],
    ["--order", "2", "--place_sensors", "3"],
    ["--problem", "square_pulse", "--thresholds", "0.05"],
], ids=["be", "cn-sensors", "square-pulse"])
def test_ensemble_line_matches_jax(port, capsys, extra):
    """``ensemble`` at 8^2 with 6 members: the members are drawn with
    numpy as in the JAX package, so every number of the line agrees to
    CLI_RTOL (float32 solves in both) and the station picks are equal;
    the saved products too."""
    argv = ["ensemble", "--mesh_size", "8", "--nt", "9", "--members", "6",
            *extra]
    want = _jax_line(argv + ["--save", "j.npz"], capsys)
    got, out = port(argv + ["--save", "t.npz"])
    assert list(got) == list(want)
    assert got.pop("wall_s") >= 0.0 and want.pop("wall_s") >= 0.0
    exc_got, exc_want = got.pop("exceedance_mean"), want.pop(
        "exceedance_mean")
    assert list(exc_got) == list(exc_want)
    for tau, w in exc_want.items():
        assert exc_got[tau] == pytest.approx(w, rel=CLI_RTOL, abs=1e-7), tau
    _compare(got, want)
    assert out["members"].shape == (6, 161)
    saved, ref = np.load("t.npz"), np.load("j.npz")
    assert sorted(saved.files) == sorted(ref.files)
    for name in ref.files:
        np.testing.assert_allclose(saved[name], ref[name], rtol=CLI_RTOL,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("extra", [[], ["--n_times", "3"]],
                         ids=["final-state", "time-conditioned"])
def test_fno_line_has_jax_keys(port, capsys, extra):
    """``fno`` at 9^2: the JAX CLI's keys and value types, the same
    configuration values (the nt bump of --n_times included), finite
    losses; the numbers differ, since the two packages' generators draw
    other problems and weights. The saved parameters load in the JAX
    package."""
    from airpollution_tpu.io.checkpoint import load_pytree
    from airpollution_tpu.models import fno as jfno

    argv = ["fno", "--mesh_size", "9", "--nt", "9", "--n_train", "6",
            "--n_test", "3", "--modes", "2", "--width", "4", "--depth", "1",
            "--epochs", "4", "--batch", "3", *extra]
    want = _jax_line(argv, capsys)
    got, (params, losses) = port(argv + ["--save", "p.npz"])
    assert list(got) == list(want)
    for key, w in want.items():
        assert type(got[key]) is type(w), key
        if not isinstance(w, float):
            assert got[key] == w, key
    assert got["nt"] == (10 if extra else 9)
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all())
    assert got["loss_first"] == float(losses[0])
    like = jfno.init_fno_params(jax.random.PRNGKey(0), in_ch=7 if extra
                                else 6, modes=2, width=4, depth=1)
    loaded = load_pytree("p.npz", like)
    for a, b in zip(loaded, params):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
