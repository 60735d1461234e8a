"""The port's ``fit-ic``, ``fit-deposition`` and ``fit-exchange``
subcommands (airpollution_tpu_torch/cli.py) on the CPU
(``APT_PLATFORM=cpu``): their JSON lines against the JAX CLI's on the same
saved trajectory (float32 fits in both packages: the numbers to
CLI_RTOL), the recovered field saved by ``fit-ic --save``, the sensor
network, and the errors of a bad invocation."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from airpollution_tpu import cli as j_cli  # noqa: E402

from airpollution_tpu_torch import cli as t_cli  # noqa: E402
from airpollution_tpu_torch.io.checkpoint import (  # noqa: E402
    load_field,
    save_field,
)

from torch_port_helpers import one_torch_thread  # noqa: E402,F401

CLI_RTOL = 1e-5  # float32 fits in two packages


def _line(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("APT_PLATFORM", "cpu")
    return tmp_path


def _compare(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _compare(g, w)
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=CLI_RTOL), key
        else:
            assert g == w, key


PULSE = ["--problem", "square_pulse", "--v", "0", "0", "--D", "1.0"]


def _exchange_trajectory():
    """The JAX CLI test's exchange twin (8^2, nt=9, a right wall with
    v_d 0.5 and c_comp 0.1), made with the port's solve (the g of a
    compensation point is not a CLI flag)."""
    import airpollution_tpu_torch as tapt
    from airpollution_tpu_torch.diagnostics import inverse

    md = tapt.MeshData(tapt.create_mesh(8, 20.0), tapt.Domain(), nt=9,
                       device="cpu")
    p = tapt.SquarePulseProblem(v=(0.0, 0.0), D=1.0)
    p.robin_sides = {"right": 0.5}
    obs = inverse.solve_snapshots(p, md,
                                  robin_g_const={"right": 0.5 * 0.1})
    save_field("exch.npz", obs, times=md.time_discr)


@pytest.mark.parametrize("cmd", ["fit-ic", "fit-deposition",
                                 "fit-exchange"])
def test_fit_lines_match_jax(workdir, cmd):
    """Five Adam steps through each subcommand, from the same saved
    trajectory in both packages: the same keys and numbers, and a falling
    misfit."""
    if cmd == "fit-ic":
        t_cli.main(["solve", "--mesh_size", "10", "--nt", "9", "--sigma",
                    "2.0", "--save", "traj.npz", "--save_all"])
        argv = ["fit-ic", "--mesh_size", "10", "--nt", "9", "--sigma",
                "2.0", "--observed", "traj.npz", "--steps", "5", "--lr",
                "0.002", "--smoothness", "1e-4"]
    elif cmd == "fit-deposition":
        t_cli.main(["solve", "--mesh_size", "8", "--nt", "9", *PULSE,
                    "--robin", "right=0.5,top=0.5", "--save", "dep.npz",
                    "--save_all"])
        argv = ["fit-deposition", "--mesh_size", "8", "--nt", "9", *PULSE,
                "--robin", "right=0.5,top=0.5", "--observed", "dep.npz",
                "--alpha0", "0.2", "--steps", "5", "--lr", "0.1"]
    else:
        _exchange_trajectory()
        argv = ["fit-exchange", "--mesh_size", "8", "--nt", "9", *PULSE,
                "--robin", "right=0.5", "--observed", "exch.npz",
                "--alpha0", "0.2", "--c_comp0", "0.05", "--steps", "5",
                "--lr", "0.05"]
    want = _line(j_cli.main, argv)
    got = _line(t_cli.main, argv)
    _compare(got, want)
    assert got["steps"] == 5 and got["n_snapshots"] == 8
    assert got["misfit_last"] < got["misfit_first"]


def test_fit_ic_sensors_nonnegative_and_save(workdir):
    """``--sensors`` draws the JAX CLI's stations, ``--nonnegative`` keeps
    the field >= 0, ``--save`` writes the (n_dofs,) estimate."""
    t_cli.main(["solve", "--mesh_size", "8", "--nt", "7", "--sigma", "2.0",
                "--save", "traj.npz", "--save_all"])
    line = _line(t_cli.main, [
        "fit-ic", "--mesh_size", "8", "--nt", "7", "--sigma", "2.0",
        "--observed", "traj.npz", "--sensors", "40", "--steps", "3",
        "--lr", "0.01", "--nonnegative", "--save", "u0.npz"])
    assert line["method"] == "fit_ic" and line["n_sensors"] == 40
    assert line["n_snapshots"] == 6 and np.isfinite(
        line["rel_l2_vs_problem_ic"])
    u0, times = load_field("u0.npz")
    assert u0.shape == (line["n_dofs"],) and times is None
    assert (u0 >= 0).all()


def test_fit_subcommands_reject_bad_input(workdir):
    t_cli.main(["solve", "--mesh_size", "6", "--nt", "5", "--save",
                "final.npz"])
    with pytest.raises(SystemExit, match="trajectory"):
        t_cli.main(["fit-ic", "--mesh_size", "6", "--nt", "5",
                    "--observed", "final.npz"])
    with pytest.raises(SystemExit, match="trajectory"):
        t_cli.main(["fit-exchange", "--mesh_size", "6", "--nt", "5",
                    "--robin", "right=0.5", "--observed", "final.npz"])
    with pytest.raises(SystemExit, match="--robin"):
        t_cli.main(["fit-deposition", "--mesh_size", "6", "--nt", "5",
                    "--robin", "", "--observed", "final.npz"])
