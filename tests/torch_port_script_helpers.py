"""Shared set-up of the script parity tests (tests/test_torch_port_scripts_*.py):
loading a script of either package as a module, float64 mesh data for
the JAX scripts that run float32, solver capture, and the comparison of
a row of figures."""

import csv
import functools
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp

import airpollution_tpu as japt

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-9


def load_script(name):
    """``scripts/<name>`` as a fresh module (a JAX script's module-level
    configuration runs once per load)."""
    spec = importlib.util.spec_from_file_location(
        f"_script_{name[:-3]}", REPO / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def f64_meshes(monkeypatch, jscript):
    """The JAX script's MeshData in float64 (it runs float32)."""
    monkeypatch.setattr(jscript.apt, "MeshData",
                        functools.partial(japt.MeshData, dtype=jnp.float64))


def quiet(monkeypatch, *scripts):
    for s in scripts:
        monkeypatch.setattr(s, "log", lambda *a: None)


def capture(monkeypatch, module, name, cls):
    """Record every instance of ``module.name`` (a solver class)."""
    made = []

    class Spy(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(module, name, Spy)
    return made


def run_jax_main(monkeypatch, jscript, argv):
    """A JAX script's ``main()``, which parses ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    return jscript.main()


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def assert_same_cells(got_path, want_path, skip=("platform",)):
    """Two CSV files with the same header and rows, cell for cell (the
    scripts round to the same places), the ``skip`` columns aside."""
    got, want = read_rows(got_path), read_rows(want_path)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k not in skip:
                assert g[k] == w[k], (k, g[k], w[k])


def assert_same_figures(got, want, skip=()):
    """Every key of the JAX row in the port's row, numbers within TOL
    (relative; the relative differences of two solves within TOL),
    timings aside."""
    for key, value in want.items():
        if key in skip or key.endswith(("_s", "_per_sec")) \
                or "speedup" in key:
            continue
        assert key in got, key
        if isinstance(value, (list, tuple)):
            np.testing.assert_allclose(got[key], value, rtol=TOL, atol=0)
        elif key.endswith("rel_maxdiff"):
            # A relative difference of two solves: held absolutely.
            assert abs(got[key] - value) <= TOL, key
        elif isinstance(value, float):
            assert got[key] == pytest.approx(value, rel=TOL, abs=1e-300), key
        else:
            assert got[key] == value, key
