"""Test helpers: a copy of the benchmark in a temporary directory, with a
tiny CPU cell beside each cell of ``BENCHMARK.json`` (the same
configuration, solver route and limit at a small mesh), which the harness
finds by name with no code edit; and tiny cells of routes that no cell
takes yet but a cell added as data files could (``EXTRA``)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"points_per_side": 17, "nt": 41, "traced_requests": 2}

#: Routes the reference covers beyond the cells: fixed-k BiCGStab on the
#: per-DOF operator (kernel B5's whole loop), derived from this cell.
EXTRA = {"paper-plume.257-bicgstab-canvas": (
    "paper-plume.257", {"fused_operator": "canvas", "matvec_impl": "fused",
                        "solver_method": "bicgstab", "fused_iters": 5,
                        "extrapolate_warm_start": True})}


def tiny_copy(dst: Path, sizes: dict) -> dict:
    """Copy ``portbench/`` and ``BENCHMARK.json`` to ``dst`` and add a cell
    ``tiny.<cell>`` per cell and per ``EXTRA`` route with the mix's
    ``sizes`` changed. Returns the copy's BENCHMARK object."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    plan = [(w["name"], w, None) for w in bench["workloads"]]
    plan += [(name, entries[cell], solver)
             for name, (cell, solver) in EXTRA.items()]
    for cell, w, solver in plan:
        mix = json.loads((ROOT / "portbench" / "workloads"
                          / f"{w['name']}.json").read_text())
        mix.update(sizes)
        if solver is not None:
            mix.update(solver=solver, traffic=f"{mix['traffic']}-{cell}")
            w = dict(w, traffic=mix["traffic"])
        name = f"tiny.{cell}"
        (dst / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(mix))
        bench["workloads"].append(dict(w, name=name))
        for m in bench["per_layer"] + bench["end_to_end"]:
            if w["name"] in m.get("workloads", ()):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """``(base, bench)``: the copy's ``portbench`` folder and its
    BENCHMARK object."""
    dst = tmp_path_factory.mktemp("bench")
    bench = tiny_copy(dst, TINY)
    return dst / "portbench", bench


def cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def tiny_cells():
    """The cells and the extra routes, each run as ``tiny.<name>``."""
    return cells() + list(EXTRA)
