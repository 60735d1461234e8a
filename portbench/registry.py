"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root names the cells, the
configurations and the metrics; each has files of its own under
``portbench/``, found by that name with no code edit:

- ``workloads/<cell>.json``: the cell's traffic mix (its configuration,
  its traffic name, the traffic kind that drives it and its parameters);
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<kind>.py``: the code that drives a kind of traffic;
- ``metrics/<metric>.py``: a metric's reader;
- ``reference/<name>.py``: a configuration's plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(path: Path | None = None) -> dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, base: Path | None = None) -> dict:
    return json.loads(((base or HERE) / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, base: Path | None = None):
    """The module ``<base>/<kind>/<name>.py`` (names may hold '.' or '-'),
    loaded once per process."""
    path = (base or HERE) / kind / f"{name}.py"
    key = f"portbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def resolve(bench: dict, cell: str, base: Path | None = None):
    """``(entry, mix, config)`` of ``cell``: its ``workloads`` entry in
    BENCHMARK.json, its mix file and its configuration file, checked to
    name the same configuration and traffic."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if cell not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
    entry = entries[cell]
    mix = load_json("workloads", cell, base)
    for key in ("config", "traffic"):
        if mix[key] != entry[key]:
            raise ValueError(f"workloads/{cell}.json names {key} "
                             f"{mix[key]!r}, BENCHMARK.json {entry[key]!r}")
    config = load_json("configs", entry["config"], base)
    return entry, mix, config


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones; a metric with a ``workloads`` key only
    in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell in m["workloads"]]
