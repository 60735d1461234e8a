"""CPU tests of the benchmark harness: every cell resolves to its files, a
cell added as files runs with no code edit, the frozen work counts, the
result line, the trace reduction and the check for JAX."""

import ast
import json
import re
import time
from pathlib import Path

import pytest
import torch

from bench_copy import ROOT, cells, tiny, tiny_cells, tiny_copy  # noqa: F401
from portbench import harness, registry, trace, work
from portbench import run as run_mod

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", cells())
def test_cell_resolves_to_its_files(cell):
    entry, mix, config = registry.resolve(BENCH, cell)
    assert config["name"] == entry["config"]
    assert (ROOT / "portbench" / "traffic" / f"{mix['kind']}.py").exists()
    assert (ROOT / "portbench" / "reference"
            / f"{config['reference']}.py").exists()
    for m in registry.metrics_of(BENCH, cell, False) + \
            registry.metrics_of(BENCH, cell, True):
        reader = registry.load_module("metrics", m["name"])
        assert reader.UNIT == m["unit"] and reader.BETTER == m["better"]
        assert reader.SOURCE == m["source"]
        if "layer" in m:
            assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
    # Every per-layer metric's cells report the metric it moves.
    reported = {m["name"] for m in registry.metrics_of(BENCH, cell, False)}
    for m in registry.metrics_of(BENCH, cell, True):
        assert m["moves"] in reported


def test_frozen_work_counts_at_257():
    dofs = work.structured_dofs(257)
    assert dofs == 197_120
    b1 = work.forecast_work("uniform", "chebyshev", 4, 1, True, dofs, 1000,
                            "float32")
    b5 = work.forecast_work("canvas", "bicgstab", 5, 1, True, dofs, 1000,
                            "float32")
    assert b1["bound"] == b5["bound"] == "operations"
    assert round(b1["least_s"] * 1e3, 4) == 0.1677
    assert round(b5["least_s"] * 1e3, 3) == 0.630
    big = work.structured_dofs(1025)
    assert big == 3_147_776
    b2 = work.forecast_work("uniform", "chebyshev", 8, 1, True, big, 1000,
                            "float32")
    b4 = work.forecast_work("canvas", "chebyshev", 14, 1, True, big, 1000,
                            "float32")
    b4_k8 = work.forecast_work("canvas", "chebyshev", 8, 1, True, big, 1000,
                               "float32")
    assert b2["bound"] == b4["bound"] == b4_k8["bound"] == "operations"
    assert round(b2["least_s"] * 1e6 / 1000, 2) == 5.31
    assert round(b4["least_s"] * 1e6 / 1000, 2) == 9.96
    # The per-DOF operator at the uniform cell's k: 122 flops a DOF.
    assert work.flops_per_dof("canvas", "chebyshev", 8, 1, True) == 122
    assert round(b4_k8["least_s"] * 1e6 / 1000, 2) == 5.73


def _run(base, bench, cell, trace_on=False, seconds=0.3):
    return harness.run(cell, 2**31 + 99, seconds, trace_on, device="cpu",
                       t_start=time.perf_counter(), bench=bench, base=base)


def test_dropped_workload_file_is_found_by_name(tmp_path):
    bench = tiny_copy(tmp_path, {"points_per_side": 9, "nt": 41,
                                 "traced_requests": 1})
    base = tmp_path / "portbench"
    mix = json.loads((base / "workloads" / "tiny.paper-plume.257.json")
                     .read_text())
    mix["traffic"] = "closed.9-new"
    (base / "workloads" / "paper-plume.new.json").write_text(json.dumps(mix))
    bench["workloads"].append({"name": "paper-plume.new",
                               "config": "paper-plume",
                               "traffic": "closed.9-new", "chips": 1,
                               "why": "a cell added as files only"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.benchmark(tmp_path / "BENCHMARK.json")
    result = _run(base, bench, "paper-plume.new")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"steps_per_s", "solve_p90_ms",
                                      "setup_s"}


@pytest.mark.parametrize("cell", tiny_cells())
def test_last_line_keys(tiny, cell):
    base, bench = tiny
    result = _run(base, bench, f"tiny.{cell}")
    assert list(result) == RESULT_KEYS + ["checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"steps_per_s", "solve_p90_ms",
                                      "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["checks"]) == {"max_gap_rel", "failed_requests"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_has_breakdown(tiny, monkeypatch):
    base, bench = tiny
    fake = {"requests": 2, "window_s": 0.5, "busy_s": 0.4, "kernels": 40,
            "device_ops": [["k", 0.4]], "idle_gaps": [["solve (3 gaps)", 0.1]]}
    monkeypatch.setattr(harness.trace_mod, "summarize", lambda *a: fake)
    result = _run(base, bench, "tiny.paper-plume.257", trace_on=True)
    assert list(result) == RESULT_KEYS + ["breakdown", "checks"]
    assert result["device"]["busy_s"] == 0.4
    assert result["device"]["window_s"] == 0.5
    metrics = result["metrics"]
    assert set(metrics) == {m["name"] for m in BENCH["per_layer"]}
    steps = 2 * 40
    assert metrics["kernels_per_step"]["value"] == pytest.approx(40 / steps)
    assert metrics["device_idle_pct"]["value"] == pytest.approx(20.0)
    assert metrics["step_mfu_pct"]["value"] < metrics["kernel_roofline"][
        "value"]


def test_trace_summary_intervals():
    ops = [("k1", "kernel", 100, 200), ("k1", "kernel", 250, 300),
           ("Memcpy DtoH", "memcpy", 290, 320), ("k2", "kernel", 10, 20)]
    spans = [("request", 50, 400), ("solve", 60, 310), ("copy_out", 310, 400)]
    s = trace.summarize(ops, spans)
    assert s["requests"] == 1 and s["kernels"] == 2
    assert s["busy_s"] == pytest.approx((100 + 70) / 1e9)
    assert s["window_s"] == pytest.approx(350 / 1e9)
    assert s["device_ops"][0] == ["k1", pytest.approx(150 / 1e9)]
    gaps = dict(s["idle_gaps"])
    assert gaps["solve (2 gaps)"] == pytest.approx((50 + 50) / 1e9)
    assert gaps["copy_out (1 gaps)"] == pytest.approx(80 / 1e9)
    assert trace.summarize(ops, []) is None


class _Event:
    """A profiler event as the card's profiler gives it: name, device type,
    times; no activity type."""

    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e


def test_raw_events_sort_device_ops_from_spans():
    from torch.autograd import DeviceType

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [
                        _Event("portbench.request", DeviceType.CPU, 0, 90),
                        _Event("portbench.request", DeviceType.CUDA, 1, 80),
                        _Event("aten::add", DeviceType.CPU, 5, 6),
                        _Event("cudaLaunchKernel", DeviceType.CPU, 6, 7),
                        _Event("uniform_step_kernel", DeviceType.CUDA, 10, 40),
                        _Event("Memcpy DtoH (Device -> Pageable)",
                               DeviceType.CUDA, 50, 60),
                        _Event("Memset (Device)", DeviceType.CUDA, 61, 62)]

    ops, spans = trace.raw_events(Prof)
    assert spans == [("request", 0, 90)]
    assert [(n, k) for n, k, _, _ in ops] == [
        ("uniform_step_kernel", "kernel"),
        ("Memcpy DtoH (Device -> Pageable)", "memcpy"),
        ("Memset (Device)", "memset")]


def test_forbidden_modules_compare_top_level_names_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "airpollution_tpu", "airpollution_tpu.models.crbe",
              "airpollution_tpu_torch", "airpollution_tpu_torch.models",
              "jaxtyping", "numpy"]
    assert harness.forbidden_modules(loaded) == [
        "airpollution_tpu", "airpollution_tpu.models.crbe", "flax.linen",
        "jax", "jax.numpy", "jaxlib.xla_client"]
    assert harness.forbidden_modules(["airpollution_tpu_torch"]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_either_package():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        names = set(_imports(path))
        assert names <= {"__future__", "math", "torch", "numpy"}, path


def test_harness_imports_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, path


def test_run_without_a_card_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", cells()[0], "--seed", str(2**31 + 5),
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
