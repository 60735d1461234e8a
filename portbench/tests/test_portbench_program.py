"""CPU tests of the reading of the port's own spans and counters: the
trace reduction by program span (idle gaps, device operations joined to
their runtime calls by correlation id), the four readers, the phases tool
on a tiny cell, and that a benchmark run never switches the port's
tracing on."""

import time

import pytest
from torch.autograd import DeviceType

from bench_copy import tiny  # noqa: F401
from portbench import harness, phases, program, registry


class _Event:
    """A profiler event: name, device type, times, activity type and
    correlation id."""

    def __init__(self, name, device, start, end, activity, corr=0):
        self._n, self._d, self._s, self._e = name, device, start, end
        self._a, self._c = activity, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def activity_type(self):
        return self._a

    def correlation_id(self):
        return self._c


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA

#: One request: the harness's solve holds crbe.solve, which holds
#: crbe.prepare (an upload) and fused.steps (two launches, a gap between).
EVENTS = [
    _Event("portbench.request", CPU, 0, 1000, "user_annotation", 1),
    _Event("portbench.solve", CPU, 10, 900, "user_annotation", 2),
    _Event("portbench.copy_out", CPU, 900, 1000, "user_annotation", 3),
    _Event("apt.crbe.solve", CPU, 20, 880, "user_annotation", 4),
    _Event("apt.crbe.prepare", CPU, 30, 200, "user_annotation", 5),
    _Event("apt.fused.steps", CPU, 200, 860, "user_annotation", 6),
    _Event("apt.fused.steps", CUDA, 210, 850, "gpu_user_annotation", 6),
    _Event("aten::copy_", CPU, 40, 60, "cpu_op", 77),
    _Event("cudaMemcpyAsync", CPU, 50, 55, "cuda_runtime", 77),
    _Event("cudaLaunchKernel", CPU, 210, 215, "cuda_runtime", 501),
    _Event("cudaLaunchKernel", CPU, 600, 605, "cuda_runtime", 502),
    _Event("Memcpy HtoD (Pageable -> Device)", CUDA, 100, 300, "gpu_memcpy",
           77),
    _Event("uniform_step_kernel", CUDA, 300, 500, "kernel", 501),
    _Event("uniform_step_kernel", CUDA, 650, 850, "kernel", 502),
    _Event("Memcpy DtoH (Device -> Pageable)", CUDA, 920, 980, "gpu_memcpy",
           900),
]


def test_raw_events_sort_the_port_spans_and_runtime_calls():
    raw = program.raw_events(EVENTS)
    assert raw["spans"] == [("request", 0, 1000), ("solve", 10, 900),
                            ("copy_out", 900, 1000)]
    assert [n for n, _, _ in raw["program"]] == [
        "crbe.solve", "crbe.prepare", "fused.steps"]
    assert [(n, k, c) for n, k, _, _, c in raw["ops"]] == [
        ("Memcpy HtoD (Pageable -> Device)", "memcpy", 77),
        ("uniform_step_kernel", "kernel", 501),
        ("uniform_step_kernel", "kernel", 502),
        ("Memcpy DtoH (Device -> Pageable)", "memcpy", 900)]
    assert raw["calls"] == {77: 50, 501: 210, 502: 600}


def test_summary_labels_gaps_and_joins_ops_by_correlation():
    s = program.summarize(program.raw_events(EVENTS))
    # trace.summarize's own keys, as it computes them.
    assert s["requests"] == 1 and s["kernels"] == 2
    assert s["busy_s"] == pytest.approx((400 + 200 + 60) / 1e9)
    gaps = dict(s["idle_gaps"])
    assert gaps["apt.crbe.prepare (1 gaps)"] == pytest.approx(100 / 1e9)
    assert gaps["apt.fused.steps (1 gaps)"] == pytest.approx(150 / 1e9)
    assert gaps["solve (1 gaps)"] == pytest.approx(70 / 1e9)
    assert gaps["copy_out (1 gaps)"] == pytest.approx(20 / 1e9)
    by = {(label, op): sec for label, op, sec in s["device_by_span"]}
    assert by[("apt.crbe.prepare", "Memcpy HtoD (Pageable -> Device)")] \
        == pytest.approx(200 / 1e9)
    assert by[("apt.fused.steps", "uniform_step_kernel")] == pytest.approx(
        400 / 1e9)
    assert by[("unjoined", "Memcpy DtoH (Device -> Pageable)")] == \
        pytest.approx(60 / 1e9)
    assert s["joined"] == pytest.approx(3 / 4)
    prog = s["program"]
    assert prog["crbe.solve"]["calls"] == 1
    assert prog["crbe.solve"]["host_s"] == pytest.approx(860 / 1e9)
    assert prog["crbe.solve"]["self_s"] == pytest.approx(
        (860 - 170 - 660) / 1e9)
    assert prog["crbe.solve"]["device_s"] == 0.0
    assert prog["crbe.prepare"]["device_s"] == pytest.approx(200 / 1e9)
    assert prog["fused.steps"]["device_s"] == pytest.approx(400 / 1e9)
    assert program.summarize({"ops": [], "spans": [], "program": [],
                              "calls": {}}) is None


def _ctx():
    snap = {"spans": {"crbe.assemble": {"calls": 1, "total_ns": 2_500_000_000,
                                        "self_ns": 2_500_000_000},
                      "crbe.interval": {"calls": 1, "total_ns": 750_000_000,
                                        "self_ns": 750_000_000}},
            "counters": {}, "kernels": {}}
    window = {"spans": {}, "counters": {"guard_chunks": 40},
              "kernels": {"uniform_step": {"launches": 2000,
                                           "host_ns": 30_000_000},
                          "other": {"launches": 0, "host_ns": 0}}}
    trace = {"requests": 2,
             "program": {"crbe.prepare": {"host_s": 0.001},
                         "fused.operator": {"host_s": 0.003}}}
    return {"trace": trace, "program": {"setup": snap, "window": window}}


READS = {"request_prep_ms": 2.0, "launch_host_us": 15.0,
         "assembly_setup_s": 2.5, "interval_setup_s": 0.75}


@pytest.mark.parametrize("name", sorted(READS))
def test_readers_of_the_port_spans(name):
    reader = registry.load_module("metrics", name)
    assert reader.read(_ctx()) == pytest.approx(READS[name])
    assert reader.read({"trace": None}) is None
    assert reader.read({"trace": {"requests": 2, "program": {}},
                        "program": {"setup": {"spans": {}},
                                    "window": {"kernels": {}}}}) is None


def test_phases_on_a_tiny_cell(tiny):  # noqa: F811
    base, bench = tiny
    r = phases.run("tiny.paper-plume.1025", 2**31 + 7, 0.2, 1, "cpu",
                   bench=bench, base=base)
    m = r["metrics"]
    assert m["request_prep_ms"] > 0 and m["assembly_setup_s"] > 0
    assert m["interval_setup_s"] > 0
    assert m["launch_host_us"] is None  # no kernel runs on the CPU
    mix = registry.load_json("workloads", "tiny.paper-plume.1025", base)
    chunks = 40 // 40  # guard_stride(40) is 40: one chunk a request
    assert r["window_counters"] == {
        "kernel_builds": 0, "kernel_loads": 0, "solve_fn_builds": 0,
        "guard_chunks": chunks * mix["traced_requests"]}
    assert r["on_equals_off"] is True
    assert r["trace"]["program"]["crbe.solve"]["calls"] == mix[
        "traced_requests"]
    assert "crbe.assemble" in r["setup_snapshot"]["spans"]


@pytest.mark.parametrize("trace_on", [False, True])
def test_benchmark_run_leaves_the_port_tracing_off(tiny,  # noqa: F811
                                                    trace_on):
    """Nothing is recorded: no span of the port's ran with tracing on."""
    from airpollution_tpu_torch.utils import profiling

    base, bench = tiny
    profiling.reset()
    harness.run("tiny.paper-plume.257", 2**31 + 11, 0.2, trace_on,
                device="cpu", t_start=time.perf_counter(), bench=bench,
                base=base)
    assert not profiling.is_on()
    assert profiling.snapshot() == {"spans": {}, "counters": {},
                                    "kernels": {}}
