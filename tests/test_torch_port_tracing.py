"""The port's tracing (``utils/profiling.py``): off, a span is one shared
null context and nothing is recorded; on, the phases of
``CRBESolver.solve`` nest as the benchmark's readers expect, all with the
solve's id, and leave the fields bit for bit as they were; a kernel sums
its launches' host time only while tracing is on; ``profiler_trace``
writes the ``apt.`` spans into its trace."""

import contextlib
import ctypes
import json

import pytest

torch = pytest.importorskip("torch")

import airpollution_tpu_torch as tapt  # noqa: E402
from airpollution_tpu_torch import _build  # noqa: E402
from airpollution_tpu_torch.models.crbe import CRBESolver  # noqa: E402
from airpollution_tpu_torch.ops import fused_hbm  # noqa: E402
from airpollution_tpu_torch.utils import profiling  # noqa: E402

F32 = torch.float32
MS, NT = 12, 12


@pytest.fixture
def fresh():
    """Nothing recorded, before and after the test."""
    assert not profiling.is_on()
    profiling.reset()
    yield
    profiling.reset()


def test_off_span_is_the_shared_null_context(fresh):
    a, b = profiling.span("crbe.solve", solve=True), profiling.span("x")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        profiling.count("guard_chunks")
    assert profiling.snapshot() == {"spans": {}, "counters": {},
                                    "kernels": {}}
    assert profiling.records() == []


def test_nested_spans_self_time_and_solve_ids(fresh):
    with profiling.tracing():
        for _ in range(2):
            with profiling.span("crbe.solve", solve=True):
                with profiling.span("fused.steps"):
                    with profiling.span("fused.guard"):
                        profiling.count("guard_chunks", 2)
        with profiling.span("outside"):
            pass
    assert not profiling.is_on()
    recs = profiling.records()
    assert [(r.name, r.parent) for r in recs[:3]] == [
        ("fused.guard", "fused.steps"), ("fused.steps", "crbe.solve"),
        ("crbe.solve", None)]
    ids = [r.solve_id for r in recs]
    assert ids[:3] == [ids[0]] * 3 and ids[3:6] == [ids[0] + 1] * 3
    assert ids[6] is None
    snap = profiling.snapshot()
    assert snap["counters"] == {"guard_chunks": 4}
    spans = snap["spans"]
    assert {n: s["calls"] for n, s in spans.items()} == {
        "crbe.solve": 2, "fused.steps": 2, "fused.guard": 2, "outside": 1}
    for name, child in (("crbe.solve", "fused.steps"),
                        ("fused.steps", "fused.guard")):
        s = spans[name]
        assert s["self_ns"] == s["total_ns"] - spans[child]["total_ns"]
    assert spans["fused.guard"]["self_ns"] == spans["fused.guard"][
        "total_ns"]


def _solver(operator):
    md = tapt.MeshData(tapt.create_mesh(MS, 20.0), tapt.Domain(), nt=NT,
                       dtype=F32, device="cpu")
    return CRBESolver(tapt.Domain(), tapt.Problem(), md,
                      matvec_impl="fused_hbm", fused_operator=operator,
                      solver_method="chebyshev", chebyshev_iters=4,
                      extrapolate_warm_start=True, device="cpu")


@pytest.mark.parametrize("operator, kernel",
                         [("uniform", "B2"), ("canvas", "B4")])
def test_fused_hbm_solve_phases(fresh, operator, kernel):
    plain = _solver(operator)
    want = [plain.solve(store_solutions=False) for _ in range(2)]
    traced = _solver(operator)
    got, snaps, recs = [], [], []
    for _ in range(2):
        profiling.reset()
        with profiling.tracing():
            got.append(traced.solve(store_solutions=False))
        snaps.append(profiling.snapshot())
        recs.append(profiling.records())
    assert traced.fused_kernel == kernel
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    chunks = (NT - 1) // fused_hbm.guard_stride(NT - 1)
    first, second = snaps
    assert {"crbe.assemble", "crbe.interval", "crbe.solve_fn"} <= set(
        first["spans"])
    assert first["counters"]["solve_fn_builds"] == 1
    assert not {"crbe.assemble", "crbe.interval", "crbe.solve_fn"} & set(
        second["spans"])
    assert "solve_fn_builds" not in second["counters"]
    for snap, rec in zip(snaps, recs):
        assert snap["counters"]["guard_chunks"] == chunks
        calls = {n: s["calls"] for n, s in snap["spans"].items()}
        assert calls["crbe.solve"] == 1 and calls["fused.guard"] == chunks
        parent = {r.name: r.parent for r in rec}
        assert parent["crbe.solve"] is None
        for name in ("crbe.prepare", "fused.operator", "fused.steps",
                     "crbe.lift", "crbe.sync"):
            assert parent[name] == "crbe.solve", name
        assert parent["fused.guard"] == "fused.steps"
        assert len({r.solve_id for r in rec}) == 1
    assert recs[1][0].solve_id == recs[0][0].solve_id + 1
    assert "crbe.guard_read" in first["spans"]
    assert "crbe.guard_read" not in second["spans"]


class _FakeLib:
    def __init__(self):
        self.crbe_error_string = lambda err: b"injected"

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_host_ns_only_while_tracing(fresh):
    k = _build.Kernel("fake_traced", "fake.cu", {F32: "f32_sym"}, [])
    k._lib = _FakeLib()
    k.launch(F32, 1)
    assert k.launches == 1 and k.host_ns == 0
    with profiling.tracing():
        k.launch(F32, 1)
        k.launch(F32, 2)
    assert k.launches == 3 and k.host_ns > 0
    held = k.host_ns
    k.launch(F32, 3)
    assert k.host_ns == held
    snap = profiling.snapshot()["kernels"]["fake_traced"]
    assert snap == {"launches": 4, "host_ns": held}
    profiling.reset()
    assert k.host_ns == 0 and "fake_traced" not in profiling.snapshot()[
        "kernels"]
    k.launches = 0  # as a caller that counts its own run does
    k.launch(F32, 4)
    assert profiling.snapshot()["kernels"]["fake_traced"] == {
        "launches": 1, "host_ns": 0}


def test_kernel_load_span_and_counters(fresh, monkeypatch):
    built = []
    monkeypatch.setattr(_build, "build", lambda sources: built.append(
        sources))
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _FakeLib())
    k = _build.Kernel("fake_load", "fake.cu", {F32: "f32_sym"}, [])
    with profiling.tracing():
        k.launch(F32)
        k.launch(F32)
    snap = profiling.snapshot()
    assert built == [["fake.cu"]]
    assert snap["spans"]["kernel.load"]["calls"] == 1
    assert snap["counters"] == {"kernel_loads": 1}


def test_profiler_trace_holds_apt_spans(fresh, tmp_path):
    with profiling.profiler_trace(str(tmp_path)):
        assert profiling.is_on()
        with profiling.span("crbe.prepare"):
            torch.ones(4).sum()
    assert not profiling.is_on()
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "apt.crbe.prepare" in names
