"""Profiling and memory tracking for the experiment drivers.

The JAX package's ``utils/profiling.py`` on PyTorch: a wall-clock
:class:`Timer`, the process's resident memory, the card's allocated
memory (``torch.cuda.memory_allocated``, the counterpart of XLA's
``bytes_in_use``), a :func:`memory_delta` span with the drivers' two
memory columns, and :func:`profiler_trace`, a ``torch.profiler`` span
that writes a Chrome trace.

The port's own tracing: :func:`span` names a phase of the program and
:func:`count` counts an event in it. Both do nothing until tracing is
switched on (:func:`tracing`); then each span is also a
``torch.profiler.record_function`` range named ``apt.<name>``, on the
profiler's clock beside the device's operations, and :func:`snapshot`
sums what was recorded since :func:`reset`: calls, total and self ns per
span name, every counter, and the launches and host ns of every CUDA
kernel (``_build.Kernel``). The spans of one ``CRBESolver.solve`` share
its solve id. Tracing is process-wide and meant for one thread.
"""

from __future__ import annotations

import contextlib
import os
import resource
import time
import weakref
from collections import defaultdict
from typing import NamedTuple

import torch

#: The prefix of the port's spans among the profiler's events.
PREFIX = "apt."


def get_cpu_memory_mb() -> float:
    """Process RSS in MB: psutil's reading where psutil is installed,
    else the resident pages of ``/proc/self/statm``."""
    try:
        import psutil
    except ImportError:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * resource.getpagesize() / 1e6
    return psutil.Process().memory_info().rss / 1e6


def get_device_memory_mb(device=None) -> float:
    """Bytes the caching allocator holds in tensors on the card, in MB.
    ``device`` defaults to the current CUDA device; a CPU device reads
    0.0, because the caller asked for the CPU and there is no card
    memory to count."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to read "
                "no card memory")
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    return torch.cuda.memory_allocated(device) / 1e6


class Timer:
    """Wall-clock span with a throughput helper."""

    def __init__(self):
        self.elapsed = 0.0
        self._start = None

    def __enter__(self):
        self._start = time.time()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.time() - self._start
        return False

    def rate(self, n: int) -> float:
        return n / self.elapsed if self.elapsed > 0 else float("inf")


@contextlib.contextmanager
def memory_delta(device=None):
    """Yields a dict filled on exit with the CPU and card memory deltas in
    MB (``cpu_memory_usage_MB``, ``gpu_memory_usage_MB``; the card's is
    at least 0). On the card the span ends with a synchronisation, so
    that the allocator's reading includes the work queued in it."""
    out = {"cpu_memory_usage_MB": 0.0, "gpu_memory_usage_MB": 0.0}
    cpu0 = get_cpu_memory_mb()
    dev0 = get_device_memory_mb(device)
    try:
        yield out
    finally:
        if device is None or torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        out["cpu_memory_usage_MB"] = get_cpu_memory_mb() - cpu0
        out["gpu_memory_usage_MB"] = max(
            0.0, get_device_memory_mb(device) - dev0)


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """A ``torch.profiler`` span over the CPU and, where present, the
    card, with the port's tracing on inside it (so the trace holds its
    ``apt.<name>`` spans), written on exit as a Chrome trace
    ``<log_dir>/trace_<pid>_<ns>.json``. An empty ``log_dir`` profiles
    nothing."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, tracing():
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class SpanRecord(NamedTuple):
    """One closed span: times in ns on the profiler's clock (Unix time),
    its own ns (the total less its child spans'), the name of the span
    that held it (None at the top) and the id of the solve it belongs to
    (None outside every solve)."""

    name: str
    start_ns: int
    end_ns: int
    self_ns: int
    parent: str | None
    solve_id: int | None


class _State:
    on = False
    records: list[SpanRecord] = []
    counters: defaultdict = defaultdict(int)
    stack: list = []  # open spans: [name, start_ns, child_ns, solve_id]
    solves = 0
    kernels: weakref.WeakSet = weakref.WeakSet()
    launch_base: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "solve", "_rf")

    def __init__(self, name: str, solve: bool):
        self.name = name
        self.solve = solve
        self._rf = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        if self.solve:
            _State.solves += 1
            solve_id = _State.solves
        else:
            solve_id = _State.stack[-1][3] if _State.stack else None
        self._rf.__enter__()
        _State.stack.append([self.name, time.time_ns(), 0, solve_id])
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._rf.__exit__(*exc)
        name, start, child, solve_id = _State.stack.pop()
        parent = _State.stack[-1] if _State.stack else None
        if parent is not None:
            parent[2] += end - start
        _State.records.append(SpanRecord(
            name, start, end, end - start - child,
            None if parent is None else parent[0], solve_id))
        return False


def span(name: str, *, solve: bool = False):
    """A phase of the program named ``name``. Off, the one shared null
    context; on, a ``record_function("apt.<name>")`` range that is also
    recorded in memory. ``solve=True`` opens a new solve id, which every
    span inside it shares."""
    if not _State.on:
        return _NULL
    return _Span(name, solve)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _State.on:
        _State.counters[name] += n


def is_on() -> bool:
    return _State.on


@contextlib.contextmanager
def tracing(on: bool = True):
    """Tracing switched to ``on`` inside the block, and back after it."""
    was = _State.on
    _State.on = on
    try:
        yield
    finally:
        _State.on = was


def track_kernel(kernel) -> None:
    """Watch a kernel's ``launches`` and ``host_ns`` for :func:`snapshot`
    (each ``_build.Kernel`` calls this for itself)."""
    _State.kernels.add(kernel)
    _State.launch_base[kernel] = kernel.launches


def reset() -> None:
    """Forget every span and counter recorded, and count the kernels'
    launches and host ns from here."""
    _State.records.clear()
    _State.counters.clear()
    for k in _State.kernels:
        k.host_ns = 0
        _State.launch_base[k] = k.launches


def records() -> list[SpanRecord]:
    """Every span closed since :func:`reset`, in the order they closed."""
    return list(_State.records)


def snapshot() -> dict:
    """What was recorded since :func:`reset`: ``spans`` (per name: calls,
    total_ns, self_ns), ``counters``, and ``kernels`` (per kernel name
    that launched: launches, host_ns)."""
    spans = {}
    for r in _State.records:
        s = spans.setdefault(r.name,
                             {"calls": 0, "total_ns": 0, "self_ns": 0})
        s["calls"] += 1
        s["total_ns"] += r.end_ns - r.start_ns
        s["self_ns"] += r.self_ns
    kernels = {}
    for k in _State.kernels:
        n = k.launches - _State.launch_base.get(k, 0)
        if n < 0:  # its caller set ``launches`` back to 0 since
            n = k.launches
        if n or k.host_ns:
            s = kernels.setdefault(k.name, {"launches": 0, "host_ns": 0})
            s["launches"] += n
            s["host_ns"] += k.host_ns
    return {"spans": spans, "counters": dict(_State.counters),
            "kernels": kernels}
