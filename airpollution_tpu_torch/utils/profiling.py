"""Profiling and memory tracking for the experiment drivers.

The JAX package's ``utils/profiling.py`` on PyTorch: a wall-clock
:class:`Timer`, the process's resident memory, the card's allocated
memory (``torch.cuda.memory_allocated``, the counterpart of XLA's
``bytes_in_use``), a :func:`memory_delta` span with the drivers' two
memory columns, and :func:`profiler_trace`, a ``torch.profiler`` span
that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import resource
import time

import torch


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
    card, written on exit as a Chrome trace
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
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
