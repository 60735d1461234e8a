"""Utilities of the port: wall-clock spans, memory readers and a
profiler trace (the names the JAX package's ``airpollution_tpu.utils``
exports, without its XLA compilation cache)."""

from airpollution_tpu_torch.utils.profiling import (
    Timer,
    get_cpu_memory_mb,
    get_device_memory_mb,
    memory_delta,
    profiler_trace,
)

__all__ = [
    "Timer",
    "get_cpu_memory_mb",
    "get_device_memory_mb",
    "memory_delta",
    "profiler_trace",
]
