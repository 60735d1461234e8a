"""One run of one cell: set-up, the measured window, the trace of a fixed
count of whole requests (``--trace 1``), the comparison that decides
``correct``, and the result line.

The end-to-end metrics are taken here, on the host's clock, around the
calls into the system: ``setup_s`` from process start to the window's
start, the rate over all the work and all the time of the window, the
latency percentile over all its requests.
"""

from __future__ import annotations

import gc
import random
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from contextlib import contextmanager

import torch

from portbench import registry, trace as trace_mod

#: Top-level module names that no run may load, compared whole: JAX and
#: the JAX package (the port's own name only begins with the latter's).
FORBIDDEN = ("jax", "jaxlib", "flax", "airpollution_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


class Spans:
    """Host-clock spans of the harness, summed by name; with ``annotate``
    each is also a ``portbench.<name>`` range for the profiler."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.seconds = defaultdict(float)

    @contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            with torch.profiler.record_function(trace_mod.SPAN_PREFIX + name):
                yield
        else:
            yield
        self.seconds[name] += time.perf_counter() - t0


def _profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


#: Answers of the window kept for the comparison after it, drawn uniformly
#: from the seed (besides the last one).
SAMPLE = 4


def measure(system, seconds: float, spans: Spans, traced: int, seed: int):
    """The window: requests back to back until ``seconds`` have passed
    (the last one ends past it). With ``traced`` > 0 the first ``traced``
    requests run under the profiler. Inside the window each answer is only
    kept or dropped (a reservoir of ``SAMPLE``, drawn from the seed); once
    it has closed, the kept answers and the last one are checked to be
    finite and handed on for the comparison. Returns the window's
    record."""
    pick = random.Random(seed)
    latencies, kept, last = [], [], None
    attempted = answered = 0
    first_error = None
    prof = _profiler() if traced else None
    summary = None
    start = time.perf_counter()
    if prof is not None:
        prof.start()
    while True:
        t0 = time.perf_counter()
        field = None
        try:
            with spans("request"):
                field = system.request()
        except Exception:  # a request that raises is a failed request
            if first_error is None:
                first_error = traceback.format_exc()
        t1 = time.perf_counter()
        attempted += 1
        latencies.append(t1 - t0)
        if field is not None:
            answered += 1
            last = field
            if len(kept) < SAMPLE:
                kept.append(field)
            else:
                j = pick.randrange(answered)
                if j < SAMPLE:
                    kept[j] = field
        if prof is not None and attempted == traced:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            summary = trace_mod.summarize(*trace_mod.raw_events(prof))
            prof = None
        if time.perf_counter() - start >= seconds:
            break
    end = time.perf_counter()
    if prof is not None:  # fewer requests than ``traced`` fitted
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        summary = trace_mod.summarize(*trace_mod.raw_events(prof))
    if first_error is not None:
        sys.stderr.write(f"first failed request:\n{first_error}")
    fields = kept + [last] if all(f is not last for f in kept) else kept
    not_finite = sum(not system.finite(f) for f in fields)
    return {"window_s": end - start, "latencies_s": latencies,
            "attempted": attempted,
            "failed": attempted - answered + not_finite,
            "completed": answered - not_finite, "fields": fields,
            "trace": summary}


def device_record(device, count: int, peak: int) -> dict:
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak}


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run(cell: str, seed: int, seconds: float, trace: bool, *, device,
        t_start: float, bench: dict | None = None, base=None) -> dict:
    """One run of ``cell``; returns the result object (the last line)."""
    bench = bench or registry.benchmark()
    entry, mix, config = registry.resolve(bench, cell, base)
    traffic = registry.load_module("traffic", mix["kind"], base)
    device = torch.device(device)
    spans = Spans(annotate=trace)
    spans.seconds["import"] = time.perf_counter() - t_start
    with spans("context"):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        torch.zeros(1, device=device).add_(1)
    system = traffic.setup(config, mix, seed, device, spans)
    if trace:  # the profiler's own start-up stays out of the window
        with _profiler():
            torch.zeros(1, device=device).add_(1)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    record = measure(system, seconds, spans,
                     mix["traced_requests"] if trace else 0, seed)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    # The program's state goes before the reference runs on the card.
    system.release_state()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = system.judge(record["fields"])
    checks["failed_requests"] = {"value": record["failed"], "limit": 0}
    correct = (record["completed"] > 0 and record["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    ctx = {"cell": cell, "seconds": seconds, "setup_s": setup_s,
           "spans": dict(spans.seconds), "work": system.work,
           "steps_per_request": system.steps_per_request, **record}
    metrics = {}
    for m in registry.metrics_of(bench, cell, trace):
        value = registry.load_module("metrics", m["name"], base).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics,
              "device": device_record(device, entry["chips"], peak)}
    card = power_limit() if device.type == "cuda" else None
    if card is not None:
        result["device"]["card"] = card
    summary = record["trace"]
    if trace and summary is not None and summary["busy_s"] > 0:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    lat = sorted(record["latencies_s"])
    sys.stderr.write(f"{cell} seed {seed}: {record['attempted']} requests in "
              f"{record['window_s']:.6f} s, latency min {lat[0]:.6f} median "
              f"{lat[len(lat) // 2]:.6f} max {lat[-1]:.6f} sum {sum(lat):.6f} "
              f"s; set-up spans {dict(spans.seconds)}; work {system.work}\n")
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list[str]:
    """The numbers compared, one line each, beside their limits."""
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
