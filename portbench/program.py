"""The port's own spans in a ``torch.profiler`` trace of whole requests.

While the port's tracing is on (``airpollution_tpu_torch.utils.profiling``)
each phase of a solve is a ``record_function`` range named ``apt.<name>``
on the profiler's clock, beside the harness's ``portbench.<name>`` spans.
This module reads the profiler's raw events once: the device operations
with the correlation id of the host's runtime call that issued each, the
harness's spans, the port's spans, and the runtime calls. Each idle gap
of the device is labelled by the innermost span of either kind that the
host was in, and each device operation is put down to the innermost span
open at its runtime call (joined by correlation id). :func:`summarize`
returns :func:`portbench.trace.summarize`'s keys, computed by it
unchanged except for those labels, and the ``program`` entry.
"""

from __future__ import annotations

import re
from collections import defaultdict

from portbench import trace

PREFIX = "apt."
RUNTIME = ("cuda_runtime", "cuda_driver")
_RUNTIME_NAME = re.compile(r"^cu(da)?[A-Z]")


def _activity(e):
    """The event's activity type as a string, or None where the profiler
    gives none."""
    get = getattr(e, "activity_type", None)
    return None if get is None else str(get())


def _is_runtime(e) -> bool:
    kind = _activity(e)
    if kind is not None:
        return kind in RUNTIME
    return bool(_RUNTIME_NAME.match(e.name()))


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def raw_events(events) -> dict:
    """The profiler's events (``prof.profiler.kineto_results.events()``)
    sorted into ``ops`` (name, kind, start_ns, end_ns, correlation id),
    harness ``spans`` and port spans ``program`` (name, start_ns,
    end_ns), and ``calls`` (correlation id -> the runtime call's host
    start ns)."""
    ops, spans, program, calls = [], [], [], {}
    for e in events:
        name = e.name()
        if _is_device(e):
            if name.startswith((PREFIX, trace.SPAN_PREFIX)):
                continue  # the device-side copies of host ranges
            kind = trace._kind(e)
            start, end = trace._times(e)
            ops.append((name, kind, start, end, e.correlation_id()))
        elif name.startswith(trace.SPAN_PREFIX):
            start, end = trace._times(e)
            spans.append((name[len(trace.SPAN_PREFIX):], start, end))
        elif name.startswith(PREFIX):
            start, end = trace._times(e)
            program.append((name[len(PREFIX):], start, end))
        elif _is_runtime(e):
            calls[e.correlation_id()] = trace._times(e)[0]
    return {"ops": ops, "spans": spans, "program": program, "calls": calls}


def _self_ns(spans):
    """Per span (in the given order): its length less the lengths of the
    spans directly inside it."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    own = [end - start for _, start, end in spans]
    stack = []
    for i in order:
        _, start, end = spans[i]
        while stack and spans[stack[-1]][2] < end:
            stack.pop()
        if stack and spans[stack[-1]][1] <= start:
            own[stack[-1]] -= end - start
        stack.append(i)
    return own


def summarize(raw: dict) -> dict | None:
    """``trace.summarize`` over the same operations and harness spans,
    with each idle gap labelled by the innermost span of either kind, plus
    ``program``: per port span name, its ``calls``, ``host_s`` (total),
    ``self_s`` (less the port spans inside it) and ``device_s`` (the
    device operations issued while it was the innermost span) over the
    traced requests; ``device_by_span``: the largest (span, operation,
    seconds) triples, the span being the innermost of either kind at the
    operation's runtime call, or ``unjoined``; ``joined``: the share of
    the window's operations matched to a runtime call. None when no
    request was traced."""
    ops = [op[:4] for op in raw["ops"]]
    base = trace.summarize(ops, raw["spans"])
    if base is None:
        return None
    requests = [s for s in raw["spans"] if s[0] == "request"]
    w0 = min(s[1] for s in requests)
    w1 = max(s[2] for s in requests)
    inside = [op for op in raw["ops"] if op[3] > w0 and op[2] < w1]
    busy = trace.union((max(a, w0), min(b, w1))
                       for _, _, a, b, _ in inside)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    program = [s for s in raw["program"] if s[2] > w0 and s[1] < w1]
    host = [s for s in raw["spans"] if s[2] > w0 and s[1] < w1]
    labelled = host + [(PREFIX + n, a, b) for n, a, b in program]
    idle, count = defaultdict(int), defaultdict(int)
    for a, b in gaps:
        label = trace._innermost(labelled, (a + b) // 2)
        idle[label] += b - a
        count[label] += 1
    base["idle_gaps"] = [
        [f"{label} ({count[label]} gaps)", ns / 1e9]
        for label, ns in sorted(idle.items(), key=lambda kv: -kv[1])]
    stats = {}
    for (name, a, b), own in zip(program, _self_ns(program)):
        s = stats.setdefault(name, {"calls": 0, "host_s": 0.0,
                                    "self_s": 0.0, "device_s": 0.0})
        s["calls"] += 1
        s["host_s"] += (b - a) / 1e9
        s["self_s"] += own / 1e9
    by_span = defaultdict(int)
    joined = 0
    for name, _, a, b, corr in inside:
        at = raw["calls"].get(corr)
        if at is None:
            by_span[("unjoined", name)] += b - a
            continue
        joined += 1
        label = trace._innermost(labelled, at)
        by_span[(label, name)] += b - a
        if label.startswith(PREFIX):
            stats[label[len(PREFIX):]]["device_s"] += (b - a) / 1e9
    base["program"] = stats
    base["device_by_span"] = [
        [label, name, ns / 1e9] for (label, name), ns in
        sorted(by_span.items(), key=lambda kv: -kv[1])[:2 * trace.TOP]]
    base["joined"] = joined / len(inside) if inside else None
    return base
