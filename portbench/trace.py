"""Reduce a ``torch.profiler`` trace of whole requests to interval sums.

Device operations (kernels, copies, sets) and the harness's own spans
(``portbench.<name>`` annotations) are read from the profiler's raw
events, on the profiler's one clock. The traced window runs from the
first traced request's start to the last one's end; the device is busy
where the union of its operations' intervals covers it. No trace file is
written.
"""

from __future__ import annotations

from collections import defaultdict

SPAN_PREFIX = "portbench."
TOP = 10


def _times(e):
    """(start, end) in ns; older profilers give microseconds only."""
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.end_ns()
    start = e.start_us() * 1000
    return start, start + e.duration_us() * 1000


def _kind(e):
    """'kernel', 'memcpy' or 'memset' for a device operation, 'span' for
    a harness span on the host, else None. Told by the device type and
    the name: not every profiler's events carry an activity type, and the
    device-side copies of the harness's spans carry their names."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith(SPAN_PREFIX):
            return None
        if name.startswith("Memcpy"):
            return "memcpy"
        if name.startswith("Memset"):
            return "memset"
        return "kernel"
    if name.startswith(SPAN_PREFIX):
        return "span"
    return None


def raw_events(prof):
    """``(ops, spans)``: device operations as (name, kind, start_ns,
    end_ns) and harness spans as (name, start_ns, end_ns)."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is None:
            continue
        start, end = _times(e)
        if kind == "span":
            spans.append((e.name()[len(SPAN_PREFIX):], start, end))
        else:
            ops.append((e.name(), kind, start, end))
    return ops, spans


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1][1] = end
        else:
            merged.append([start, end])
    return merged


def _innermost(spans, t):
    """The shortest harness span that holds time t, or 'outside'."""
    best, width = "outside", None
    for name, start, end in spans:
        if start <= t <= end and (width is None or end - start < width):
            best, width = name, end - start
    return best


def summarize(ops, spans) -> dict | None:
    """Interval sums over the traced requests: ``requests``, ``window_s``,
    ``busy_s``, ``kernels``, the ``device_ops`` that took most time and
    the ``idle_gaps`` summed by the harness span the host was in. None
    when no request was traced."""
    requests = [s for s in spans if s[0] == "request"]
    if not requests:
        return None
    w0 = min(s[1] for s in requests)
    w1 = max(s[2] for s in requests)
    inside = [(n, k, max(a, w0), min(b, w1)) for n, k, a, b in ops
              if b > w0 and a < w1]
    busy = union((a, b) for _, _, a, b in inside)
    busy_ns = sum(b - a for a, b in busy)
    by_name = defaultdict(int)
    for name, _, a, b in inside:
        by_name[name] += b - a
    gaps = []
    t = w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = [s for s in spans if s[2] > w0 and s[1] < w1]
    idle = defaultdict(int)
    count = defaultdict(int)
    for a, b in gaps:
        label = _innermost(host, (a + b) // 2)
        idle[label] += b - a
        count[label] += 1
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "requests": len(requests),
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "kernels": sum(1 for _, k, _, _ in inside if k == "kernel"),
        "device_ops": [[n, ns / 1e9] for n, ns in top_ops],
        "idle_gaps": [[f"{label} ({count[label]} gaps)", ns / 1e9]
                      for label, ns in top_gaps],
    }
