"""Milliseconds a traced request spends preparing its solve: the port's
spans ``crbe.prepare`` (the operator's scalars or coefficient grids, the
family permutation of the initial state) and ``fused.operator`` (what a
fused entry builds before its first launch: canvases, masks, plan, work
buffers), on the profiler's clock, over the traced requests."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "routing and launch path: per-request preparation"
MOVES = "solve_p90_ms"

SPANS = ("crbe.prepare", "fused.operator")


def read(ctx):
    t = ctx.get("trace")
    spans = (t or {}).get("program") or {}
    if not t or not t["requests"] or not all(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["host_s"] for s in SPANS) / t["requests"]
