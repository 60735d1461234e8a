"""Seconds of set-up in the port's span ``crbe.interval``: the Chebyshev
interval and skew norm (``linalg.power_bounds``, ``linalg.skew_norm``)
of ``CRBESolver``'s applicability check."""

UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "set-up: assembly, interval and plan"
MOVES = "setup_s"

SPAN = "crbe.interval"


def read(ctx):
    setup = (ctx.get("program") or {}).get("setup")
    span = (setup or {}).get("spans", {}).get(SPAN)
    return None if span is None else span["total_ns"] / 1e9
