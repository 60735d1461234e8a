"""Seconds in the set-up's solver span: ``CRBESolver`` construction
through its warm-up forecasts (assembly, the Chebyshev interval, the
plan and the kernel's load, built on a checkout's first run)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "set-up: assembly, interval and plan"
MOVES = "setup_s"


def read(ctx):
    return ctx["spans"].get("solver_setup")
