"""Seconds from process start to the start of the window: import, CUDA
context, kernel load (build on a checkout's first run), mesh, solver and
warm-up (host clock)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    return ctx["setup_s"]
