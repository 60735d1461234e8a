"""Seconds of set-up in the port's span ``crbe.assemble``: the global
operator's assembly (``CRBESolver.build_global_matrices``)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "set-up: assembly, interval and plan"
MOVES = "setup_s"

SPAN = "crbe.assemble"


def read(ctx):
    setup = (ctx.get("program") or {}).get("setup")
    span = (setup or {}).get("spans", {}).get(SPAN)
    return None if span is None else span["total_ns"] / 1e9
