"""The forecasts' least time over the device's busy time in the traced
requests, in percent. The least time is counted per forecast (the
scheme's operations and bytes, ``portbench/work.py``), never per launch,
so any implementation of the cell's scheme reads at most 100."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "steps_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["least_s"] * t["requests"] / t["busy_s"]
