"""Share of the traced requests' wall time in which no operation ran on
the device (the complement of the union of its operations' intervals),
in percent."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "steps_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
