"""The whole step's share of the card's peak: the forecasts' least time
over the traced requests' wall time, in percent. It bounds every kernel's
share, so a kernel taken off the path cannot hide a loss."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "device, whole step"
MOVES = "steps_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * ctx["work"]["least_s"] * t["requests"] / t["window_s"]
