"""All simulated time steps of all requests completed in the window, over
the window's time (host clock; the window ends with its last request)."""

UNIT = "steps/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(ctx):
    if ctx["window_s"] <= 0 or ctx["completed"] == 0:
        return None
    return ctx["completed"] * ctx["steps_per_request"] / ctx["window_s"]
