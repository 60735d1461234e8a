"""Device kernels in the traced requests, the port's and PyTorch's, per
simulated time step (profiler trace)."""

UNIT = "1/step"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "routing and launch path"
MOVES = "steps_per_s"


def read(ctx):
    t = ctx["trace"]
    if not t or t["kernels"] == 0:
        return None
    return t["kernels"] / (t["requests"] * ctx["steps_per_request"])
