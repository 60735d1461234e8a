"""Host microseconds a kernel launch takes, from the C call through its
error check (``_build.Kernel.host_ns`` over ``Kernel.launches``, summed
over every kernel), over the traced requests."""

UNIT = "us"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "routing and launch path"
MOVES = "steps_per_s"


def read(ctx):
    window = (ctx.get("program") or {}).get("window")
    if not window:
        return None
    kernels = window["kernels"].values()
    launches = sum(k["launches"] for k in kernels)
    host_ns = sum(k["host_ns"] for k in kernels)
    if launches == 0 or host_ns == 0:
        return None
    return host_ns / launches / 1e3
