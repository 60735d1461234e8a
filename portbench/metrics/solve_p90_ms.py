"""The 90th percentile of the request latency over all requests of the
window: from the call until the final field is in host memory (host
clock), by ``statistics.quantiles(..., n=10, method='inclusive')``."""

import statistics

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(ctx):
    lat = ctx["latencies_s"]
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=10, method="inclusive")[8] * 1e3
