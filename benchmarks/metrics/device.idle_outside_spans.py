"""Device idle time in the profiled segment and its read while no program
span was open on the host, over all its idle time.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "device.idle_outside_spans")
