"""Host time of ``solver.rebuild`` (the IP program and the structured
step built anew: once per iteration and once per harvest) per batch
iteration, over the window's segments other than the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "solver.rebuild_ms")
