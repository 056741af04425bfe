"""Host self time of ``solver.residuals`` (the rows' vjps, the KKT error,
the Newton right-hand side) per batch iteration, over the window's
segments other than the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "solver.residuals_ms")
