"""Host self time of ``solver.line_search`` (the filter line search over
all candidates) per batch iteration, over the window's segments other
than the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "solver.line_search_ms")
