"""Host self time of ``solver.iteration`` (an iteration less its phases:
the step to the boundary, the update, the rescue, the barrier, the stall
detector) per batch iteration, over the window's segments other than the
profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "solver.update_ms")
