"""Host self time of ``stream.harvest`` (harvest and refill, less its
``solver.rebuild``) per segment, over the window's segments other than
the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "stream.harvest_ms")
