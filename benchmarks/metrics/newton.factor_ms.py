"""Host self time of ``newton.factor`` (the factorization with its
block-inverse launches, and the ladder's pick) per batch iteration, over
the window's segments other than the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "newton.factor_ms")
