"""Host self time of ``solver.corrector`` (the Gondzio corrector, less its
``newton.solve``) per batch iteration, over the window's segments other
than the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "solver.corrector_ms")
