"""Host self time of ``newton.derivatives`` (per-knot Jacobians and
Hessians by ``torch.func``) per batch iteration, over the window's
segments other than the profiled one.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "newton.derivatives_ms")
