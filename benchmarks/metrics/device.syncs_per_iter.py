"""Device-to-host copies in the profiled segment outside ``stream.read``
(the stream's one planned read), per batch iteration: each one a host
that waited for the device.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "device.syncs_per_iter")
