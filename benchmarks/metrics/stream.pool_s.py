"""The measured run's pool set-up (``stream.pool``: the pool's drops on the
device and every attempt's initial lane data), host seconds.
None where the program recorded no spans (``benchmarks/spans.py``)."""

from benchmarks.spans import read_metric


def read(ctx):
    return read_metric(ctx, "stream.pool_s")
