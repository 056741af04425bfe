"""Drops finished with more than one attempt over drops finished, by the
process's streams (the program's counters ``stream.retried`` and
``stream.finished``, from the fifth row of the stream's results: the
attempts of each drop).  The one-segment warm-up's few finished drops
count too; none of them can have retried.  None where the program has no
such counters or finished no drop."""


def read(ctx):
    try:
        from landing_controller_tpu_torch.tracing import counters
    except ImportError:  # a program without the counters
        return None
    c = counters()
    return c["stream.retried"] / c["stream.finished"] if c["stream.finished"] else None
