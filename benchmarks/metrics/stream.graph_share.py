"""Batch iterations the process's streams ran as replays of a captured CUDA
graph, over all their batch iterations (the program's counters
``stream.graph_replays`` and ``stream.eager_iterations``; the warm-up
segment's iterations count too).  None where the program has no such
counters or ran no iteration."""


def read(ctx):
    try:
        from landing_controller_tpu_torch.tracing import counters
    except ImportError:  # a program without the counters
        return None
    c = counters()
    total = c["stream.graph_replays"] + c["stream.eager_iterations"]
    return c["stream.graph_replays"] / total if total else None
