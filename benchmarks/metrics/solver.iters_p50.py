"""Median of the iterations (summed over attempts) of the scenarios finished
since the stream started (ramp and window), from the stream's result rows."""


def read(ctx):
    w = ctx["window"]
    return w["iters_p50"] if w["n_finished_all"] else None
