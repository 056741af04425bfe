"""Converged over finished, in the window: a scenario that does not converge
is the solver's outcome and counts here, not among the failed.  Only where
the window opens after the ramp do failed scenarios reach it at their
steady rate."""


def read(ctx):
    w = ctx["window"]
    return w["n_converged"] / w["n_finished"] if w["n_finished"] else None
