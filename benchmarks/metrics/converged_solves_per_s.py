"""Converged scenarios harvested in the window over the window's length
(host clock; the window is the stretch of the stream's segment loop after
its ramp)."""


def read(ctx):
    w = ctx["window"]
    return w["n_converged"] / w["wall_s"]
