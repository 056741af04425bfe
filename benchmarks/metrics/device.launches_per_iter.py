"""Kernel-launch runtime and driver calls (cudaLaunchKernel, ...ExC,
cuLaunchKernel, ...) in the trace over its batch iterations."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.iterations:
        return None
    n = tr.launches()
    return n / tr.iterations if n else None
