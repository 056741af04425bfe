"""The block-inverse kernel's share of its roofline, in percent: over the
traced launches, the sum of the least time (``peaks.qd_inverse_bound_ms``
of each launch's m, np, nd and type) over the sum of the kernel's device
time.  m is the launch grid (one block per instance, csrc/qd_inverse.cu);
np, nd and the type are the instance's template arguments in the kernel's
name, or, for the instance with run-time sizes, the configuration's block
split.  Against the published H100 peaks; the card's power limit is printed
beside it."""

import re

from benchmarks.peaks import qd_inverse_bound_ms

KERNEL = re.compile(r"qd_inverse_kernel<(float|double), (\d+), (\d+)>")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    bound_ms = kernel_s = 0.0
    for e in tr.device():
        name = KERNEL.search(e.name)
        if name is None:
            continue
        grid = e.grid
        np_, nd = int(name.group(2)), int(name.group(3))
        if np_ == 0:
            np_, nd = ctx["config"]["qd_inverse_block"]
        if grid is None:
            return None
        bound_ms += qd_inverse_bound_ms(grid[0], np_, nd, 8 if name.group(1) == "double" else 4)[0]
        kernel_s += e.dur_ns * 1e-9
    return 100.0 * bound_ms * 1e-3 / kernel_s if kernel_s > 0 else None
