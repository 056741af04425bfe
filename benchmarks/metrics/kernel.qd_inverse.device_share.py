"""The block-inverse kernel's device time over all device time in the
trace (sums of the device operations' durations)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    total = tr.device_seconds()
    mine = tr.device_seconds("qd_inverse")
    return mine / total if mine > 0 else None
