"""1 - (union of the device operations' intervals / the profiled segments'
host-clock length), from one torch.profiler trace."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr.window_s <= 0 or not tr.device():
        return None
    return 1.0 - tr.busy_s() / tr.window_s
