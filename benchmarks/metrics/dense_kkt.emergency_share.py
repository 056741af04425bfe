"""Lane-iterations of the dense KKT step in which no ladder shift gave a
Cholesky factor and the emergency shift was taken, over the lane-iterations
it factored (the program's counters ``dense_kkt.emergency``, accumulated on
the device and read with the stream's one host read per segment, and
``dense_kkt.lane_iterations``; the warm-up segment counts too).  None where
the program has no such counters or took no dense step."""


def read(ctx):
    try:
        from landing_controller_tpu_torch.tracing import counters
    except ImportError:  # a program without the counters
        return None
    c = counters()
    total = c["dense_kkt.lane_iterations"]
    return c["dense_kkt.emergency"] / total if total else None
