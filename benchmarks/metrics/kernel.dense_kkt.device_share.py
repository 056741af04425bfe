"""The dense KKT step's factor and solve kernels' device time over all
device time in the trace: cuSOLVER's batched Cholesky (names holding
``potrf``) and cuBLAS's batched triangular solves (``trsm``: on the H100,
``batch_trsm_left_kernel``), which form the Schur complement's factor F
and apply both factors.  None where the trace has none of them."""

PATTERNS = ("potrf", "trsm")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    total = tr.device_seconds()
    mine = sum(e.dur_ns for e in tr.device() if any(p in e.name for p in PATTERNS)) * 1e-9
    return mine / total if mine > 0 else None
