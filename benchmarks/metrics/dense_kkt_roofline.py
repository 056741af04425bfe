"""The dense KKT step's Cholesky factorizations' share of their roofline, in
percent: the least time of the traced segment's factorizations over the
device time of the kernels that run them.

Each batch iteration factors, for each of the B lanes, the ladder's
candidates of the equilibrated Hessian (order n) and the Schur complement's
shifts (order me): ``config["dense_kkt"]`` gives n, me and the two counts
(3 and 4 in ``eeparam_sweep``).  The least time takes, over the trace's
iterations, the larger of the factorizations' operations (n^3 / 3 each) at
the card's peak of the configuration's type and every matrix read and
written once over the memory rate (``benchmarks/peaks.py``).  The kernels
are cuSOLVER's batched Cholesky, whose names hold ``potrf``; on the H100
(torch 2.11, CUDA 12.8) they are ``potrf_syrk_nc_kernel``,
``potrf_syrk_T16_nc_kernel``, ``potrfBatch_trsm_lower``,
``potrf_cta_lower_batch``, ``potrf_reset_info`` and ``potrf_set_info``
(PyTorch's copy of the input and its zeroing of the upper triangle are not
counted).  None where the configuration has no dense step or the trace no
such kernel; the card's power limit is printed beside it."""

from benchmarks.peaks import H100_BYTES_PER_S, H100_F32_FLOPS, H100_F64_FLOPS

PATTERN = "potrf"


def least_seconds(iterations, lanes, n, me, ladder, shifts, itemsize=4):
    """Least time of ``iterations`` batch iterations' factorizations of
    ``lanes`` lanes: ``ladder`` matrices of order n and ``shifts`` of order
    me each, against the peak of their type and the memory rate."""
    flops = iterations * lanes * (ladder * n**3 + shifts * me**3) / 3.0
    nbytes = iterations * lanes * 2 * itemsize * (ladder * n * n + shifts * me * me)
    peak = H100_F64_FLOPS if itemsize == 8 else H100_F32_FLOPS
    return max(flops / peak, nbytes / H100_BYTES_PER_S)


def read(ctx):
    tr, dense = ctx["trace"], ctx["config"].get("dense_kkt")
    if tr is None or dense is None:
        return None
    kernel_s = tr.device_seconds(PATTERN)
    if kernel_s <= 0:
        return None
    itemsize = 8 if ctx["config"]["dtype"] == "float64" else 4
    bound = least_seconds(tr.iterations, ctx["mix"]["lanes"], dense["n_vars"], dense["n_eq"],
                          dense["ladder_candidates"], dense["schur_shifts"], itemsize)
    return 100.0 * bound / kernel_s
