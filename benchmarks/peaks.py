"""Published peaks of one NVIDIA H100 and the least time of the port's
block-inverse kernel, frozen from ``chip_smoke.py:129-131`` and
``chip_smoke.py:262-276``.

The peaks are NVIDIA's data sheet for the SXM part at its 700 W limit: HBM3
at 3.35 TB/s, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the
tensor cores (the kernel uses none).  A card set below 700 W runs slower;
the harness prints the card's power limit beside every share of a peak.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_F64_FLOPS = 34e12


def qd_inverse_bound_ms(m, np_, nd, itemsize=4):
    """Least time for m block inverses on an H100: each input read once and
    each output written once over the memory rate, against the
    factorization's operations over the peak of their type (f32, or f64
    where itemsize is 8).  Returns (milliseconds, what bounds it)."""
    bs = np_ + nd
    nbytes = m * (2 * bs * bs * itemsize + 1)
    flops_one = (np_**3 / 3 + 2 * np_**3 / 3  # chol(P), P^-1
                 + 2 * np_ * np_ * nd + 2 * nd * nd * np_  # E, D + B E
                 + nd**3 / 3 + 2 * nd**3 / 3  # chol(Dt), W
                 + 2 * np_ * nd * nd + 2 * np_ * np_ * nd)  # E W, TL
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = m * flops_one / (H100_F64_FLOPS if itemsize == 8 else H100_F32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
