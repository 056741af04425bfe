"""KKT linear algebra: the Hopper block-inverse kernels and cyclic reduction."""

from .cr_inverse import CRInvFactor, cri_factor, cri_solve
from .pallas_blocks import (chol_inverse, chol_inverse_ref, make_qd_inverse, qd_inverse,
                            qd_inverse_ref)

__all__ = ["CRInvFactor", "chol_inverse", "chol_inverse_ref", "cri_factor", "cri_solve",
           "make_qd_inverse", "qd_inverse", "qd_inverse_ref"]
