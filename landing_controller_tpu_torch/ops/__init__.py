"""KKT linear algebra: the Hopper block-inverse kernel and cyclic reduction."""

from .cr_inverse import CRInvFactor, cri_factor, cri_solve
from .pallas_blocks import make_qd_inverse, qd_inverse, qd_inverse_ref

__all__ = ["CRInvFactor", "cri_factor", "cri_solve", "make_qd_inverse", "qd_inverse",
           "qd_inverse_ref"]
