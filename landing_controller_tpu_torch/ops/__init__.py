"""KKT linear algebra: the Hopper block-inverse kernels and the structured
block-tridiagonal factorizations (sequential sweep, cyclic reduction, and the
inverse-based cyclic reduction that runs the kernel), and the
branch-induced-sparsity tree factorizations of mass matrices."""

from .block_tridiag import qd_block_tridiag_factor, qd_block_tridiag_solve
from .branch_sparsity import (expand_lambda, ltdl, ltl, mpy_h, mpy_l, mpy_lt, solve_l, solve_lt,
                              solve_ltl)
from .cr_inverse import CRInvFactor, cri_factor, cri_solve
from .cyclic_reduction import cr_factor, cr_solve
from .pallas_blocks import (chol_inverse, chol_inverse_ref, make_qd_inverse, qd_inverse,
                            qd_inverse_ref)

__all__ = ["CRInvFactor", "chol_inverse", "chol_inverse_ref", "cr_factor", "cr_solve",
           "cri_factor", "cri_solve", "expand_lambda", "ltdl", "ltl", "make_qd_inverse", "mpy_h",
           "mpy_l", "mpy_lt", "qd_block_tridiag_factor", "qd_block_tridiag_solve", "qd_inverse",
           "qd_inverse_ref", "solve_l", "solve_lt", "solve_ltl"]
