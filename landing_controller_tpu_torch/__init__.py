"""PyTorch/CUDA port of the landing_controller_tpu package.

The landing trajectory optimizer, batch-first in PyTorch: the kinodynamic
(production) problem and the srbm_lcp, sliding, ccc and contact-scheduled
variants on the stage-structured KKT path, batch and streaming solves, with
the block inverses of the factorization as hand-written CUDA kernels for
Hopper (``csrc/qd_inverse.cu``, ``csrc/chol_inverse.cu``).  Imports no JAX;
the JAX package beside it is the reference the tests hold it against.
"""

from .api import LandingSolution, LandingSolver
from .parallel.stream import StreamingSolver
from .solver.ip import IPConfig

__all__ = ["IPConfig", "LandingSolution", "LandingSolver", "StreamingSolver"]
