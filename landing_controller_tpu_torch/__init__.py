"""PyTorch/CUDA port of the landing_controller_tpu package.

The streaming srbm_lcp landing solve, batch-first in PyTorch, with the
quasi-definite block inverse of the KKT factorization as a hand-written
CUDA kernel for Hopper (``csrc/qd_inverse.cu``).  Imports no JAX; the JAX
package beside it is the reference the tests hold it against.
"""

from .api import LandingSolution, LandingSolver
from .parallel.stream import StreamingSolver
from .solver.ip import IPConfig

__all__ = ["IPConfig", "LandingSolution", "LandingSolver", "StreamingSolver"]
