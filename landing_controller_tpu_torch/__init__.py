"""PyTorch/CUDA port of the landing_controller_tpu package.

The landing trajectory optimizer, batch-first in PyTorch: the kinodynamic
(production) problem, its motor-voltage variant and the srbm_lcp, sliding,
ccc and contact-scheduled variants, on the stage-structured KKT path
(backends "cri", "cr", "scan") or the dense one; the free-contact-timing
eeParam solver; batch and streaming solves, the SRBM -> kinodynamic cascade
and the receding-horizon replanner (``warmstart.cascade``,
``warmstart.replan``); the training-data factory and the warm start's
training (``data``, ``warmstart.nn``), the analyses (``analysis``), and
Monte-Carlo envelope sweeps over one process per card (``parallel``,
``runtime``).  The block inverses of the "cri" factorization are
hand-written CUDA kernels for Hopper (``csrc/qd_inverse.cu``,
``csrc/chol_inverse.cu``).  Imports no JAX; the JAX package beside it is the
reference the tests hold it against.
"""

from .api import EEParamSolution, EEParamSolver, LandingSolution, LandingSolver
from .parallel.stream import StreamingSolver
from .solver.ip import IPConfig

__all__ = ["EEParamSolution", "EEParamSolver", "IPConfig", "LandingSolution", "LandingSolver",
           "StreamingSolver"]
