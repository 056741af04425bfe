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
``runtime``); saved solvers and stream steps (``runtime.artifact``) and the
plots, animation and HTML viewer (``viz``).  The block inverses of the
"cri" factorization are hand-written CUDA kernels for Hopper
(``csrc/qd_inverse.cu``, ``csrc/chol_inverse.cu``), registered as custom
ops.  Imports no JAX; the JAX package beside it is the
reference the tests hold it against.
"""

import importlib

# the public names, imported at first use: a process that only loads a saved
# solver (runtime.artifact) imports neither the problems nor the solver
_EXPORTS = {
    "EEParamSolution": ".api",
    "EEParamSolver": ".api",
    "IPConfig": ".solver.ip",
    "LandingSolution": ".solution",
    "LandingSolver": ".api",
    "StreamingSolver": ".parallel.stream",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
