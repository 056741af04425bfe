"""Host-side runtime: the native (C++) scenario pool and result log, saved
solvers (``torch.export`` programs) and the kernels' build cache."""

from .artifact import enable_persistent_cache, load_solver, save_solver
from .native import (
    NativeScenarioPool,
    ResultLog,
    native_available,
    read_result_log,
    sample_scenarios_native,
)

__all__ = [
    "enable_persistent_cache",
    "load_solver",
    "save_solver",
    "NativeScenarioPool",
    "ResultLog",
    "native_available",
    "read_result_log",
    "sample_scenarios_native",
]
