"""Host-side runtime: the native (C++) scenario pool and result log.

The JAX package's durable compiled-solver artifacts (``runtime/artifact.py``)
are not ported yet."""

from .native import (
    NativeScenarioPool,
    ResultLog,
    native_available,
    read_result_log,
    sample_scenarios_native,
)

__all__ = [
    "NativeScenarioPool",
    "ResultLog",
    "native_available",
    "read_result_log",
    "sample_scenarios_native",
]
