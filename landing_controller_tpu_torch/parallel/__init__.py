"""Scenario-parallel execution: one process per card with collective
reductions, and streaming throughput that refills finished lanes."""

from .batch import ScenarioMesh, backend_for, envelope_stats, make_scenario_mesh, solve_sharded
from .multihost import global_scenario_batch, local_shards, replicated_value
from .stream import StreamingSolver

__all__ = [
    "ScenarioMesh",
    "backend_for",
    "make_scenario_mesh",
    "solve_sharded",
    "envelope_stats",
    "global_scenario_batch",
    "local_shards",
    "replicated_value",
    "StreamingSolver",
]
