"""Scenario-sharded batched solving, one process per card.

The reference's batch sweeps are serial MATLAB loops
(analysis/foot_positions.m:32-43, generate_training_data_automated.m:38).
Here the scenario axis is split over processes: each process owns one
device (``cuda:LOCAL_RANK`` under ``torchrun``, or the CPU), solves its own
rows with the solver's batched solve, and counts and envelope statistics are
reduced with ``torch.distributed`` collectives (NCCL between cards, gloo on
the CPU).  The library never starts a process group: the caller does
(``init_process_group`` with :func:`backend_for` of its device), as the JAX
example calls ``jax.distributed.initialize``.  Without a process group the
mesh is one rank and every reduction is local.

Per-scenario convergence is a mask, not an exception: failed scenarios
survive in the output with ``converged=False``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..api import resolve_device


@dataclasses.dataclass(frozen=True)
class ScenarioMesh:
    """The scenario axis over processes: this process is ``rank`` of
    ``world_size`` and solves its rows on ``device``."""

    world_size: int
    rank: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        return self.world_size > 1


def backend_for(device) -> str:
    """The collective backend of a device: "nccl" for a card, "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_scenario_mesh(device=None) -> ScenarioMesh:
    """This process's place on the scenario axis.

    The default ``torch.distributed`` group gives the world size and rank
    when the caller initialized one; otherwise the mesh is one rank.
    ``device``: None takes ``cuda:LOCAL_RANK`` (0 without the variable),
    which requires a card; "cpu" runs the rank on the CPU."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return ScenarioMesh(world_size=world, rank=rank, device=resolve_device(device))


def _all_reduce(t, mesh: ScenarioMesh, op):
    if mesh.distributed:
        dist.all_reduce(t, op=op)
    return t


def solve_sharded(solve_one, q_inits, qd_inits, mesh: ScenarioMesh, collect_stats: bool = True):
    """Solve this rank's rows with a batched ``solve_one(q (B, 6), qd (B, 6))
    -> solution`` (a LandingSolver's ``_solve_impl``).

    Returns (solution of the local rows, stats): stats holds the converged
    count and the sum of iterations over every rank's rows (all-reduced
    0-d tensors on the mesh's device), or is ``{}`` with
    ``collect_stats=False`` (then no collective runs)."""
    q = torch.as_tensor(q_inits, device=mesh.device)
    qd = torch.as_tensor(qd_inits, device=mesh.device)
    sols = solve_one(q, qd)
    if not collect_stats:
        return sols, {}
    n_conv = sols.converged.sum().to(torch.int64)
    iter_sum = sols.iterations.sum().to(torch.int64)
    return sols, {
        "n_converged": _all_reduce(n_conv, mesh, dist.ReduceOp.SUM),
        "iterations_sum": _all_reduce(iter_sum, mesh, dist.ReduceOp.SUM),
    }


def envelope_stats(X_batch, converged, mesh: ScenarioMesh | None = None):
    """Landing-envelope reductions over the scenario axis.

    Returns the success rate and the per-dimension min/max terminal state over
    the converged scenarios: the batched analogue of the reference's
    envelope sweeps (analysis/foot_positions.m:56-75).  X_batch (B, N, 12)
    and converged (B,) are this rank's rows; with a ``mesh`` the reductions
    run over every rank (SUM, MIN, MAX), otherwise over these rows only."""
    conv = converged.to(X_batch.dtype)
    xT = X_batch[:, -1, :]
    big = torch.finfo(X_batch.dtype).max / 8
    ok = conv[:, None] > 0
    masked_min = torch.where(ok, xT, torch.full_like(xT, big)).amin(0)
    masked_max = torch.where(ok, xT, torch.full_like(xT, -big)).amax(0)
    if mesh is None:
        return {"success_rate": conv.mean(), "term_state_min": masked_min,
                "term_state_max": masked_max}
    total = _all_reduce(conv.sum(), mesh, dist.ReduceOp.SUM)
    count = _all_reduce(torch.tensor(float(conv.shape[0]), dtype=conv.dtype, device=conv.device),
                        mesh, dist.ReduceOp.SUM)
    return {
        "success_rate": total / count,
        "term_state_min": _all_reduce(masked_min, mesh, dist.ReduceOp.MIN),
        "term_state_max": _all_reduce(masked_max, mesh, dist.ReduceOp.MAX),
    }
