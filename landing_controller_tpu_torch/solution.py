"""The landing solver's result type, in a module without problem code, so
that a saved solver (:mod:`.runtime.artifact`) loads and returns it without
importing the problems or the solver."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LandingSolution:
    X: torch.Tensor  # (B, N, 12) base trajectory
    jpos: torch.Tensor  # (B, N-1, 12) joint angles (empty for the srbm family)
    U: torch.Tensor  # (B, N-1, 24) foot positions + GRFs
    tau: torch.Tensor  # (B, N-1, 12) Jacobian-transpose joint torques (zeros for the srbm family)
    z: torch.Tensor  # flat solution (reference layout)
    converged: torch.Tensor
    iterations: torch.Tensor
    kkt_error: torch.Tensor
    constr_viol: torch.Tensor
    cost: torch.Tensor
    # warm-start state (unscaled): inequality slacks and multipliers,
    # equality multipliers
    s: torch.Tensor
    lam: torch.Tensor
    y: torch.Tensor
