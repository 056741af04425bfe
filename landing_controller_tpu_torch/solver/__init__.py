"""Batched interior-point solver, scaling and the structured Newton step."""

from .ip import IPConfig, IPResult, IPState, solve

__all__ = ["IPConfig", "IPResult", "IPState", "solve"]
