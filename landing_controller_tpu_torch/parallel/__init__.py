"""Streaming scenario throughput: refill finished lanes with fresh scenarios."""

from .stream import StreamingSolver

__all__ = ["StreamingSolver"]
