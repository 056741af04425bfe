"""The device rule of the port's entry points (the card unless the caller
asks for the CPU), and host constants kept on the device."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" requires a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (every entry point's
    record carries it: a card set below 700 W runs slower), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def cached_tensors(cache: dict, arrays: tuple, dtype, device, build=tuple):
    """``build`` of the numpy ``arrays`` as tensors of ``dtype`` on
    ``device``, made at the first call for that pair and kept in ``cache``,
    so that a batched call copies no constant to the device."""
    key = (dtype, torch.device(device))
    out = cache.get(key)
    if out is None:
        out = cache[key] = build(torch.as_tensor(np.asarray(a), dtype=dtype, device=key[1])
                                 for a in arrays)
    return out
