"""The device rule of the port's entry points (the card unless the caller
asks for the CPU), and host constants kept on the device."""

from __future__ import annotations

import subprocess

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes


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


_CONSTANTS: dict = {}


def constant(values, dtype, device) -> torch.Tensor:
    """The numbers ``values`` (a number, nested sequences or an array) as a
    tensor of ``dtype`` on ``device``, made at the first call for those
    numbers, that dtype and that device and kept: a call on the solver's
    path copies nothing to the device and waits for nothing, as a CUDA
    graph's capture requires.  The tensor is shared, so nothing writes into
    it; it is made outside any tracing mode, so a trace takes it as a
    constant."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, device)
    out = _CONSTANTS.get(key)
    if out is None:
        with _disable_current_modes():
            out = _CONSTANTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return out
