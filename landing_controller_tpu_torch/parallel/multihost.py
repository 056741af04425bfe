"""Per-process batch construction and result reading, one process per card.

Under the port's layout every process holds only its own rows of the
scenario batch and solves them on its own device; there is no global array
to assemble.  These functions keep the JAX package's contracts so that a
driver reads the same in both packages (examples/envelope_sweep.py):

- `global_scenario_batch`: this process's local rows -> a tensor of those
  rows on the rank's device (the global batch is every rank's rows, ordered
  by rank);
- `local_shards`: the rank's rows of a result, as a numpy array;
- `replicated_value`: an all-reduced scalar (every rank holds the same
  value) as a host value.

Under one process per card each is one conversion (`torch.as_tensor` or
`to_numpy`) and hides nothing.  They stay for drivers written against the
JAX package's names, which then switch packages by their imports alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .._tree import to_numpy
from .batch import ScenarioMesh


def global_scenario_batch(local_arr, mesh: ScenarioMesh):
    """Local rows (B_local, ...) -> the rank's rows on its device."""
    if isinstance(local_arr, torch.Tensor):
        return local_arr.to(mesh.device)
    return torch.as_tensor(np.asarray(local_arr), device=mesh.device)


def local_shards(arr):
    """The rank's rows of a result, as one numpy array."""
    return to_numpy(arr)


def replicated_value(arr):
    """An all-reduced output (the same on every rank) as a host value."""
    return to_numpy(arr)
