"""Conversion of parameters given as numpy arrays into the port's types.

Feeds both packages identical problem parameters and warm-start weights:
the JAX side's arrays go through ``np.asarray`` and come in here, and the
port's trained weights and statistics go back out as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ._device import resolve_device
from .problems.landing import LandingParams
from .warmstart.nn import build_mlp, mlp_weights_numpy, stats_from_numpy, stats_to_numpy


def landing_params_from_numpy(params: dict, dtype=torch.float64, device="cuda") -> LandingParams:
    """{field: array} -> LandingParams, on the card unless ``device="cpu"``.
    Unbatched arrays (x_ref of shape
    (N, 12)) get a leading batch dimension of 1.  The optional fields (the
    running-cost weights qx, qc, qf and the contact schedule cs) are carried
    where the dict has them and stay None where it has not or holds None;
    keys that are not LandingParams fields are ignored."""
    unbatched = np.ndim(params["x_ref"]) == 2
    device = resolve_device(device)
    out = {}
    for f in dataclasses.fields(LandingParams):
        if params.get(f.name) is None and f.default is None:
            continue
        t = torch.as_tensor(np.array(params[f.name]), dtype=dtype, device=device)
        out[f.name] = t[None] if unbatched else t
    return LandingParams(**out)


def mlp_from_numpy(weights, biases, stats: dict, dtype=torch.float32, device="cuda"):
    """(in, out) weight matrices, biases and a {DataStats field: array} dict
    -> (WarmstartMLP, DataStats), on the card unless ``device="cpu"``."""
    return build_mlp(weights, biases, dtype, device), stats_from_numpy(stats, dtype, device)


def mlp_to_numpy(mlp, stats):
    """(WarmstartMLP, DataStats) -> ((in, out) weight matrices, biases,
    {DataStats field: array}): the inverse of :func:`mlp_from_numpy`, the
    arrays the JAX package's ``MLPParams`` and ``DataStats`` are built from."""
    weights, biases = mlp_weights_numpy(mlp)
    return weights, biases, stats_to_numpy(stats)


__all__ = ["landing_params_from_numpy", "mlp_from_numpy", "mlp_to_numpy"]
