"""Conversion of parameters given as numpy arrays into the port's types.

Feeds both packages identical problem parameters and warm-start weights:
the JAX side's arrays go through ``np.asarray`` and come in here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .problems.landing import LandingParams
from .warmstart.nn import build_mlp, stats_from_numpy


def landing_params_from_numpy(params: dict, dtype=torch.float64, device="cpu") -> LandingParams:
    """{field: array} -> LandingParams.  Unbatched arrays (x_ref of shape
    (N, 12)) get a leading batch dimension of 1.  The optional fields (the
    running-cost weights qx, qc, qf and the contact schedule cs) are carried
    where the dict has them and stay None where it has not or holds None;
    keys that are not LandingParams fields are ignored."""
    unbatched = np.ndim(params["x_ref"]) == 2
    out = {}
    for f in dataclasses.fields(LandingParams):
        if params.get(f.name) is None and f.default is None:
            continue
        t = torch.as_tensor(np.array(params[f.name]), dtype=dtype, device=device)
        out[f.name] = t[None] if unbatched else t
    return LandingParams(**out)


def mlp_from_numpy(weights, biases, stats: dict, dtype=torch.float32, device="cpu"):
    """(in, out) weight matrices, biases and a {DataStats field: array} dict
    -> (WarmstartMLP, DataStats)."""
    return build_mlp(weights, biases, dtype, device), stats_from_numpy(stats, dtype, device)


__all__ = ["landing_params_from_numpy", "mlp_from_numpy"]
