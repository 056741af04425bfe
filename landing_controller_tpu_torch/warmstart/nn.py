"""Learned warm start, inference only: normalization, MLP, denormalization.

The reference's L5 layer (nn_warmstart.m:130-218): the 9-D initial condition
[rpy(3), omega(3), v(3)] goes through a 9 -> 256 -> 256 -> 256 -> 976 ReLU MLP
(nn_landing.m:100-144); the 976-D output denormalizes into X (N,12),
U (N-1,24) and jpos (N-1,12), with GRFs shifted back by the predicted
touchdown indices (data_denormalization.m:1-40).

Weights and statistics are read from the committed ``.npz`` artifact with
``np.load``.  Training lives in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..problems.landing import LandingVars

N_KNOTS = 21
INPUT_DIM = 9
OUTPUT_DIM = 12 * N_KNOTS + 24 * (N_KNOTS - 1) + 12 * (N_KNOTS - 1) + 4  # 976
HIDDEN = 256


@dataclasses.dataclass(frozen=True)
class DataStats:
    """Normalization statistics (the reference's data_stats.mat)."""

    mean_input: torch.Tensor  # (9,)
    std_input: torch.Tensor
    mean_X: torch.Tensor  # (N,12)
    std_X: torch.Tensor
    mean_c: torch.Tensor  # (N-1,12) foot positions
    std_c: torch.Tensor
    mean_jpos: torch.Tensor  # (N-1,12)
    std_jpos: torch.Tensor
    mass: torch.Tensor  # scalar (for the m*g GRF scale)


class WarmstartMLP(nn.Module):
    """9 -> 256 -> 256 -> 256 -> 976 with ReLU (Gemm+ReLU x3, Gemm head)."""

    def __init__(self, sizes=(INPUT_DIM, HIDDEN, HIDDEN, HIDDEN, OUTPUT_DIM)):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(m, n) for m, n in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def build_mlp(weights, biases, dtype=torch.float32, device="cpu") -> WarmstartMLP:
    """MLP from (in, out)-shaped weight matrices (``h @ w + b`` convention)."""
    sizes = [np.shape(weights[0])[0]] + [np.shape(w)[1] for w in weights]
    mlp = WarmstartMLP(tuple(sizes))
    with torch.no_grad():
        for layer, w, b in zip(mlp.layers, weights, biases):
            layer.weight.copy_(torch.as_tensor(np.array(w).T))
            layer.bias.copy_(torch.as_tensor(np.array(b)))
    mlp.requires_grad_(False)
    return mlp.to(dtype=dtype, device=device)


def stats_from_numpy(stats: dict, dtype=torch.float32, device="cpu") -> DataStats:
    return DataStats(**{
        f.name: torch.as_tensor(np.array(stats[f.name]), dtype=dtype, device=device)
        for f in dataclasses.fields(DataStats)
    })


def load_warmstart(path: str, dtype=torch.float32, device="cpu"):
    """Load (WarmstartMLP, DataStats) from the warm-start ``.npz`` artifact."""
    with np.load(path) as d:
        n_layers = int(d["n_layers"])
        ws = [d[f"w{i}"] for i in range(n_layers)]
        bs = [d[f"b{i}"] for i in range(n_layers)]
        stats = {f.name: d[f"stats_{f.name}"] for f in dataclasses.fields(DataStats)}
    return build_mlp(ws, bs, dtype, device), stats_from_numpy(stats, dtype, device)


def _touchdown_align_inverse(f, td):
    """Inverse shift: prepend td zeros per leg (data_denormalization.m:32-38).

    f: (B, N-1, 4, 3) touchdown-aligned GRFs; td: (B, 4) integer indices."""
    n = f.shape[1]
    idx = torch.arange(n, device=f.device)[None, :, None] - td[:, None, :]  # (B, n, 4)
    src = torch.clamp(idx, 0, n - 1)
    gathered = torch.gather(f, 1, src[..., None].expand(f.shape))
    return torch.where((idx >= 0)[..., None], gathered, torch.zeros_like(gathered))


def denormalize_output(stats: DataStats, y):
    """(B, 976) network output -> (X (B,N,12), U (B,N-1,24), jpos (B,N-1,12))."""
    n = N_KNOTS
    B = y.shape[0]
    nx, nu, nj = 12 * n, 24 * (n - 1), 12 * (n - 1)
    X_n = y[:, :nx].reshape(B, n, 12)
    U_n = y[:, nx : nx + nu].reshape(B, n - 1, 24)
    jpos_n = y[:, nx + nu : nx + nu + nj].reshape(B, n - 1, 12)
    # n-1 = the "never landed" label: the inverse shift then yields an
    # all-zero GRF history for that leg
    td = torch.clamp(torch.round(y[:, nx + nu + nj :]), 0, n - 1).to(torch.int64)

    X = X_n * stats.std_X + stats.mean_X
    c = U_n[..., :12] * stats.std_c + stats.mean_c
    f_aligned = (U_n[..., 12:] * (stats.mass * 9.81)).reshape(B, n - 1, 4, 3)
    f = _touchdown_align_inverse(f_aligned, td)
    U = torch.cat([c, f.reshape(B, n - 1, 12)], -1)
    jpos = jpos_n * stats.std_jpos + stats.mean_jpos
    return X, U, jpos


def nn_warmstart_guess(mlp: WarmstartMLP, stats: DataStats, q_init, qd_init, problem):
    """(B, 6) initial conditions -> (B, n_vars) warm-start vectors.

    Normalize input, MLP, denormalize, re-anchor to the queried xy, pin the
    initial state, pack [X(:); (jpos(:)); U(:)] (the kinodynamic layout keeps
    the predicted joint angles, the srbm layouts drop them)."""
    x_in = torch.cat([q_init[:, 3:6], qd_init], -1)
    xin_n = (x_in - stats.mean_input) / stats.std_input
    y = mlp(xin_n)
    X, U, jpos = denormalize_output(stats, y)
    # the network was trained with the initial xy zeroed: shift base and
    # foot xy to start at q_init's xy, and pin the initial state exactly
    shift = q_init[:, 0:2] - X[:, 0, 0:2]  # (B, 2)
    X = torch.cat([X[..., 0:2] + shift[:, None], X[..., 2:]], -1)
    c = U[..., :12].reshape(U.shape[:-1] + (4, 3))
    c = torch.cat([c[..., 0:2] + shift[:, None, None], c[..., 2:]], -1)
    U = torch.cat([c.reshape(U.shape[:-1] + (12,)), U[..., 12:]], -1)
    X = torch.cat([torch.cat([q_init, qd_init], -1)[:, None], X[:, 1:]], 1)
    if not problem.config.kinodynamic:
        jpos = jpos[..., :0]
    return problem.pack(LandingVars(X=X, jpos=jpos, U=U))
