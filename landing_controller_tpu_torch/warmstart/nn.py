"""Learned warm start: normalization, MLP, training, denormalization.

The reference's L5 layer (nn_warmstart.m:130-218): the 9-D initial condition
[rpy(3), omega(3), v(3)] goes through a 9 -> 256 -> 256 -> 256 -> 976 ReLU MLP
(nn_landing.m:100-144); the 976-D output denormalizes into X (N,12),
U (N-1,24) and jpos (N-1,12), with GRFs shifted back by the predicted
touchdown indices (data_denormalization.m:1-40).

Training (data_normalization.m:40-115): per-dimension z-scores of the input
and of X / foot positions / jpos; each leg's GRF history is shifted so that
its touchdown (first knot with f_z > 1 N) comes first, padded with its final
value and scaled by m g; the four touchdown indices end the 976-D target.
:func:`train_mlp` fits the MLP with ``torch.optim.Adam`` on the mean squared
error.  Weights and statistics are saved to and read from ``.npz`` files
with the JAX package's keys and layout, so either package reads the other's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
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


def touchdown_indices(U):
    """Per-leg first knot with f_z > 1 N (data_normalization.m:86), (B, 4)
    from U (B, N-1, 24).  A leg that never exceeds 1 N gets N-1, one past the
    last GRF knot: the "never landed" label (the index of the first True
    would claim touchdown at knot 0 for an all-False row)."""
    hit = U[..., 14::3] > 1.0  # (B, N-1, 4)
    n = hit.shape[-2]
    first = torch.argmax(hit.to(torch.int8), dim=-2)  # first True (0 when none)
    return torch.where(hit.any(-2), first, torch.full_like(first, n))


def _touchdown_align_forward(f, td):
    """Shift each leg's GRF history so touchdown is at index 0, padding the
    tail with the final value (data_normalization.m:84-90).

    f: (B, N-1, 4, 3) GRFs; td: (B, 4) integer indices."""
    n = f.shape[1]
    idx = torch.clamp(torch.arange(n, device=f.device)[None, :, None] + td[:, None, :], 0, n - 1)
    return torch.gather(f, 1, idx[..., None].expand(f.shape))


def compute_stats(inputs, X, U, jpos, mass) -> DataStats:
    """Fit normalization statistics on a dataset (leading sample axis);
    standard deviations over the samples (no Bessel correction) plus 1e-8."""
    std = lambda t: t.std(0, correction=0) + 1e-8  # noqa: E731
    c = U[..., :12]
    return DataStats(
        mean_input=inputs.mean(0), std_input=std(inputs),
        mean_X=X.mean(0), std_X=std(X),
        mean_c=c.mean(0), std_c=std(c),
        mean_jpos=jpos.mean(0), std_jpos=std(jpos),
        mass=torch.as_tensor(mass, dtype=X.dtype, device=X.device),
    )


def normalize_sample(stats: DataStats, x_in, X, U, jpos):
    """(input (B,9), trajectory) pairs -> normalized (input (B,9), target (B,976))."""
    B = x_in.shape[0]
    xin_n = (x_in - stats.mean_input) / stats.std_input
    td = touchdown_indices(U)
    f = U[..., 12:].reshape(B, -1, 4, 3)
    f_norm = _touchdown_align_forward(f, td) / (stats.mass * 9.81)
    X_n = (X - stats.mean_X) / stats.std_X
    X_n[:, 0, 0:2] = 0.0  # zero the (arbitrary) initial xy
    c_n = (U[..., :12] - stats.mean_c) / stats.std_c
    jpos_n = (jpos - stats.mean_jpos) / stats.std_jpos
    U_n = torch.cat([c_n, f_norm.reshape(B, -1, 12)], -1)
    target = torch.cat([X_n.reshape(B, -1), U_n.reshape(B, -1), jpos_n.reshape(B, -1),
                        td.to(X.dtype)], -1)
    return xin_n, target


class WarmstartMLP(nn.Module):
    """9 -> 256 -> 256 -> 256 -> 976 with ReLU (Gemm+ReLU x3, Gemm head)."""

    def __init__(self, sizes=(INPUT_DIM, HIDDEN, HIDDEN, HIDDEN, OUTPUT_DIM)):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(m, n) for m, n in zip(sizes[:-1], sizes[1:]))

    def forward(self, x):
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


def build_mlp(weights, biases, dtype=torch.float32, device="cuda") -> WarmstartMLP:
    """MLP from (in, out)-shaped weight matrices (``h @ w + b`` convention),
    on the card unless ``device="cpu"``."""
    sizes = [np.shape(weights[0])[0]] + [np.shape(w)[1] for w in weights]
    mlp = WarmstartMLP(tuple(sizes)).to(dtype=dtype, device=resolve_device(device))
    with torch.no_grad():
        for layer, w, b in zip(mlp.layers, weights, biases):
            layer.weight.copy_(torch.as_tensor(np.array(w).T))
            layer.bias.copy_(torch.as_tensor(np.array(b)))
    return mlp.requires_grad_(False)


def init_mlp(generator: torch.Generator | None = None, hidden: int = HIDDEN, depth: int = 3,
             dtype=torch.float32, device="cuda") -> WarmstartMLP:
    """9 -> hidden^depth -> 976 MLP with He-normal weights (std sqrt(2 / m)
    for a layer of m inputs) and zero biases, on the card unless
    ``device="cpu"``; the draws come from ``generator`` (a fresh one seeded 0
    on the CPU when None) on its own device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    sizes = [INPUT_DIM] + [hidden] * depth + [OUTPUT_DIM]
    ws, bs = [], []
    for m, n in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((m, n), generator=generator, dtype=dtype, device=generator.device)
        ws.append(w * np.sqrt(2.0 / m))
        bs.append(torch.zeros(n, dtype=dtype))
    return build_mlp([w.cpu().numpy() for w in ws], [b.numpy() for b in bs], dtype, device)


def train_mlp(inputs_n, targets_n, generator: torch.Generator | None = None, epochs: int = 400,
              batch_size: int = 256, lr: float = 1e-3, hidden: int = HIDDEN,
              mlp: WarmstartMLP | None = None):
    """Train the warm-start MLP with Adam on the mean squared error (the
    reference trains the equivalent network in PyTorch; nn_landing.m:95).

    inputs_n (n, 9), targets_n (n, 976) on one device; the network is trained
    there.  ``generator`` (a fresh one seeded 0 when None) draws the initial
    weights, unless ``mlp`` is given (it is trained in place), and one
    permutation of the samples per epoch; the last partial batch of an epoch
    is dropped.  Returns (mlp, per-epoch mean batch losses)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dev = inputs_n.device
    if mlp is None:
        mlp = init_mlp(generator, hidden=hidden, dtype=inputs_n.dtype, device=dev)
    mlp.requires_grad_(True)
    opt = torch.optim.Adam(mlp.parameters(), lr=lr)
    n = inputs_n.shape[0]
    bs = min(batch_size, n)
    n_batches = max(1, n // bs)
    losses = []
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator, device=generator.device).to(dev)
        epoch_loss = torch.zeros((), dtype=inputs_n.dtype, device=dev)
        for i in range(0, n - bs + 1, bs):
            idx = perm[i : i + bs]
            loss = torch.mean((mlp(inputs_n[idx]) - targets_n[idx]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            epoch_loss += loss.detach()
        losses.append(float(epoch_loss) / n_batches)
    mlp.requires_grad_(False)
    return mlp, losses


def save_warmstart(path: str, mlp: WarmstartMLP, stats: DataStats) -> None:
    """Weights ``w{i}`` as (in, out), biases ``b{i}``, ``n_layers`` and the
    statistics ``stats_<field>`` in one compressed ``.npz`` (the JAX
    package's layout; the analogue of the reference's committed
    nn_TO_landing.onnx + data_stats.mat pair)."""
    weights, biases = mlp_weights_numpy(mlp)
    arrs = {}
    for i, (w, b) in enumerate(zip(weights, biases)):
        arrs[f"w{i}"] = w
        arrs[f"b{i}"] = b
    arrs["n_layers"] = np.asarray(len(weights))
    for name, a in stats_to_numpy(stats).items():
        arrs[f"stats_{name}"] = a
    np.savez_compressed(path, **arrs)


def mlp_weights_numpy(mlp: WarmstartMLP):
    """(weights as (in, out) matrices, biases) of the MLP, numpy."""
    weights = [layer.weight.detach().cpu().numpy().T.copy() for layer in mlp.layers]
    biases = [layer.bias.detach().cpu().numpy().copy() for layer in mlp.layers]
    return weights, biases


def stats_to_numpy(stats: DataStats) -> dict:
    return {f.name: getattr(stats, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(DataStats)}


def stats_from_numpy(stats: dict, dtype=torch.float32, device="cuda") -> DataStats:
    """{DataStats field: array} -> DataStats, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    return DataStats(**{
        f.name: torch.as_tensor(np.array(stats[f.name]), dtype=dtype, device=device)
        for f in dataclasses.fields(DataStats)
    })


def load_warmstart(path: str, dtype=torch.float32, device="cuda"):
    """Load (WarmstartMLP, DataStats) from the warm-start ``.npz`` artifact,
    on the card unless ``device="cpu"``."""
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
