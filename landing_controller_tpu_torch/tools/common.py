"""What the tools share: the solver settings of the kinodynamic family and of
the srbm_lcp diagnostics, their drop samplers, the record files, and the
counts and host reads around a solve."""

from __future__ import annotations

import json
import os
import time

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def kino_config(max_iter: int = 200, **overrides):
    """The kinodynamic family's IPConfig of the JAX package's tools
    (train_warmstart.py:48-57, warmstart_compare.py:39-43, kino_battery.py
    ``base``, cascade_sweep.py:58): monotone barrier rule (loqo loses on
    this family), hybrid Hessian, refine 3, delta_c 1e-6, tol 2e-4, cri.
    tune_sweep.py:45-49 and diag_conv.py:57-61 solve srbm_lcp from the same
    base."""
    from ..solver.ip import IPConfig

    kw = dict(max_iter=max_iter, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
              refine_steps=3, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri")
    kw.update(overrides)
    return IPConfig(**kw)


def srbm_config(**overrides):
    """The srbm_lcp base IPConfig of conv_battery.py:45-58,
    fail_taxonomy.py:45-50 and iter_bench.py:48-61: :func:`kino_config`
    with one refinement sweep, the shift ladder (0, 1) and 4 line-search
    candidates."""
    return kino_config(**{"refine_steps": 1, "ladder_scales": (0.0, 1.0), "n_linesearch": 4,
                          **overrides})


def legacy_ics(B: int, seed: int = 0):
    """B drops of the diagnostics tools' numpy sampler (the JAX package's
    conv_battery.py:22-33, and the "legacy" branches of diag_conv.py and
    tune_sweep.py): float32 arrays q0s, qd0s (B, 6), equal bit for bit."""
    rng = np.random.default_rng(seed)
    q0s = np.zeros((B, 6), np.float32)
    q0s[:, 2] = 0.6
    q0s[:, 3] = rng.uniform(-0.25, 0.25, B)
    q0s[:, 4] = rng.uniform(-np.pi / 3, np.pi / 3, B)
    q0s[:, 5] = rng.uniform(-0.25, 0.25, B)
    qd0s = np.zeros((B, 6), np.float32)
    qd0s[:, :3] = rng.uniform(-0.5, 0.5, (B, 3))
    qd0s[:, 3:5] = rng.uniform(-1, 1, (B, 2))
    qd0s[:, 5] = -rng.uniform(0.5, 5.0, B)
    return q0s, qd0s


def sampled_ics(B: int, seed: int = 0, sampler: str = "legacy"):
    """B drops (float32 numpy) of ``sampler``: "legacy" (:func:`legacy_ics`)
    or "reference", the distribution of the production script
    (``sample_drop_scenario``) drawn from a torch generator seeded ``seed``:
    JAX draws the same distribution from ``jax.random``, not the same drops."""
    if sampler == "legacy":
        return legacy_ics(B, seed)
    if sampler != "reference":
        raise KeyError(f"unknown sampler '{sampler}' (legacy | reference)")
    import torch

    from ..warmstart.reference import sample_drop_scenario

    q, qd = sample_drop_scenario(B, torch.Generator().manual_seed(seed), device="cpu")
    return q.numpy(), qd.numpy()


def counts():
    """(qd_inverse launches, IP batch iterations) so far in this process;
    a run's counts are the differences around it."""
    from ..tracing import counters

    c = counters()
    return c["qd_inverse.launches"], c["ip.iterations"]


def counted(before) -> dict:
    """The record entries of the counts since ``before`` (:func:`counts`)."""
    launches, iters = (b - a for a, b in zip(before, counts()))
    return {"qd_inverse_launches": launches, "batch_iterations": iters}


def to_host(*tensors):
    """The tensors as numpy arrays of their own dtypes, read from the device
    in one copy."""
    import torch

    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        a = flat[at:at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
        out.append(a.astype(str(t.dtype).removeprefix("torch.")))
    return out


def clock(device) -> float:
    """time.time() once the device's queued work has finished."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def write_record(path: str, record: dict) -> None:
    """Write ``record`` as indented JSON to ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {path}", flush=True)
