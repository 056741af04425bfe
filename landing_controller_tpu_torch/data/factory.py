"""Batched training-data factory for the learned warm start.

The reference generates samples one at a time through a three-stage native
solve cascade with a human accept/reject gate
(generate_training_data_automated.m:36-221).  Here the factory solves
batches of sampled drop conditions, through the SRBM -> kinodynamic cascade
or the streaming solver, and the convergence mask replaces the human gate
(failed scenarios are dropped, not fatal).

Input per sample: the 9-D initial condition [rpy, omega, v]
(generate_training_data_automated.m:208-213); output: the kinodynamic
solution (X, U, jpos) = 972 numbers, plus touchdown indices after
normalization (976 total).
"""

from __future__ import annotations

import numpy as np
import torch

from .._tree import to_numpy
from ..warmstart.reference import sample_drop_scenario


def _dataset(q, qd, X, U, jpos):
    """The factory's dict of numpy arrays from accepted samples."""
    q, qd = to_numpy(q), to_numpy(qd)
    return {
        "inputs": np.concatenate([q[:, 3:6], qd], axis=1),
        "X": to_numpy(X),
        "U": to_numpy(U),
        "jpos": to_numpy(jpos),
    }


def generate_training_data(cascade_fn, n_samples: int, generator: torch.Generator | None = None,
                           batch_size: int = 32):
    """Run the cascade over sampled scenarios and collect accepted solutions.

    cascade_fn: (q_init (B, 6), qd_init (B, 6)) -> (kino_solution,
    srbm_solution) (see warmstart.cascade.make_cascade).  Scenarios are drawn
    in float32 by :func:`..warmstart.reference.sample_drop_scenario` from
    ``generator`` (a fresh one seeded 0 when None).  Returns a dict of numpy
    arrays with only the converged samples:
    {"inputs" (M,9), "X" (M,N,12), "U" (M,N-1,24), "jpos" (M,N-1,12)}.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    parts = []
    n_done = 0
    while n_done < n_samples:
        b = min(batch_size, n_samples - n_done)
        q0s, qd0s = sample_drop_scenario(b, generator, device="cpu")
        sol2, _ = cascade_fn(q0s, qd0s)
        ok = sol2.converged
        ok_host = ok.cpu()
        parts.append(_dataset(q0s[ok_host], qd0s[ok_host], sol2.X[ok], sol2.U[ok], sol2.jpos[ok]))
        n_done += b
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def generate_training_data_streaming(
    solver, n_samples: int, generator: torch.Generator | None = None, batch: int = 64,
    segment: int = 50, max_wall_s: float | None = None,
):
    """Streaming training-data factory: a scenario pool with continuous lane
    refill (parallel/stream.py, collect_z) instead of the batched cascade,
    so throughput follows the average iteration count, not the slowest lane.

    solver: a kinodynamic LandingSolver (cold solves; its convergence mask
    replaces the reference's human gate).  Each attempt gets the solver's
    full iteration budget: the StreamingSolver's default deadlines (100, 150)
    are sized for srbm_lcp, and kinodynamic cold solves run about twice as
    long.  Returns the same dict as :func:`generate_training_data`.
    """
    from ..parallel.stream import StreamingSolver

    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def sampler(n):
        q, qd = sample_drop_scenario(n, generator, device="cpu")
        return q.numpy(), qd.numpy()

    mi = solver.config.max_iter
    ss = StreamingSolver(solver, batch=batch, segment=segment, sampler=sampler, collect_z=True,
                         attempt_iters=(mi, mi))
    stats = ss.run(n_samples, max_wall_s=max_wall_s)
    ok = stats["converged_mask"]
    ics = stats["ics"][ok]
    v = solver.problem.unpack(torch.as_tensor(stats["z"][ok]))
    return _dataset(ics[:, :6], ics[:, 6:12], v.X, v.U, v.jpos)
