"""The port's streaming solver and segmented solves (CPU, port only).

- an accounting run: batch 2, 4 scenarios, n_knots 13, with a retry chain;
  every scenario finishes and the stats dict has the JAX StreamingSolver's keys;
- the segmented solve is a pure re-chunking of the monolithic one;
- constructor validation of the attempt deadlines; the default sampler;
- ``run(progress_cb=...)`` at B=2 over a pool of 5 (lanes refilled): the JAX
  StreamingSolver's run loop, replaying the port's per-segment results,
  calls its callback with the same sequence of stats, and the last call
  holds the returned stats.  The JAX package's own step is not compiled
  here (minutes on a CPU); what is held is the loop around it.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.parallel import stream as j_stream
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.parallel import StreamingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

STATS_KEYS = {"wall_s", "n_started", "n_finished", "n_converged", "convergence_rate",
              "converged_per_sec", "iters_p50", "iters_p90", "ics", "converged_mask", "viol"}


def _solver(dtype=torch.float32, max_iter=60, **kw):
    cfg = IPConfig(max_iter=max_iter, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4,
                   sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6,
                   kkt_backend="cri", ladder_scales=(0.0, 1.0), n_linesearch=4,
                   mu_strategy="loqo", corrector=1)
    return LandingSolver("srbm_lcp", n_knots=13, dtype=dtype, config=cfg, guess="ballistic",
                         device="cpu", **kw)


def _sampler(n):
    rng = np.random.default_rng(0)
    q = np.zeros((n, 6))
    q[:, 2] = 0.5
    q[:, 3:6] = rng.uniform(-0.1, 0.1, (n, 3))
    qd = np.zeros((n, 6))
    qd[:, 5] = -rng.uniform(0.3, 1.0, n)
    return q, qd


def test_streaming_accounting():
    ss = StreamingSolver(_solver(retry_guess="reference"), batch=2, segment=15,
                         sampler=_sampler, attempt_iters=(30, 15), collect_z=True)
    stats = ss.run(4)
    assert set(stats) == STATS_KEYS | {"z"}
    assert stats["n_finished"] == 4
    assert stats["n_converged"] == int(stats["converged_mask"].sum())
    assert stats["ics"].shape == (4, 12) and stats["viol"].shape == (4,)
    assert np.isfinite(stats["viol"]).all() and np.isfinite(stats["z"]).all()
    assert stats["z"].shape == (4, ss.solver.problem.n_vars)
    # a scenario's count sums its attempts: at most the two deadlines
    assert 0 < stats["iters_p50"] <= stats["iters_p90"] <= 30 + 15
    # the deadlines rule: a finished unconverged scenario used its retry
    assert stats["convergence_rate"] > 0


def test_segmented_equals_monolithic():
    s = _solver(dtype=torch.float64, max_iter=12)
    q, qd = _sampler(2)
    mono = s.solve_batch(q, qd)
    summary, st = s._segment_impl(q, qd, None, 5)
    for _ in range(2):
        summary, st = s._segment_impl(q, qd, st, 5)
    torch.testing.assert_close(summary["z"], mono.z, rtol=0, atol=0)
    torch.testing.assert_close(summary["iterations"], mono.iterations)
    assert bool(st.done.all())  # at the iteration cap every lane is done


def test_attempt_deadlines_need_guess_families():
    s = _solver()  # guess + the default alternate = 2 families
    with pytest.raises(ValueError):
        StreamingSolver(s, batch=2, sampler=_sampler, attempt_iters=(10, 10, 10))
    StreamingSolver(s, batch=2, sampler=_sampler, attempt_iters=(10, 10))
    # no sampler given: the drop sampler, from a generator seeded 0
    assert StreamingSolver(s, batch=2).sampler(1)[0].shape == (1, 6)


def _jax_callbacks(results, P, B, n_attempts):
    """JAX's ``StreamingSolver.run(P, progress_cb=...)`` with its step
    replaced by one that returns the port's packed results of each segment
    in turn (the last one again for the extra step JAX dispatches while it
    reads); returns (the callback's stats, the returned stats)."""
    ss = object.__new__(j_stream.StreamingSolver)
    ss.batch, ss.sampler, ss.n_attempts, ss.collect_z = B, _sampler, n_attempts, False
    ss.solver = types.SimpleNamespace(dtype=jnp.float32)
    k = iter(range(10**6))
    ss.get_step = lambda P_: lambda *args: types.SimpleNamespace(
        res=results[min(next(k), len(results) - 1)])
    ss._pool_states = lambda qc, qdc, v: jnp.zeros(1)
    ss._make_carry = lambda *args: None
    calls = []
    return calls, ss.run(P, progress_cb=calls.append)


def test_progress_cb_follows_jax():
    ss = StreamingSolver(_solver(retry_guess="reference"), batch=2, segment=6,
                         sampler=_sampler, attempt_iters=(12, 6))
    step = ss.get_step(5)
    results = []

    def recording(pool, carry):
        carry = step(pool, carry)
        results.append(carry.res.cpu().numpy())
        return carry

    ss._step_cache[5] = recording
    calls = []
    stats = ss.run(5, progress_cb=calls.append)
    assert stats["n_finished"] == 5 and len(calls) == len(results) >= 3
    j_calls, j_stats = _jax_callbacks(results, 5, 2, ss.n_attempts)
    seq = [(c["n_finished"], c["n_converged"]) for c in calls]
    assert seq == [(c["n_finished"], c["n_converged"]) for c in j_calls]
    assert seq == sorted(seq) and seq[0][0] < 5  # cumulative, lanes refilled
    for got in (calls[-1], j_calls[-1], j_stats):
        for key in STATS_KEYS - {"wall_s", "converged_per_sec"}:
            np.testing.assert_array_equal(got[key], stats[key])
