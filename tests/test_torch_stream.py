"""The port's streaming solver and segmented solves (CPU, port only).

- an accounting run: batch 2, 4 scenarios, n_knots 13, with a retry chain;
  every scenario finishes and the stats dict has the JAX StreamingSolver's keys;
- the segmented solve is a pure re-chunking of the monolithic one;
- constructor validation of the attempt deadlines; the default sampler.
"""

import numpy as np
import pytest
import torch

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
