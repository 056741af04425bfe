"""The port's streaming solver and segmented solves (CPU, port only).

- an accounting run: batch 2, 4 scenarios, n_knots 13, with a retry chain;
  every scenario finishes and the stats dict has the JAX StreamingSolver's
  keys and ``n_retried``;
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
    # the JAX StreamingSolver's keys, and the port's count of retried drops
    assert set(stats) == STATS_KEYS | {"z", "n_retried"}
    assert stats["n_finished"] == 4 and 0 <= stats["n_retried"] <= 4
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


# ---- the captured iteration's preconditions and the eager fallback
def _kino_solver(n_knots=6, max_iter=60):
    cfg = IPConfig(max_iter=max_iter, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4,
                   sigma_max=1e5, refine_steps=3, relax_scale=1.0, delta_c=1e-6,
                   kkt_backend="cri", ladder_scales=(0.0, 1.0, 10.0, 1000.0), n_linesearch=12,
                   mu_strategy="monotone", corrector=0)
    return LandingSolver("kinodynamic", n_knots=n_knots, dtype=torch.float32, config=cfg,
                         guess="reference", device="cpu")


def _voltage_solver(n_knots=4):
    """The voltage kind, which always takes the dense KKT step."""
    return LandingSolver("kinodynamic_voltage", n_knots=n_knots, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("make", [_solver, _kino_solver, _voltage_solver],
                         ids=["srbm_lcp", "kinodynamic", "kinodynamic_voltage"])
def test_second_iteration_makes_no_tensor_from_host_data(make, monkeypatch):
    """After the first iteration (which builds the cached constants), an
    iteration calls neither ``torch.nonzero`` nor ``torch.tensor`` /
    ``torch.as_tensor`` / ``torch.from_numpy`` on host data: on a card each
    is a copy and a wait, which a CUDA graph's capture refuses."""
    from landing_controller_tpu_torch.parallel.stream import _Lanes

    ss = StreamingSolver(make(), batch=2, segment=2, sampler=_sampler)
    q, qd = (torch.as_tensor(a, dtype=torch.float32) for a in _sampler(2))
    lanes = ss._iterate(_Lanes.of(*ss.solver.init_lanes(q, qd, 0)))

    def refuse(name, real=None):
        def call(*args, **kw):
            if real is not None and isinstance(args[0], torch.Tensor):
                return real(*args, **kw)
            raise AssertionError(f"torch.{name} on the iteration's path")
        return call

    monkeypatch.setattr(torch, "tensor", refuse("tensor"))
    monkeypatch.setattr(torch, "as_tensor", refuse("as_tensor", torch.as_tensor))
    monkeypatch.setattr(torch, "from_numpy", refuse("from_numpy"))
    monkeypatch.setattr(torch, "nonzero", refuse("nonzero"))
    monkeypatch.setattr(torch.Tensor, "nonzero", refuse("nonzero"))
    after = ss._iterate(lanes)
    assert bool((after.state.it == 2).all())


def test_cpu_stream_runs_eagerly_and_still_exports(tmp_path):
    """On the CPU no iteration is captured: the graph cache stays empty and
    ``stream.eager_iterations`` counts every iteration of the run; the
    stream's step is then still traced and saved by ``export_step``."""
    from landing_controller_tpu_torch import tracing

    ss = StreamingSolver(_solver(retry_guess="reference"), batch=2, segment=3,
                         sampler=_sampler, attempt_iters=(6, 3))
    before = tracing.counters()
    ss.run(3)
    c = tracing.counters() - before
    assert ss._graphs == {}
    assert c["stream.graph_captures"] == 0 and c["stream.graph_replays"] == 0
    assert c["stream.eager_iterations"] == c["ip.iterations"] > 0
    path = str(tmp_path / "step.lcs")
    ss.export_step(path, 3)
    loaded = StreamingSolver(_solver(retry_guess="reference"), batch=2, segment=3,
                             sampler=_sampler, attempt_iters=(6, 3))
    assert loaded.load_step(path, 3)
    assert loaded._graphs == {}
