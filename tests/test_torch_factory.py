"""The port's training-data factory against the JAX package's (CPU, f64,
srbm_lcp at N=11: a size at which about half of the sampled drops converge
within 40 iterations).

- ``generate_training_data_streaming``: every harvested row is the port's
  own solution of its scenario, from the first attempt (``solve_batch``)
  where that converged, else from the retry family's guess (the streaming
  solver re-solves a failed scenario in place), to 1e-8; and JAX's
  streaming factory, handed the port's streaming run (its StreamingSolver
  replaced by one that returns the port's stats), builds the same dict,
  bit for bit, from the same solver settings;
- ``generate_training_data`` over ``make_cascade`` and over a stub cascade:
  JAX's factory, with its sampler replaced by the port's draws and its
  cascade by one that returns the port cascade's outputs for each drop,
  builds the same dict bit for bit (row layout, filtering, order across
  batches, dtypes).  The JAX cascade's own solves are not compiled here:
  that takes minutes on a CPU, and the dict is built after them.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.data import factory as j_factory
from landing_controller_tpu.parallel import stream as j_stream
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.data import (generate_training_data,
                                               generate_training_data_streaming)
from landing_controller_tpu_torch.parallel.stream import StreamingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.warmstart.cascade import make_cascade
from landing_controller_tpu_torch.warmstart.reference import sample_drop_scenario

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = 11
CFG_KW = dict(max_iter=40, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-6,
              tol=1e-4, sigma_max=1e8, refine_steps=1, relax_scale=1.0, delta_c=1e-6,
              ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", corrector=1)
Sol = collections.namedtuple("Sol", "converged X U jpos")


def _solver(**kw):
    return LandingSolver("srbm_lcp", n_knots=N, dtype=torch.float64,
                         config=IPConfig(kkt_backend="cri", **{**CFG_KW, **kw}),
                         guess="ballistic", device="cpu")


def _assert_same_dict(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _schema(d):
    return {k: (v.dtype, v.shape[1:]) for k, v in d.items()}


def _jax_schema(nj):
    """The dict JAX's generate_training_data builds, from a stub cascade of
    f64 solutions of the port's shapes."""
    def stub(q, qd):
        sol = Sol(converged=qd[5] < -1.0, X=jnp.zeros((N, 12)) + q[2], U=jnp.zeros((N - 1, 24)),
                  jpos=jnp.zeros((N - 1, nj)))
        return sol, sol

    return j_factory.generate_training_data(stub, 8, key=jax.random.PRNGKey(0), batch_size=4)


def _rows_of(data, q, qd):
    """Index of each harvested row's scenario among (q, qd)."""
    ins = np.concatenate([q.numpy()[:, 3:6], qd.numpy()], 1)
    idx = [int(np.flatnonzero((ins == row).all(1))[0]) for row in data["inputs"]]
    assert len(set(idx)) == len(idx)
    return idx


@pytest.fixture(scope="module")
def streamed():
    """The port's streaming factory on 4 drops, with the StreamingSolver's
    constructor arguments and the stats of its run."""
    seen = {}
    init, run = StreamingSolver.__init__, StreamingSolver.run

    def recording_init(self, solver, **kw):
        seen["kw"] = kw
        init(self, solver, **kw)

    def recording_run(self, *a, **kw):
        seen["stats"] = run(self, *a, **kw)
        return seen["stats"]

    s = _solver()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(StreamingSolver, "__init__", recording_init)
        mp.setattr(StreamingSolver, "run", recording_run)
        data = generate_training_data_streaming(s, 4, generator=torch.Generator().manual_seed(0),
                                                batch=4, segment=25)
    return s, data, seen


def test_streaming_rows_are_the_solvers_solutions(streamed):
    s, data, _ = streamed
    n = 4
    q, qd = sample_drop_scenario(n, torch.Generator().manual_seed(0), device="cpu")
    # the first attempt's and the retry family's solves of every scenario, in one batch
    theta = s.build_params(q, qd)
    z0 = torch.cat([s._cold_guess(theta, 0), s._cold_guess(theta, 1)])
    both = s._solve_impl(torch.cat([q, q]), torch.cat([qd, qd]), z0=z0)
    conv = both.converged.reshape(2, n)
    want = [i for i in range(n) if bool(conv[:, i].any())]
    idx = _rows_of(data, q, qd)
    assert sorted(idx) == want and len(want) >= 1
    for row, i in enumerate(idx):
        lane = i if bool(conv[0, i]) else n + i
        for name in ("X", "U", "jpos"):
            np.testing.assert_allclose(data[name][row], getattr(both, name)[lane].numpy(), rtol=0,
                                       atol=1e-8, err_msg=name)


def test_streaming_dict_equals_jax_on_the_same_run(streamed, monkeypatch):
    """JAX's streaming factory, handed the port's run, unpacks, filters and
    lays out the same rows: the same dict, bit for bit."""
    _, data, seen = streamed
    jax_seen = {}

    class Replay:
        def __init__(self, solver, **kw):
            jax_seen["kw"] = kw

        def run(self, n, max_wall_s=None):
            return seen["stats"]

    monkeypatch.setattr(j_stream, "StreamingSolver", Replay)
    jsolver = JaxLandingSolver("srbm_lcp", n_knots=N, dtype=jnp.float64, guess="ballistic",
                               config=JaxIPConfig(kkt_backend="cri_ref", **CFG_KW))
    want = j_factory.generate_training_data_streaming(jsolver, 4, batch=4, segment=25)
    assert len(want["X"]) >= 1
    _assert_same_dict(data, want)
    for k in ("batch", "segment", "collect_z", "attempt_iters"):
        assert seen["kw"][k] == jax_seen["kw"][k], k


def _recording(fn, calls):
    def wrapped(q, qd):
        out = fn(q, qd)
        calls.append((q, qd, out[0]))
        return out

    return wrapped


def _jax_factory_on(calls, n_samples, batch_size, monkeypatch):
    """JAX's generate_training_data on the port's draws and cascade outputs:
    its sampler maps each of its keys to the port's drop of the same place in
    the stream, and its cascade returns the port cascade's output for a drop."""
    Q = jnp.asarray(torch.cat([c[0] for c in calls]).numpy())
    QD = jnp.asarray(torch.cat([c[1] for c in calls]).numpy())
    out = {f: jnp.asarray(torch.cat([getattr(c[2], f) for c in calls]).numpy())
           for f in Sol._fields}
    key = jax.random.PRNGKey(0)
    offsets = range(0, n_samples, batch_size)
    keys = jnp.concatenate([jax.random.split(jax.random.fold_in(key, o),
                                             min(batch_size, n_samples - o)) for o in offsets])

    def sample(k):
        i = jnp.argmax(jnp.all(keys == k, axis=-1))
        return Q[i], QD[i]

    def cascade(q, qd):
        i = jnp.argmax(jnp.all(Q == q, axis=-1))
        sol = Sol(**{f: v[i] for f, v in out.items()})
        return sol, sol

    monkeypatch.setattr(j_factory, "sample_drop_scenario", sample)
    return j_factory.generate_training_data(cascade, n_samples, key=key, batch_size=batch_size)


def test_cascade_rows_are_the_cascades_solutions(monkeypatch):
    calls = []
    # a 12-iteration stage 1 only seeds stage 2, whose rows are kept
    cascade = _recording(make_cascade(_solver(max_iter=12), _solver()), calls)
    data = generate_training_data(cascade, 4, generator=torch.Generator().manual_seed(1),
                                  batch_size=4)
    (q, qd, sol2), = calls
    want_q, want_qd = sample_drop_scenario(4, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(q, want_q) and torch.equal(qd, want_qd)
    idx = _rows_of(data, q, qd)
    assert idx == [int(i) for i in torch.nonzero(sol2.converged)[:, 0]] and len(idx) >= 1
    for name in ("X", "U", "jpos"):
        np.testing.assert_array_equal(data[name], getattr(sol2, name)[idx].numpy(), err_msg=name)
    _assert_same_dict(data, _jax_factory_on(calls, 4, 4, monkeypatch))


def test_cascade_factory_batches(monkeypatch):
    """n_samples in batches of batch_size (the last one partial), drawn in
    turn from one generator; JAX's factory on the same draws and the same
    stub outputs keeps the same rows in the same order."""
    def stub(q, qd):
        B = q.shape[0]
        sol = Sol(converged=qd[:, 5] < -2.0, X=q[:, None, :].double().repeat(1, N, 2),
                  U=torch.zeros(B, N - 1, 24, dtype=torch.float64),
                  jpos=torch.zeros(B, N - 1, 0, dtype=torch.float64))
        return sol, sol

    calls = []
    data = generate_training_data(_recording(stub, calls), 10,
                                  generator=torch.Generator().manual_seed(2), batch_size=4)
    assert [c[0].shape[0] for c in calls] == [4, 4, 2]
    g = torch.Generator().manual_seed(2)
    q = torch.cat([sample_drop_scenario(b, g, device="cpu")[0] for b in (4, 4, 2)])
    assert torch.equal(torch.cat([c[0] for c in calls]), q)
    assert 0 < len(data["X"]) < 10
    _assert_same_dict(data, _jax_factory_on(calls, 10, 4, monkeypatch))


def test_kinodynamic_harvest_keeps_the_joint_angles():
    """A kinodynamic harvest has JAX's schema, jpos with 12 angles per knot;
    an empty harvest (two iterations, nothing converges) keeps it."""
    kino = LandingSolver("kinodynamic", n_knots=N, dtype=torch.float64, device="cpu",
                         config=IPConfig(max_iter=2, kkt_backend="cri"))
    data = generate_training_data_streaming(kino, 2, batch=2, segment=2)
    assert data["X"].shape[0] == 0
    assert _schema(data) == _schema(_jax_schema(12))
    assert _schema(data)["jpos"] == (np.dtype(np.float64), (N - 1, 12))
