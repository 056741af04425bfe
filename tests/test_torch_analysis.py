"""The port's analysis modules against the JAX package (CPU).

- warm-start comparison: ``nn_warmstart_guess`` on the comparison's batch
  (the JAX harness test's untrained 8-wide network and unit statistics)
  matches JAX to 1e-10 in f64 and 1e-6 in f32; around one stub solve on
  both sides (compiling JAX's N=21 kinodynamic solves takes minutes on a
  CPU, and the dict is built from their timings and convergence flags
  alone) the result dicts have the same keys, shapes and dtypes and equal
  convergence rows (2 trials of 2 drops); the port's harness also runs
  over its own solves (3 iterations, one trial);
- ``nn_vs_nlp``: JAX's function, handed the port's NLP solution through a
  stub solve, returns the port's dict: the same keys, every entry to 1e-10
  (f64);
- foot positions: ``touchdown_indices`` and ``touchdown_analysis`` equal
  JAX's on random trajectories; ``sweep_foot_positions`` over the port's ccc
  solver gives JAX's ``analyze_solution`` of the same solutions bit for
  bit; the reference-sweep loader reads a .mat file as JAX's does;
- both plots write their files.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from landing_controller_tpu.analysis import foot_positions as j_fp
from landing_controller_tpu.analysis import nn_validation as j_nnv
from landing_controller_tpu.analysis import warmstart_bench as j_wsb
from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.warmstart import nn as jnn
from landing_controller_tpu_torch import convert
from landing_controller_tpu_torch.analysis import (foot_positions, nn_vs_nlp, plot_nn_overlay,
                                                   plot_warmstart_comparison, warmstart_bench,
                                                   warmstart_comparison)
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.warmstart.nn import nn_warmstart_guess

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = jnn.N_KNOTS


def _jax_net():
    """The JAX harness test's untrained network and unit statistics."""
    params = jnn.init_mlp(jax.random.PRNGKey(0), hidden=8, depth=2)
    stats = jnn.DataStats(
        mean_input=jnp.zeros(9), std_input=jnp.ones(9),
        mean_X=jnp.zeros((N, 12)), std_X=jnp.ones((N, 12)),
        mean_c=jnp.zeros((N - 1, 12)), std_c=jnp.ones((N - 1, 12)),
        mean_jpos=jnp.zeros((N - 1, 12)), std_jpos=jnp.ones((N - 1, 12)),
        mass=jnp.asarray(8.25))
    return params, stats


def _port_net(params, stats, dtype):
    return convert.mlp_from_numpy([np.asarray(w) for w in params.weights],
                                  [np.asarray(b) for b in params.biases],
                                  {f: np.asarray(getattr(stats, f))
                                   for f in jnn.DataStats._fields}, dtype=dtype, device="cpu")


def _drops():
    """(2 trials, 2 drops, 6) as the JAX harness test draws them."""
    rng = np.random.default_rng(0)
    q0s = np.zeros((2, 2, 6), np.float32)
    q0s[..., 2] = 0.5
    qd0s = np.zeros((2, 2, 6), np.float32)
    qd0s[..., 5] = -rng.uniform(1.0, 2.0, (2, 2)).astype(np.float32)
    return q0s, qd0s


CFG_KW = dict(max_iter=3, hessian_mode="gn", relax_scale=1.0)


def _port_solvers():
    cfg = IPConfig(kkt_backend="cri", **CFG_KW)
    return (LandingSolver("kinodynamic", dtype=torch.float32, config=cfg, device="cpu"),
            LandingSolver("srbm_lcp", n_knots=N, dtype=torch.float32, config=cfg, device="cpu"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_nn_guess_of_the_comparison_batch_matches_jax(dtype):
    params, stats = _jax_net()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    params = jax.tree_util.tree_map(lambda a: a.astype(jdt), params)
    stats = jnn.DataStats(*(jnp.asarray(a, jdt) for a in stats))
    q0s, qd0s = _drops()
    jprob = JaxLandingSolver("kinodynamic", dtype=jdt).problem
    want = jax.vmap(lambda q, qd: jnn.nn_warmstart_guess(params, stats, q, qd, jprob))(
        jnp.asarray(q0s.reshape(4, 6), jdt), jnp.asarray(qd0s.reshape(4, 6), jdt))
    mlp, st = _port_net(params, stats, tdt)
    prob = LandingSolver("kinodynamic", dtype=tdt, device="cpu").problem
    got = nn_warmstart_guess(mlp, st, torch.as_tensor(q0s.reshape(4, 6), dtype=tdt),
                             torch.as_tensor(qd0s.reshape(4, 6), dtype=tdt), prob)
    # f64: 1e-10; f32: 1e-6 relative to the entry (GRFs reach 10^2 N and f32
    # resolves 1.2e-7 of each, carried through three layers)
    tol = dict(rtol=0, atol=1e-10) if dtype == "float64" else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _stub_solve(q, qd, z0=None):
    """One stub solve for both packages, batched or per drop: a z that
    depends on the drop and a convergence flag that differs between drops."""
    Sol = collections.namedtuple("Sol", "z converged")
    return Sol(z=q.sum(-1) + qd.sum(-1), converged=qd[..., 5] < -1.5)


def test_comparison_dict_matches_jax(monkeypatch):
    """Both harnesses around the same stub solves: the same keys, timing
    rows of the same shapes and dtypes, and the same convergence rows."""
    params, stats = _jax_net()
    q0s, qd0s = _drops()
    kino, srbm = _port_solvers()
    mlp, st = _port_net(params, stats, torch.float32)
    seen = []

    def nn_ws(q, qd, z0=None):
        seen.append(z0)
        return _stub_solve(q, qd)

    monkeypatch.setattr(kino, "_solve_impl", nn_ws)
    monkeypatch.setattr(kino, "solve_batch", _stub_solve)
    monkeypatch.setattr(warmstart_bench, "make_cascade",
                        lambda s1, s2: lambda q, qd: (_stub_solve(q, qd),) * 2)
    got = warmstart_comparison(kino, srbm, mlp, st, q0s, qd0s, n_trials=2)
    # nn_ws starts from the network's guess of its batch (untimed pass, 2 trials)
    assert len(seen) == 3 and all(z0.shape == (2, kino.problem.n_vars) for z0 in seen)

    jkino = JaxLandingSolver("kinodynamic", dtype=jnp.float32)
    jsrbm = JaxLandingSolver("srbm_lcp", n_knots=N, dtype=jnp.float32)
    monkeypatch.setattr(jkino, "_solve_impl", _stub_solve)
    monkeypatch.setattr(jkino, "solve_batch", jax.jit(jax.vmap(_stub_solve)))
    monkeypatch.setattr(j_wsb, "make_cascade",
                        lambda s1, s2: lambda q, qd: (_stub_solve(q, qd),) * 2)
    want = j_wsb.warmstart_comparison(jkino, jsrbm, params, stats, q0s, qd0s, n_trials=2)

    assert got.keys() == want.keys() and got["batch_size"] == want["batch_size"] == 2
    for part in ("t", "convergence"):
        assert got[part].keys() == want[part].keys()
        for k in got[part]:
            assert got[part][k].shape == want[part][k].shape == (2,)
            assert got[part][k].dtype == want[part][k].dtype
    for k in want["convergence"]:
        np.testing.assert_array_equal(got["convergence"][k], want["convergence"][k], err_msg=k)
    assert {float(v) for v in got["convergence"]["cold"]} != {0.0}


def test_comparison_runs_the_port_solvers(tmp_path):
    """The harness over the port's own solves (3 iterations, one trial),
    and its plot."""
    params, stats = _jax_net()
    q0s, qd0s = _drops()
    kino, srbm = _port_solvers()
    mlp, st = _port_net(params, stats, torch.float32)
    got = warmstart_comparison(kino, srbm, mlp, st, q0s, qd0s, n_trials=1)
    assert all(v.shape == (1,) and (v > 0).all() for v in got["t"].values())
    assert all(((v >= 0) & (v <= 1)).all() for v in got["convergence"].values())
    out = tmp_path / "ws.png"
    assert plot_warmstart_comparison(got, save_path=str(out)) == str(out) and out.exists()


def test_nn_vs_nlp_matches_jax(monkeypatch, tmp_path):
    params, stats = _jax_net()
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64), params)
    stats = jnn.DataStats(*(jnp.asarray(a, jnp.float64) for a in stats))
    cfg = IPConfig(kkt_backend="cri", **CFG_KW)
    kino = LandingSolver("kinodynamic", dtype=torch.float64, config=cfg, device="cpu")
    mlp, st = _port_net(params, stats, torch.float64)
    q, qd = [0.0, 0.0, 0.5, 0.05, -0.1, 0.0], [0.1, 0.0, 0.0, 0.2, 0.0, -1.5]
    got = nn_vs_nlp(mlp, st, kino, q, qd)

    jkino = JaxLandingSolver("kinodynamic", dtype=jnp.float64)
    Sol = collections.namedtuple("Sol", "X U jpos converged")
    nlp = Sol(got["X_nlp"], got["U_nlp"], got["jpos_nlp"], np.asarray(got["converged"]))
    monkeypatch.setattr(jkino, "solve", lambda *a: nlp)
    want = j_nnv.nn_vs_nlp(params, stats, jkino, jnp.asarray(q), jnp.asarray(qd))
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(np.asarray(v, np.float64), np.asarray(want[k], np.float64),
                                   rtol=0, atol=1e-10, err_msg=k)
    assert got["X_nlp"].shape == (N, 12) and got["jpos_nn"].shape == (N - 1, 12)
    fig = plot_nn_overlay(got, save_path=str(tmp_path / "nn.png"))
    assert (tmp_path / "nn.png").exists() and fig is not None


def _trajectory(rng, n=12):
    X = rng.standard_normal((12, n))
    p = rng.standard_normal((12, n - 1))
    f = rng.uniform(0.0, 0.9, (12, n - 1))
    for leg, k in ((0, 3), (1, 0), (3, n - 2)):  # leg 2 never lands
        f[3 * leg + 2, k:] = rng.uniform(2.0, 50.0, n - 1 - k)
    return X, p, f


def test_touchdown_analysis_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(3):
        X, p, f = _trajectory(rng)
        np.testing.assert_array_equal(foot_positions.touchdown_indices(f),
                                      j_fp.touchdown_indices(f))
        got, want = foot_positions.touchdown_analysis(X, p, f), j_fp.touchdown_analysis(X, p, f)
        assert got.td.tolist()[2] == -1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_sweep_foot_positions_analyses_the_batch():
    cfg = IPConfig(max_iter=6, kkt_backend="cri")
    ccc = LandingSolver("ccc", n_knots=9, dtype=torch.float64, config=cfg, device="cpu")
    q, qd = [0.0, 0.0, 0.45, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]
    vals = [-0.5, 0.0, 0.5]
    out = foot_positions.sweep_foot_positions(ccc, q, qd, 3, vals)
    qd_b = np.tile(qd, (3, 1))
    qd_b[:, 3] = vals
    sols = ccc.solve_batch(np.tile(q, (3, 1)), qd_b)
    assert [o["value"] for o in out] == vals
    assert [o["converged"] for o in out] == sols.converged.tolist()
    JSol = collections.namedtuple("JSol", "X U")
    for i, o in enumerate(out):
        want = j_fp.analyze_solution(JSol(sols.X[i].numpy(), sols.U[i].numpy()))
        for a, b in zip(o["analysis"], want):
            np.testing.assert_array_equal(a, b)  # the same numpy code on the same solution


def test_load_reference_sweep_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    rec = {"X_star": rng.standard_normal((12, 5)), "q_star": rng.standard_normal((12, 4)),
           "f_star": rng.standard_normal((12, 4)), "p_star": rng.standard_normal((12, 4)),
           "td": np.array([2.0, 3.0, 1.0, 4.0])}
    arr = np.empty((2,), dtype=object)
    arr[0], arr[1] = rec, {**rec, "td": np.array([1.0, 1.0, 2.0, 2.0])}
    path = str(tmp_path / "sweep.mat")
    scipy.io.savemat(path, {"opt_sol": arr})
    got, want = foot_positions.load_reference_sweep(path), j_fp.load_reference_sweep(path)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["td"].tolist() == [1, 2, 0, 3]  # 1-based indices made 0-based
