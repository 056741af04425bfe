"""The port's dense Newton step against the JAX package (f64, CPU).

- ``_solve_kkt`` on random systems, batched over lanes, against the JAX
  function system by system, to 1e-10: a positive definite H0, an indefinite
  H0 on which the ladder picks a later candidate, one on which no candidate
  succeeds (the emergency shift), and a Je with a duplicated row (redundant
  equality: the Schur complement is singular up to its shift, 1e-7 after
  equilibration, so a one-part-in-1e15 change of H0 moves the port's own
  dz by about 3e-10 and its dy by 5e-3: that lane is held to 20 times the
  port's own change of each, and to 1e-8 at most, as ROADMAP §3 records);
- the toy problems of tests/test_solver.py solved by the port's ``solve``
  with its default (dense) Newton step: complementarity with the exact and
  the Gauss-Newton Hessian, the simplex QP, an infeasible start and a warm
  start, each with JAX's iteration count and solution to 1e-6;
- a batch of 8 lanes through the port's ``solve_batch`` against the JAX
  ``solve_batch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.solver import solve as j_solve
from landing_controller_tpu.solver.ip import _solve_kkt as j_solve_kkt
from landing_controller_tpu.solver.ip import solve_batch as j_solve_batch
from landing_controller_tpu_torch.solver.ip import IPConfig, _solve_kkt, solve, solve_batch

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N, ME = 12, 4


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T / n + np.eye(n)


def _systems():
    """(name, H0, Je, delta_last) of four lanes."""
    rng = np.random.default_rng(0)
    out = []
    H = _spd(rng, N)
    out.append(("spd", H, rng.standard_normal((ME, N)), 1e-2))
    e = rng.standard_normal(N)
    e /= np.linalg.norm(e)
    out.append(("indefinite", _spd(rng, N) - 3.0 * np.outer(e, e), rng.standard_normal((ME, N)),
                0.1))
    H = np.eye(N)
    H[0, 1] = H[1, 0] = 10.0  # positive diagonal, eigenvalue -9
    out.append(("emergency", H, rng.standard_normal((ME, N)), 1e-5))
    Je = rng.standard_normal((ME, N))
    Je[3] = Je[1]
    out.append(("duplicate row", _spd(rng, N), Je, 1e-2))
    return out


def test_solve_kkt_matches_jax_per_lane():
    cfg = IPConfig(refine_steps=2)
    jcfg = JaxIPConfig(refine_steps=2)
    systems = _systems()
    rng = np.random.default_rng(1)
    rz = rng.standard_normal((len(systems), N))
    ry = rng.standard_normal((len(systems), ME))
    H0 = np.stack([s[1] for s in systems])
    Je = np.stack([s[2] for s in systems])
    dl = np.array([s[3] for s in systems])
    t = torch.as_tensor
    dz, dy, du, resolve = _solve_kkt(t(H0), t(Je), t(rz), t(ry), t(dl), cfg)
    step = jax.jit(lambda H, J, a, b, d: j_solve_kkt(H, J, a, b, d, jcfg)[:3])
    # the port's own sensitivity: the same solve with H0 nudged by 1e-15
    dz_n, dy_n, _, _ = _solve_kkt(t(H0 * (1.0 + 1e-15)), t(Je), t(rz), t(ry), t(dl), cfg)
    for i, (name, *_rest) in enumerate(systems):
        dz_j, dy_j, du_j = (np.asarray(a) for a in step(H0[i], Je[i], rz[i], ry[i], dl[i]))
        assert np.isfinite(dz_j).all(), name
        assert du[i].item() == du_j, name
        tol_z = tol_y = 1e-10
        if name == "duplicate row":
            own_z = float((dz_n[i] - dz[i]).abs().max())
            own_y = float((dy_n[i] - dy[i]).abs().max())
            assert own_y > 1e-6  # ill-conditioned, as the case intends
            tol_z = min(max(1e-10, 20.0 * own_z), 1e-8)
            tol_y = min(max(1e-10, 20.0 * own_y), 1e-8)
        np.testing.assert_allclose(dz[i].numpy(), dz_j, rtol=0, atol=tol_z, err_msg=name)
        np.testing.assert_allclose(dy[i].numpy(), dy_j, rtol=0, atol=tol_y, err_msg=name)
    # the cases exercise what they are named for
    ladder = [cfg.delta_w] + [s * dl[1] for s in cfg.ladder_scales[1:]]
    assert du[0].item() == cfg.delta_w
    assert du[1].item() in ladder[1:]
    assert du[2].item() == 1e3 * dl[2] + 1e3
    # the factors are reused: the same right-hand side gives the same step
    dz_r, dy_r = resolve(t(rz), t(ry))
    torch.testing.assert_close(dz_r, dz, rtol=0, atol=0)
    torch.testing.assert_close(dy_r, dy, rtol=0, atol=0)


# ---- the toy problems of tests/test_solver.py, as row functions for the port
def _toy_rows():
    def cost(z):
        return (z[:, 0] - 2.0) ** 2 + (z[:, 1] - 1.0) ** 2

    def eq(z):
        return (z[:, 0] + z[:, 1] - 2.0)[:, None]

    def ineq(z):
        return torch.stack([z[:, 0], z[:, 1], 0.1 - z[:, 0] * z[:, 1]], -1)

    return cost, eq, ineq


def _toy_jax():
    cost = lambda z: (z[0] - 2.0) ** 2 + (z[1] - 1.0) ** 2  # noqa: E731
    eq = lambda z: jnp.array([z[0] + z[1] - 2.0])  # noqa: E731
    ineq = lambda z: jnp.array([z[0], z[1], 0.1 - z[0] * z[1]])  # noqa: E731
    return cost, eq, ineq


def _compare(res_t, res_j, z_tol=1e-6):
    assert bool(res_j.converged) and bool(res_t.converged[0])
    assert int(res_t.iterations[0]) == int(res_j.iterations)
    np.testing.assert_allclose(res_t.z[0].numpy(), np.asarray(res_j.z), rtol=0, atol=z_tol)


@pytest.mark.parametrize("mode", ["exact", "gn"])
def test_toy_complementarity(mode):
    z0 = np.array([0.5, 0.5])
    res_j = jax.jit(lambda z: j_solve(*_toy_jax(), z, JaxIPConfig(max_iter=80, hessian_mode=mode)))(
        jnp.asarray(z0))
    res_t = solve(*_toy_rows(), torch.as_tensor(z0)[None], IPConfig(max_iter=80, hessian_mode=mode))
    _compare(res_t, res_j)
    xs = (2 + np.sqrt(4 - 0.4)) / 2
    np.testing.assert_allclose(res_t.z[0].numpy(), [xs, 2 - xs], atol=1e-3)


def test_simplex_qp():
    n = 10
    res_j = jax.jit(lambda z: j_solve(lambda z: jnp.sum(z * z), lambda z: jnp.array([jnp.sum(z) - 1.0]),
                                      lambda z: z, z, IPConfig_j(max_iter=60)))(jnp.full(n, 0.3))
    res_t = solve(lambda z: (z * z).sum(-1), lambda z: (z.sum(-1) - 1.0)[:, None], lambda z: z,
                  torch.full((1, n), 0.3, dtype=torch.float64), IPConfig(max_iter=60))
    _compare(res_t, res_j)
    np.testing.assert_allclose(res_t.z[0].numpy(), np.full(n, 0.1), atol=1e-4)


def IPConfig_j(**kw):  # noqa: N802
    return JaxIPConfig(**kw)


def test_infeasible_start():
    z0 = np.array([1.5, 0.5])
    res_j = jax.jit(lambda z: j_solve(*_toy_jax(), z, JaxIPConfig(max_iter=80)))(jnp.asarray(z0))
    res_t = solve(*_toy_rows(), torch.as_tensor(z0)[None], IPConfig(max_iter=80))
    _compare(res_t, res_j)


def test_warm_start_fewer_iterations():
    cfg, cfg_ws = IPConfig(max_iter=80), IPConfig(max_iter=80, mu_init=1e-4)
    z0 = np.array([0.5, 0.5])
    res = solve(*_toy_rows(), torch.as_tensor(z0)[None], cfg)
    res2 = solve(*_toy_rows(), res.z, cfg_ws, lam0=res.lam, y0=res.y, s0=res.s)
    j_cold = jax.jit(lambda z: j_solve(*_toy_jax(), z, JaxIPConfig(max_iter=80)))(jnp.asarray(z0))
    j_warm = jax.jit(lambda z, l, y, s: j_solve(*_toy_jax(), z, JaxIPConfig(max_iter=80, mu_init=1e-4),
                                                lam0=l, y0=y, s0=s))(
        j_cold.z, j_cold.lam, j_cold.y, j_cold.s)
    _compare(res, j_cold)
    _compare(res2, j_warm)
    assert int(res2.iterations[0]) <= int(res.iterations[0])


def test_batch_of_eight_lanes_matches_jax_solve_batch():
    """8 lanes, each with its own start and its own shifted target (a per-lane
    theta), through solve_batch on both sides."""
    rng = np.random.default_rng(0)
    z0s = rng.uniform(0.2, 1.4, (8, 2))
    thetas = rng.uniform(-0.2, 0.2, 8)

    def cost_t(z, th):
        return (z[:, 0] - 2.0 - th) ** 2 + (z[:, 1] - 1.0) ** 2

    def cost_j(z, theta):
        return (z[0] - 2.0 - theta) ** 2 + (z[1] - 1.0) ** 2

    eq_t, ineq_t = _toy_rows()[1:]
    eq_j, ineq_j = _toy_jax()[1:]
    res_t = solve_batch(cost_t, lambda z, th: eq_t(z), lambda z, th: ineq_t(z),
                        torch.as_tensor(z0s), IPConfig(max_iter=80), theta=torch.as_tensor(thetas),
                        theta_axes=0)
    fn = j_solve_batch(cost_j, lambda z, theta: eq_j(z), lambda z, theta: ineq_j(z), None,
                       JaxIPConfig(max_iter=80), theta_axes=0)
    res_j = jax.jit(fn)(jnp.asarray(z0s), jnp.asarray(thetas))
    assert np.asarray(res_j.converged).all() and bool(res_t.converged.all())
    np.testing.assert_array_equal(res_t.iterations.numpy(), np.asarray(res_j.iterations))
    np.testing.assert_allclose(res_t.z.numpy(), np.asarray(res_j.z), rtol=0, atol=1e-6)
