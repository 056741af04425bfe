"""The port's "scan" and "cr" KKT backends against the JAX package (f64, CPU).

- factor/solve of the random quasi-definite block-tridiagonal systems of
  tests/test_block_tridiag.py and tests/test_cyclic_reduction.py, against the
  JAX functions and a dense solve, to 1e-10; ``ok`` False on an indefinite
  block; a batch of systems with a ladder axis;
- one structured Newton step of the srbm_lcp problem (n_knots 9) with each
  backend against the JAX step of the same backend, to 1e-10.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.ops import qd_block_tridiag_factor as j_bt_factor
from landing_controller_tpu.ops import qd_block_tridiag_solve as j_bt_solve
from landing_controller_tpu.ops.cyclic_reduction import cr_factor as j_cr_factor
from landing_controller_tpu.ops.cyclic_reduction import cr_solve as j_cr_solve
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.solver.scaling import landing_z_scale as j_landing_z_scale
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.solver.structured import make_structured_newton_step as j_make_step
from landing_controller_tpu.warmstart.reference import ballistic_guess as j_ballistic
from landing_controller_tpu_torch import ops
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.solver.structured import make_structured_newton_step
from landing_controller_tpu_torch.warmstart.reference import ballistic_guess

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

BACKENDS = {
    "scan": (ops.qd_block_tridiag_factor, ops.qd_block_tridiag_solve, j_bt_factor, j_bt_solve),
    "cr": (ops.cr_factor, ops.cr_solve, j_cr_factor, j_cr_solve),
}


def _random_qd_system(nb=7, np_=6, nd=3, seed=0):
    """The random systems of tests/test_block_tridiag.py (same generator)."""
    rng = np.random.default_rng(seed)
    bs = np_ + nd
    A = np.zeros((nb, bs, bs))
    C = rng.normal(size=(nb - 1, bs, bs)) * 0.3
    for k in range(nb):
        M = rng.normal(size=(np_, np_))
        P = M @ M.T + 3.0 * np.eye(np_)
        B = rng.normal(size=(nd, np_))
        D = np.diag(rng.uniform(0.5, 2.0, nd))
        A[k, :np_, :np_] = P
        A[k, np_:, :np_] = B
        A[k, :np_, np_:] = B.T
        A[k, np_:, np_:] = -D
    K = np.zeros((nb * bs, nb * bs))
    for k in range(nb):
        K[k * bs : (k + 1) * bs, k * bs : (k + 1) * bs] = A[k]
    for k in range(nb - 1):
        K[(k + 1) * bs : (k + 2) * bs, k * bs : (k + 1) * bs] = C[k]
        K[k * bs : (k + 1) * bs, (k + 1) * bs : (k + 2) * bs] = C[k].T
    return A, C, K


@pytest.mark.parametrize("backend", ["scan", "cr"])
@pytest.mark.parametrize("nb", [2, 7, 21])
def test_factor_solve_matches_jax_and_dense(backend, nb):
    factor, solve, j_factor, j_solve = BACKENDS[backend]
    A, C, K = _random_qd_system(nb=nb, seed=nb)
    b = np.random.default_rng(100 + nb).normal(size=(nb, A.shape[1]))
    fac = factor(torch.as_tensor(A), torch.as_tensor(C), 6, 3)
    assert bool(fac.ok)
    x = solve(fac, torch.as_tensor(b), 6, 3).numpy()
    x_j = np.asarray(jax.jit(lambda A, C, b: j_solve(j_factor(A, C, 6, 3), b, 6, 3))(
        jnp.asarray(A), jnp.asarray(C), jnp.asarray(b)))
    np.testing.assert_allclose(x, x_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(x, np.linalg.solve(K, b.reshape(-1)).reshape(nb, -1),
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("backend", ["scan", "cr"])
def test_inertia_failure_detected(backend):
    """An indefinite primal block flips ok, per system of a batch, as in JAX."""
    factor, solve, j_factor, _ = BACKENDS[backend]
    A, C, _ = _random_qd_system(seed=2)
    bad = A.copy()
    bad[3, 0, 0] = -50.0
    assert not bool(jax.jit(lambda A, C: j_factor(A, C, 6, 3).ok)(jnp.asarray(bad),
                                                                   jnp.asarray(C)))
    fac = factor(torch.as_tensor(np.stack([A, bad])), torch.as_tensor(np.stack([C, C])), 6, 3)
    assert fac.ok.tolist() == [True, False]
    # the failed system's factor is NaN, as the JAX one is
    x = solve(fac, torch.zeros(2, 7, 9, dtype=torch.float64), 6, 3)
    assert torch.isfinite(x[0]).all() and not torch.isfinite(x[1]).all()


@pytest.mark.parametrize("backend", ["scan", "cr"])
def test_leading_axes_lanes_and_candidates(backend):
    """(lanes, candidates) leading axes: each system as on its own."""
    factor, solve, _, _ = BACKENDS[backend]
    systems = [_random_qd_system(nb=9, seed=s) for s in range(6)]
    A = torch.as_tensor(np.stack([s[0] for s in systems])).reshape(2, 3, 9, 9, 9)
    C = torch.as_tensor(np.stack([s[1] for s in systems])).reshape(2, 3, 8, 9, 9)
    b = torch.as_tensor(np.random.default_rng(7).normal(size=(2, 3, 9, 9)))
    fac = factor(A, C, 6, 3)
    assert fac.ok.shape == (2, 3) and bool(fac.ok.all())
    x = solve(fac, b, 6, 3).reshape(6, 9, 9).numpy()
    for i, (_, _, K) in enumerate(systems):
        np.testing.assert_allclose(x[i], np.linalg.solve(K, b.reshape(6, -1)[i].numpy())
                                   .reshape(9, 9), rtol=1e-9, atol=1e-9)
    picked = fac.select(lambda t: t[torch.arange(2), torch.tensor([2, 0])])
    assert picked.ok.shape == (2,)


Q0 = np.array([0.0, 0.0, 0.6, 0.05, 0.3, -0.05])
QD0 = np.array([0.1, -0.2, 0.1, 0.2, -0.1, -2.0])
KW = dict(max_iter=1, hessian_mode="hybrid", mu_min=1e-6, tol=1e-4, sigma_max=1e8,
          refine_steps=1, relax_scale=1.0, delta_c=1e-8, ladder_scales=(0.0, 1.0, 10.0))


def _scaled_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(1.0, np.abs(b))
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("backend", ["scan", "cr"])
def test_structured_newton_step_matches_jax_backend(backend):
    js = JaxLandingSolver("srbm_lcp", n_knots=9, dtype=jnp.float64,
                          config=JaxIPConfig(kkt_backend=backend, **KW))
    ts = LandingSolver("srbm_lcp", n_knots=9, dtype=torch.float64,
                       config=IPConfig(kkt_backend=backend, **KW), device="cpu")
    prob = js.problem
    n, me, mi = prob.n_vars, prob.n_eq, prob.n_ineq
    rng = np.random.default_rng(4)
    L = 2  # lane 0: Gauss-Newton Hessian, lane 1: exact Hessian
    dz0 = 0.01 * rng.standard_normal((L, n))
    y = 0.01 * rng.standard_normal((L, me))
    lam = rng.uniform(0.001, 0.1, (L, mi))
    s = rng.uniform(0.01, 1.0, (L, mi))
    sigma = np.minimum(lam / s, KW["sigma_max"])
    mu = np.array([0.05, 0.001])
    use_exact = np.array([False, True])
    rhs_z = rng.standard_normal((L, n))
    rhs_y = 0.1 * rng.standard_normal((L, me))
    delta = np.array([1e-2, 3e-3])

    @jax.jit
    def jax_step(dz0, y, lam, sigma, mu, use_exact, rhs_z, rhs_y, delta):
        theta = js.build_params(jnp.asarray(Q0), jnp.asarray(QD0))
        z0 = j_ballistic(prob, theta)
        snlp = j_scale_problem(partial(prob.cost, theta=theta), partial(prob.eq, theta=theta),
                               partial(prob.ineq, theta=theta), z0,
                               z_scale=j_landing_z_scale(prob))
        step = j_make_step(prob, theta, js.config, snlp)

        def one(dz0, y, lam, sigma, mu, ue, rz, ry, d):
            dz, dy, du, _ = step(snlp.to_scaled(z0) + dz0, y, lam, sigma, mu, ue, None, None,
                                 rz, ry, d)
            return dz, dy, du

        return jax.vmap(one)(dz0, y, lam, sigma, mu, use_exact, rhs_z, rhs_y, delta)

    dz_j, dy_j, du_j = jax_step(dz0, y, lam, sigma, mu, use_exact, rhs_z, rhs_y, delta)

    t = lambda a: torch.as_tensor(a)  # noqa: E731
    theta = ts.build_params(t(np.stack([Q0, Q0])), t(np.stack([QD0, QD0])))
    z0 = ballistic_guess(ts.problem, theta)
    snlp = ts.scaled_problem(theta, z0)
    step = make_structured_newton_step(ts.problem, theta, ts.config, snlp)
    dz_t, dy_t, du_t, resolve = step(snlp.to_scaled(z0) + t(dz0), t(y), t(lam), t(sigma), t(mu),
                                     t(use_exact), None, None, t(rhs_z), t(rhs_y), t(delta))
    assert np.isfinite(np.asarray(dz_j)).all()
    _scaled_close(dz_t, dz_j, 1e-10)
    _scaled_close(dy_t, dy_j, 1e-10)
    np.testing.assert_array_equal(du_t.numpy(), np.asarray(du_j))
    dz_r, _ = resolve(t(rhs_z), t(rhs_y))
    torch.testing.assert_close(dz_r, dz_t, rtol=0, atol=0)
