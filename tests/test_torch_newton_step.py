"""One structured Newton step of the port against the JAX package at f64.

The same scaled srbm_lcp problem (n_knots 13), the same iterate,
multipliers, barrier weights and right-hand sides (numpy-seeded), through
landing_controller_tpu.solver.structured with kkt_backend="cri_ref" and
through the port's "cri" step on the CPU, for both Hessian branches of the
hybrid mode (Gauss-Newton and exact).  dz, dy and the chosen inertia shift
agree to 1e-10 after scaling by max(1, |x|).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.solver.scaling import landing_z_scale as j_landing_z_scale
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.solver.structured import make_structured_newton_step as j_make_step
from landing_controller_tpu.warmstart.reference import ballistic_guess as j_ballistic
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.solver.structured import make_structured_newton_step
from landing_controller_tpu_torch.warmstart.reference import ballistic_guess

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

Q0 = np.array([0.0, 0.0, 0.6, 0.05, 0.3, -0.05])
QD0 = np.array([0.1, -0.2, 0.1, 0.2, -0.1, -2.0])
KW = dict(max_iter=1, hessian_mode="hybrid", mu_min=1e-6, tol=1e-4, sigma_max=1e8,
          refine_steps=1, relax_scale=1.0, delta_c=1e-8, ladder_scales=(0.0, 1.0, 10.0))


def _scaled_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(1.0, np.abs(b))
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol)


def test_newton_step_matches_jax_cri_ref():
    js = JaxLandingSolver("srbm_lcp", n_knots=13, dtype=jnp.float64,
                          config=JaxIPConfig(kkt_backend="cri_ref", **KW))
    ts = LandingSolver("srbm_lcp", n_knots=13, dtype=torch.float64,
                       config=IPConfig(kkt_backend="cri", **KW), device="cpu")
    prob = js.problem
    n, me, mi = prob.n_vars, prob.n_eq, prob.n_ineq
    rng = np.random.default_rng(3)
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
    assert np.isfinite(np.asarray(dz_j)).all() and np.isfinite(np.asarray(dy_j)).all()
    _scaled_close(dz_t, dz_j, 1e-10)
    _scaled_close(dy_t, dy_j, 1e-10)
    # lane 1 needs the third ladder candidate: the per-lane pick is exercised
    np.testing.assert_array_equal(du_t.numpy(), np.asarray(du_j))
    assert du_t[1] == 10 * delta[1]
    # resolve() re-solves with the same factors: same rhs, same answer
    dz_r, dy_r = resolve(t(rhs_z), t(rhs_y))
    torch.testing.assert_close(dz_r, dz_t, rtol=0, atol=0)
    torch.testing.assert_close(dy_r, dy_t, rtol=0, atol=0)
