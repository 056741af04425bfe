"""One structured Newton step per problem kind, port against JAX, at f64.

For the kinodynamic, sliding, ccc and contact-scheduled layouts (6 knots;
the scheduled one also at its default 16 with a schedule in which legs
touch down at different knots and one lifts off again): the same scaled
problem, iterate, multipliers, barrier weights and right-hand sides
(numpy-seeded) through landing_controller_tpu.solver.structured with
kkt_backend="cri_ref" and through the port's "cri" step on the CPU.  Lane 0
takes the Gauss-Newton branch of the hybrid Hessian, lane 1 the exact one;
the ccc case also runs hessian_mode="gn", where the running cost's Hessian
is all the curvature there is.  dz, dy and the chosen inertia shift agree to
1e-10 after scaling by max(1, |x|).  The ladder starts at the carried shift
(scales 1, 10, 100) and not at delta_w = 1e-6: with that shift the
Gauss-Newton lane of the kinodynamic system has a condition number near
1e10, and a 1e-15 relative change of its inputs moves dz by 1e-6.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.solver.scaling import landing_z_scale as j_landing_z_scale
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.solver.structured import _layout as j_layout
from landing_controller_tpu.solver.structured import make_structured_newton_step as j_make_step
from landing_controller_tpu.warmstart.reference import initial_guess_from_reference as j_guess
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.solver.structured import _layout, make_structured_newton_step
from landing_controller_tpu_torch.warmstart.reference import initial_guess_from_reference

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

# low enough for the scheduled variant's state box (z <= 0.4)
Q0 = np.array([0.0, 0.0, 0.3, 0.05, 0.2, -0.05])
QD0 = np.array([0.1, -0.2, 0.1, 0.2, -0.1, -1.0])
KW = dict(max_iter=1, mu_min=1e-6, tol=1e-4, sigma_max=1e8, refine_steps=1, relax_scale=1.0,
          delta_c=1e-6, ladder_scales=(1.0, 10.0, 100.0))


def _schedule(n):
    cs = np.ones((n - 1, 4))
    cs[:2, :] = 0.0
    cs[2, 1] = 0.0
    cs[n // 2 :, 2] = 0.0
    return cs


def _scaled_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(1.0, np.abs(b))
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("kind,n", [("kinodynamic", 6), ("sliding", 6), ("ccc", 6),
                                    ("contact_scheduled", 6), ("contact_scheduled", 16)])
def test_layout_matches_jax(kind, n):
    js = JaxLandingSolver(kind, n_knots=n, dtype=jnp.float64)
    ts = LandingSolver(kind, n_knots=n, dtype=torch.float64, device="cpu")
    lj, lt = j_layout(js.problem), _layout(ts.problem)
    assert set(lj) == set(lt)
    for k in lj:
        np.testing.assert_array_equal(lt[k], lj[k])


@pytest.mark.parametrize("kind,n,mode", [
    ("kinodynamic", 6, "hybrid"), ("sliding", 6, "hybrid"), ("ccc", 6, "hybrid"),
    ("ccc", 6, "gn"), ("contact_scheduled", 6, "hybrid"), ("contact_scheduled", 16, "hybrid"),
])
def test_newton_step_matches_jax_cri_ref(kind, n, mode):
    over = {"cs": _schedule(n)} if kind == "contact_scheduled" else {}
    js = JaxLandingSolver(kind, n_knots=n, dtype=jnp.float64, theta_overrides=over,
                          config=JaxIPConfig(kkt_backend="cri_ref", hessian_mode=mode, **KW))
    ts = LandingSolver(kind, n_knots=n, dtype=torch.float64, theta_overrides=over,
                       config=IPConfig(kkt_backend="cri", hessian_mode=mode, **KW), device="cpu")
    prob = js.problem
    nv, me, mi = prob.n_vars, prob.n_eq, prob.n_ineq
    assert (ts.problem.n_vars, ts.problem.n_eq, ts.problem.n_ineq) == (nv, me, mi)
    rng = np.random.default_rng(3)
    L = 2  # lane 0: Gauss-Newton Hessian, lane 1: exact Hessian (hybrid mode)
    dz0 = 0.01 * rng.standard_normal((L, nv))
    y = 0.01 * rng.standard_normal((L, me))
    lam = rng.uniform(0.001, 0.1, (L, mi))
    s = rng.uniform(0.01, 1.0, (L, mi))
    sigma = np.minimum(lam / s, KW["sigma_max"])
    mu = np.array([0.05, 0.001])
    use_exact = np.array([False, True])
    rhs_z = rng.standard_normal((L, nv))
    rhs_y = 0.1 * rng.standard_normal((L, me))
    delta = np.array([1e-2, 3e-3])

    @jax.jit
    def jax_step(dz0, y, lam, sigma, mu, use_exact, rhs_z, rhs_y, delta):
        theta = js.build_params(jnp.asarray(Q0), jnp.asarray(QD0))
        z0 = j_guess(prob, theta)
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
    z0 = initial_guess_from_reference(ts.problem, theta)
    snlp = ts.scaled_problem(theta, z0)
    step = make_structured_newton_step(ts.problem, theta, ts.config, snlp)
    dz_t, dy_t, du_t, resolve = step(snlp.to_scaled(z0) + t(dz0), t(y), t(lam), t(sigma), t(mu),
                                     t(use_exact), None, None, t(rhs_z), t(rhs_y), t(delta))
    assert np.isfinite(np.asarray(dz_j)).all() and np.isfinite(np.asarray(dy_j)).all()
    assert dz_t.shape == (L, nv) and dy_t.shape == (L, me)
    _scaled_close(dz_t, dz_j, 1e-10)
    _scaled_close(dy_t, dy_j, 1e-10)
    np.testing.assert_array_equal(du_t.numpy(), np.asarray(du_j))
    # resolve() re-solves with the same factors: same rhs, same answer
    dz_r, dy_r = resolve(t(rhs_z), t(rhs_y))
    torch.testing.assert_close(dz_r, dz_t, rtol=0, atol=0)
    torch.testing.assert_close(dy_r, dy_t, rtol=0, atol=0)
