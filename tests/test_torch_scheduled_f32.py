"""contact_scheduled at N = 21: the port against the JAX package, f32 and f64.

At the JAX test's knot count (tests/test_scheduled.py) the f32 solve is decided
by rounding: the first two step lengths of the two packages agree to six
digits, the third system (taken after a step of length 0.0036) amplifies f32
rounding by about 1e5, and from there the outcome scatters on both sides (a
1e-6 relative change of the scenario moves either package between 19 and more
than 80 iterations; tests/probe_scheduled_f32.py).  So no logic differs, and
what can be held is:

- f32, before the amplifying system: barrier parameter, step length and KKT
  error of iterations 0 and 1 to 1e-4, and the iterate after them to 1e-4
  after scaling by max(1, |z|) (the two packages were 2e-7 apart).  This is
  the check that holds the port's f32 path to JAX's;
- f32, iteration 2: only a sanity bound, at tolerances that follow the
  amplification (3e-2, where the two step lengths were 8e-3 apart, each
  3e-3..5e-3 from the f64 run's, and the iterates 1.1e-2 apart after
  scaling): it catches a port that leaves by more than rounding explains,
  and no more;
- f64: barrier parameter, step length and KKT error through 24 iterations
  to 1e-6.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import solve as j_solve
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.solver.structured import make_structured_newton_step as j_make_step
from landing_controller_tpu_torch.api import LandingSolver

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

Q0 = np.array([0.0, 0.0, 0.26, 0.03, 0.1, -0.02], np.float32)
QD0 = np.array([0.1, -0.05, 0.0, 0.05, -0.05, -0.8], np.float32)


def _histories(jdtype, tdtype, iters):
    """(z, kkt, mu, alpha) after ``iters`` iterations, JAX then port."""
    js = JaxLandingSolver("contact_scheduled", n_knots=21, dtype=jdtype)
    js = JaxLandingSolver("contact_scheduled", n_knots=21, dtype=jdtype,
                          config=dataclasses.replace(js.config, kkt_backend="cri_ref",
                                                     max_iter=iters))
    prob = js.problem

    @jax.jit
    def jax_solve(q, qd):
        theta = js.build_params(q, qd)
        z0 = js._cold_guess(prob, theta)
        snlp = j_scale_problem(partial(prob.cost, theta=theta), partial(prob.eq, theta=theta),
                               partial(prob.ineq, theta=theta), z0, z_scale=js._z_scale)
        step = j_make_step(prob, theta, js.config, snlp)
        res = j_solve(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), js.config,
                      relax_mask=prob.relax_mask(), newton_step_fn=step)
        return snlp.from_scaled(res.z), res.kkt_history, res.mu_history, res.alpha_history

    out_j = tuple(np.asarray(a, np.float64) for a in
                  jax_solve(jnp.asarray(Q0, jdtype), jnp.asarray(QD0, jdtype)))
    ts = LandingSolver("contact_scheduled", n_knots=21, dtype=tdtype, device="cpu")
    ts = LandingSolver("contact_scheduled", n_knots=21, dtype=tdtype, device="cpu",
                       config=dataclasses.replace(ts.config, max_iter=iters))
    summary, state = ts._segment_impl(Q0[None], QD0[None], None, iters)
    assert int(state.it[0]) == iters
    out_t = tuple(a[0].double().numpy() for a in
                  (summary["z"], state.kkt_hist, state.mu_hist, state.alpha_hist))
    return out_j, out_t


def test_f32_iterate_after_two_iterations_matches_jax():
    (z_j, kkt_j, mu_j, a_j), (z_t, kkt_t, mu_t, a_t) = _histories(jnp.float32, torch.float32, 2)
    scale = np.maximum(1.0, np.abs(z_j))
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6)
    np.testing.assert_allclose(a_t, a_j, rtol=1e-4)
    np.testing.assert_allclose(kkt_t, kkt_j, rtol=1e-4)
    np.testing.assert_allclose(z_t / scale, z_j / scale, rtol=0, atol=1e-4)


def test_first_three_f32_iterations_match_jax():
    (z_j, kkt_j, mu_j, a_j), (z_t, kkt_t, mu_t, a_t) = _histories(jnp.float32, torch.float32, 3)
    scale = np.maximum(1.0, np.abs(z_j))
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6)
    np.testing.assert_allclose(a_t[:2], a_j[:2], rtol=1e-4)
    np.testing.assert_allclose(kkt_t[:2], kkt_j[:2], rtol=1e-4)
    # iteration 2 solves the amplifying system: a sanity bound only
    np.testing.assert_allclose(a_t[2], a_j[2], rtol=3e-2)
    np.testing.assert_allclose(kkt_t[2], kkt_j[2], rtol=3e-2)
    np.testing.assert_allclose(z_t / scale, z_j / scale, rtol=0, atol=3e-2)


def test_f64_histories_match_jax_through_24_iterations():
    if not jax.config.jax_enable_x64:
        pytest.skip("needs jax_enable_x64")
    (z_j, kkt_j, mu_j, a_j), (z_t, kkt_t, mu_t, a_t) = _histories(jnp.float64, torch.float64, 24)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6)
    np.testing.assert_allclose(a_t, a_j, rtol=1e-6)
    np.testing.assert_allclose(kkt_t, kkt_j, rtol=1e-6)
