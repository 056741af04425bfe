"""The port's first five interior-point iterates against the JAX package.

The bench's solver settings (loqo barrier rule, one corrector, ladder
(0, 1), 4 line-search candidates, ballistic cold guess, production dt
schedule) at f64 and n_knots 21, on the CPU: the JAX solve with
kkt_backend="cri_ref" and max_iter=5 against the port's.  The iterate z
(scaled by max(1, |z|)), the KKT error, the barrier parameter and the step
length of every iteration agree to 1e-8.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.solver import solve as j_solve
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.solver.structured import make_structured_newton_step as j_make_step
from landing_controller_tpu.warmstart.reference import DT_PRODUCTION
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

KW = dict(max_iter=5, hessian_mode="hybrid", mu_init=0.3, kappa_mu=0.5, mu_min=1e-5,
          tol=1e-4, sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6,
          ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", stall_window=40,
          stall_min_iter=40, corrector=1)


def test_first_five_iterates_match_jax():
    q0 = np.array([0.0, 0.0, 0.6, 0.1, -0.4, 0.05])
    qd0 = np.array([0.2, -0.1, 0.3, 0.5, -0.3, -2.5])
    over = {"dt": DT_PRODUCTION}
    js = JaxLandingSolver("srbm_lcp", dtype=jnp.float64, guess="ballistic",
                          config=JaxIPConfig(kkt_backend="cri_ref", **KW), theta_overrides=over)
    ts = LandingSolver("srbm_lcp", dtype=torch.float64, guess="ballistic",
                       config=IPConfig(kkt_backend="cri", **KW), theta_overrides=over,
                       device="cpu")
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
        return (snlp.from_scaled(res.z), res.iterations, res.kkt_history, res.mu_history,
                res.alpha_history)

    z_j, it_j, kkt_j, mu_j, alpha_j = (np.asarray(a) for a in jax_solve(jnp.asarray(q0),
                                                                        jnp.asarray(qd0)))
    summary, state = ts._segment_impl(q0[None], qd0[None], None, 5)
    assert int(state.it[0]) == int(it_j) == 5
    scale = np.maximum(1.0, np.abs(z_j))
    np.testing.assert_allclose(summary["z"][0].numpy() / scale, z_j / scale, rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.kkt_hist[0].numpy(), kkt_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(state.mu_hist[0].numpy(), mu_j, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(state.alpha_hist[0].numpy(), alpha_j, rtol=1e-8, atol=1e-12)
