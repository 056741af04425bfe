"""The port's first five kinodynamic interior-point iterates against JAX.

The kinodynamic family's solver settings (monotone barrier rule, no
corrector, hybrid Hessian, the default 4-candidate ladder and 12 line-search
candidates, reference cold guess) at f64 and 6 knots, on the CPU: the JAX
solve with kkt_backend="cri_ref" and max_iter=5 against the port's.

The kinodynamic KKT systems of the first iterations (Gauss-Newton Hessian,
primal shift delta_w = 1e-6) are ill-conditioned: changing one input of the
port by one part in 1e15 moves its own fifth iterate by 1e-7 to 1e-3,
depending on the scenario (4e-7 on this one), so no two implementations can
agree to 1e-8 there.  What is held: the barrier parameter of every
iteration to 1e-8; the step length of the first iteration to 1e-8 and of all
five to 1e-5 (relative); and the fifth iterate z (scaled by
max(1, |z|)) to the larger of 1e-8 and 20 times the port's own change under
that one-part-in-1e15 perturbation, and to 1e-5 at most.
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
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

KW = dict(max_iter=5, hessian_mode="hybrid", mu_min=1e-6, tol=1e-4, sigma_max=1e8,
          refine_steps=3, relax_scale=1.0, delta_c=1e-6)


def test_first_five_kinodynamic_iterates_match_jax():
    q0 = np.array([0.0, 0.0, 0.55, 0.05, -0.2, 0.03])
    qd0 = np.array([0.2, -0.1, 0.3, 0.3, -0.2, -1.5])
    assert IPConfig(**KW).mu_strategy == "monotone" and IPConfig(**KW).corrector == 0
    js = JaxLandingSolver("kinodynamic", n_knots=6, dtype=jnp.float64,
                          config=JaxIPConfig(kkt_backend="cri_ref", **KW))
    ts = LandingSolver("kinodynamic", n_knots=6, dtype=torch.float64,
                       config=IPConfig(kkt_backend="cri", **KW), device="cpu")
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
        return snlp.from_scaled(res.z), res.iterations, res.mu_history, res.alpha_history

    z_j, it_j, mu_j, alpha_j = (np.asarray(a) for a in jax_solve(jnp.asarray(q0), jnp.asarray(qd0)))
    summary, state = ts._segment_impl(q0[None], qd0[None], None, 5)
    assert int(state.it[0]) == int(it_j) == 5
    assert (alpha_j > 0).all()  # every one of the five steps moved
    np.testing.assert_allclose(state.mu_hist[0].numpy(), mu_j, rtol=1e-8, atol=1e-12)
    alpha_t = state.alpha_hist[0].numpy()
    np.testing.assert_allclose(alpha_t[:1], alpha_j[:1], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(alpha_t, alpha_j, rtol=1e-5, atol=1e-12)
    # the port's own sensitivity: the same solve from q0 * (1 + 1e-15)
    nudged, _ = ts._segment_impl(q0[None] * (1.0 + 1e-15), qd0[None], None, 5)
    scale = np.maximum(1.0, np.abs(z_j))
    z_t = summary["z"][0].numpy()
    own = float(np.abs(nudged["z"][0].numpy() / scale - z_t / scale).max())
    gap = float(np.abs(z_t / scale - z_j / scale).max())
    assert gap <= min(max(1e-8, 20.0 * own), 1e-5), (gap, own)
