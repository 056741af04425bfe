"""The first five interior-point iterates of the port's default dense
solver (kinodynamic_voltage, f64, N=6, CPU) against the JAX package.

The JAX solve (its default dense Newton step, max_iter 5) against the port's
``LandingSolver("kinodynamic_voltage")`` with the same settings.  The first
KKT systems (Gauss-Newton Hessian, shift 1e-6) are so ill-conditioned that a
one-part-in-1e15 nudge of the scenario moves the first step length by 1e-6
(relative) and the fifth iterate by 2e-5 in the port and 4e-4 in JAX, so
the rule of tests/test_torch_iterates_kino.py applies: the barrier
parameters are held to 1e-8, the step lengths and the fifth iterate (scaled
by max(1, |z|)) to the larger of 1e-8 and 20 times the port's own change
under that nudge (read: iterate gap 1.3e-5, own change 2.3e-5; ROADMAP §3).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import solve as j_solve
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu_torch.api import LandingSolver

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

Q0 = np.array([0.0, 0.0, 0.55, 0.05, 0.2, -0.02])
QD0 = np.array([0.1, -0.05, 0.0, 0.05, -0.05, -1.0])


def test_first_five_dense_iterates_match_jax():
    js = JaxLandingSolver("kinodynamic_voltage", n_knots=6, dtype=jnp.float64)
    js_cfg = dataclasses.replace(js.config, max_iter=5)
    cfg = LandingSolver("kinodynamic_voltage", n_knots=6, dtype=torch.float64, device="cpu").config
    ts = LandingSolver("kinodynamic_voltage", n_knots=6, dtype=torch.float64, device="cpu",
                       config=dataclasses.replace(cfg, max_iter=5))
    prob = js.problem

    @jax.jit
    def jax_solve(q, qd):
        theta = js.build_params(q, qd)
        z0 = js._cold_guess(prob, theta)
        snlp = j_scale_problem(partial(prob.cost, theta=theta), partial(prob.eq, theta=theta),
                               partial(prob.ineq, theta=theta), z0, z_scale=js._z_scale)
        res = j_solve(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), js_cfg,
                      relax_mask=prob.relax_mask())
        return snlp.from_scaled(res.z), res.iterations, res.mu_history, res.alpha_history

    z_j, it_j, mu_j, alpha_j = (np.asarray(a) for a in jax_solve(jnp.asarray(Q0), jnp.asarray(QD0)))
    summary, state = ts._segment_impl(Q0[None], QD0[None], None, 5)
    assert int(state.it[0]) == int(it_j) == 5 and (alpha_j > 0).all()
    np.testing.assert_allclose(state.mu_hist[0].numpy(), mu_j, rtol=1e-8, atol=1e-12)
    # the port's own sensitivity: the same solve from q0 * (1 + 1e-15)
    nudged, st_n = ts._segment_impl(Q0[None] * (1.0 + 1e-15), QD0[None], None, 5)
    alpha_t = state.alpha_hist[0].numpy()
    own_alpha = float(np.abs(st_n.alpha_hist[0].numpy() - alpha_t).max())
    gap_alpha = float(np.abs(alpha_t - alpha_j).max())
    assert gap_alpha <= max(1e-8, 20.0 * own_alpha), (gap_alpha, own_alpha)
    scale = np.maximum(1.0, np.abs(z_j))
    z_t = summary["z"][0].numpy()
    own = float(np.abs(nudged["z"][0].numpy() / scale - z_t / scale).max())
    gap = float(np.abs(z_t / scale - z_j / scale).max())
    print(f"[reading] voltage 5 iterates: alpha gap {gap_alpha:.3e}, own {own_alpha:.3e}; "
          f"iterate gap {gap:.3e}, own {own:.3e}")
    assert gap <= max(1e-8, 20.0 * own), (gap, own)
