"""A converged f32 solve of the port against the JAX package.

The gentle drop of tests/test_pallas_blocks.py (n_knots 13, cri backend)
solved end to end on the CPU by both packages.  f32 iterates drift apart
chaotically over tens of Newton iterations, so the comparison is of
outcomes: both converge, the port's solution is feasible to 1e-3, and the
costs agree to 1e-2 relative to the JAX cost (the cost is ~3e-7, so an
absolute tolerance would pass any cost).
"""

import jax.numpy as jnp
import numpy as np
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.solver.ip import IPConfig

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

KW = dict(max_iter=120, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
          refine_steps=2, relax_scale=1.0, delta_c=1e-6)


def test_converged_f32_solve_matches_jax():
    q0 = [0.0, 0.0, 0.45, 0.0, 0.0, 0.0]
    qd0 = [0.0, 0.0, 0.0, 0.0, 0.0, -0.5]
    sol_j = JaxLandingSolver(
        "srbm_lcp", n_knots=13, dtype=jnp.float32, config=JaxIPConfig(kkt_backend="cri_ref", **KW)
    ).solve(jnp.asarray(q0, jnp.float32), jnp.asarray(qd0, jnp.float32))
    ts = LandingSolver("srbm_lcp", n_knots=13, dtype=torch.float32,
                       config=IPConfig(kkt_backend="cri", **KW), device="cpu")
    sol = ts.solve(q0, qd0)
    assert bool(sol_j.converged) and bool(sol.converged)
    assert float(sol.constr_viol) <= 1e-3
    assert torch.isfinite(sol.z).all()
    # feasibility of the port's answer, checked on the unscaled problem
    theta = ts.build_params(torch.tensor([q0]), torch.tensor([qd0]))
    E = ts.problem.eq(sol.z[None], theta)
    g = ts.problem.ineq(sol.z[None], theta)
    viol = max(float(E.abs().max()), float(torch.clamp(-g, min=0).max()))
    assert viol <= 1e-3, viol
    c, c_j = float(sol.cost), float(sol_j.cost)
    assert abs(c - c_j) <= 1e-2 * abs(c_j) + 1e-12, (c, c_j)
    assert sol.X.shape == (13, 12) and sol.U.shape == (12, 24)
    np.testing.assert_allclose(sol.X[0].numpy(), np.array(q0 + qd0), atol=1e-3)
