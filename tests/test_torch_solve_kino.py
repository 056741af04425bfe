"""A converged f32 kinodynamic solve of the port against the JAX package.

A gentle drop (8 knots, the kinodynamic family's settings: monotone barrier
rule, no corrector, hybrid Hessian, refine 3, reference guess) solved end to
end on the CPU by both packages.  f32 iterates drift apart over tens of
Newton iterations, so the comparison is of outcomes: both converge, the
port's solution is feasible to 1e-3 on the unscaled problem, the costs agree
to 1e-2 relative to the JAX cost (the cost is ~6e-9, so an absolute
tolerance would pass any cost), and the largest joint torque agrees to 1e-2
relative.
"""

import jax.numpy as jnp
import numpy as np
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.dynamics.legs import leg_torques
from landing_controller_tpu_torch.solver.ip import IPConfig

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

KW = dict(max_iter=200, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
          refine_steps=3, relax_scale=1.0, delta_c=1e-6)


def test_converged_f32_kinodynamic_solve_matches_jax():
    q0 = [0.0, 0.0, 0.4, 0.02, 0.05, 0.0]
    qd0 = [0.0, 0.0, 0.0, 0.1, 0.0, -1.0]
    sol_j = JaxLandingSolver(
        "kinodynamic", n_knots=8, dtype=jnp.float32, config=JaxIPConfig(kkt_backend="cri_ref", **KW)
    ).solve(jnp.asarray(q0, jnp.float32), jnp.asarray(qd0, jnp.float32))
    ts = LandingSolver("kinodynamic", n_knots=8, dtype=torch.float32,
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
    assert sol.X.shape == (8, 12) and sol.U.shape == (7, 24)
    assert sol.jpos.shape == (7, 12) and sol.tau.shape == (7, 12)
    np.testing.assert_allclose(sol.X[0].numpy(), np.array(q0 + qd0), atol=1e-3)
    # the solution's torques are the Jacobian-transpose map of its own forces
    torch.testing.assert_close(
        sol.tau, leg_torques(ts.robot_params, sol.jpos, sol.X[:-1, 3:6], sol.U[:, 12:]))
    t, t_j = float(sol.tau.abs().max()), float(jnp.abs(sol_j.tau).max())
    assert 1.0 < t_j <= 28.0 and abs(t - t_j) <= 1e-2 * t_j, (t, t_j)
