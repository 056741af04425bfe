"""The first five interior-point iterates of EEParamSolver's settings (dense
KKT path, Gauss-Newton Hessian, f64, CPU) against the JAX package.

The first step is extremely sensitive to rounding: the cost's curvature is
2e-8 I, so the Newton step is of order 1e8 along directions no inequality
row touches, and the fraction-to-boundary rule reads it through a
cancellation.  A one-part-in-1e15 random nudge of the initial guess moves
the port's first step length by 1e-4; the JAX package's own jit and eager
runs differ by 3e-3 there.  So the rule of tests/test_torch_iterates_kino.py
applies: the barrier parameters are held to 1e-8, the step lengths and the
fifth iterate (scaled by max(1, |z|)) to the larger of 1e-8 and 20 times the
port's own change under that nudge (ROADMAP §3 has the readings).

This file takes about two minutes on the CPU, most of it the JAX package's
compile of its dense eeParam solve.
"""

import dataclasses

import jax
import numpy as np
import torch

from landing_controller_tpu.api import EEParamSolver as JaxEEParamSolver
from landing_controller_tpu.problems import eeparam as j_ee
from landing_controller_tpu.solver import solve as j_solve
from landing_controller_tpu_torch.api import EEParamSolver
from landing_controller_tpu_torch.problems import eeparam as t_ee
from landing_controller_tpu_torch.solver.ip import solve
from landing_controller_tpu_torch.solver.scaling import scale_problem

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def test_first_five_iterates_match_jax():
    cfg_t = dataclasses.replace(EEParamSolver(dtype=torch.float64, device="cpu").config,
                                max_iter=5)
    cfg_j = dataclasses.replace(JaxEEParamSolver(dtype=jax.numpy.float64).config, max_iter=5)
    prob_j, prob_t = j_ee.eeparam_problem(), t_ee.eeparam_problem()
    base_j = j_ee.default_eeparam_params(jax.numpy.float64)
    th_j = dataclasses.replace(base_j, r_init=jax.numpy.asarray([0.0, 0.0, 0.55]),
                               rdot_init=jax.numpy.asarray([0.0, 0.0, -1.2]))
    th_t = dataclasses.replace(t_ee.default_eeparam_params(torch.float64, "cpu"),
                               r_init=torch.tensor([[0.0, 0.0, 0.55]], dtype=torch.float64),
                               rdot_init=torch.tensor([[0.0, 0.0, -1.2]], dtype=torch.float64))

    # the JAX solve on the port's row scales (equal to JAX's scale_problem's to
    # 1e-16 here; the JAX scaling pass would add half a minute of compile);
    # the variable scale is 1
    @jax.jit
    def jax_solve(theta, fs, es, gs):
        z0 = prob_j.initial_guess(theta)
        res = j_solve(lambda z: prob_j.cost(z, theta) * fs, lambda z: prob_j.eq(z, theta) * es,
                      lambda z: prob_j.ineq(z, theta) * gs, z0, cfg_j,
                      relax_mask=prob_j.relax_mask())
        return res.z, res.iterations, res.mu_history, res.alpha_history

    def port_solve(nudge=None):
        z0 = prob_t.initial_guess(th_t)
        if nudge is not None:
            z0 = z0 * (1.0 + nudge)
        snlp = scale_problem(prob_t, th_t, z0)
        res = solve(snlp.cost, snlp.eq, snlp.ineq, snlp.to_scaled(z0), cfg_t,
                    relax_mask=torch.as_tensor(prob_t.relax_mask()))
        return snlp.from_scaled(res.z)[0].numpy(), res

    snlp = scale_problem(prob_t, th_t, prob_t.initial_guess(th_t))
    scales = [a[0].numpy() for a in (snlp.f_scale, snlp.eq_scale, snlp.ineq_scale)]
    z_j, it_j, mu_j, alpha_j = (np.asarray(a) for a in jax_solve(th_j, *scales))
    z_t, res = port_solve()
    assert int(res.iterations[0]) == int(it_j) == 5 and (alpha_j > 0).all()
    np.testing.assert_allclose(res.mu_history[0].numpy(), mu_j, rtol=1e-8, atol=1e-12)
    # the port's own sensitivity: the initial guess nudged by one part in 1e15
    nudge = torch.as_tensor(1e-15 * np.random.default_rng(0).standard_normal(prob_t.n_vars))
    z_n, res_n = port_solve(nudge)
    alpha_t = res.alpha_history[0].numpy()
    own_alpha = float(np.abs(res_n.alpha_history[0].numpy() - alpha_t).max())
    gap_alpha = float(np.abs(alpha_t - alpha_j).max())
    assert gap_alpha <= max(1e-8, 20.0 * own_alpha), (gap_alpha, own_alpha)
    scale = np.maximum(1.0, np.abs(z_j))
    own = float(np.abs((z_n - z_t) / scale).max())
    gap = float(np.abs((z_t - z_j) / scale).max())
    print(f"[reading] eeparam 5 iterates: alpha gap {gap_alpha:.3e}, own {own_alpha:.3e}; "
          f"iterate gap {gap:.3e}, own {own:.3e}")
    assert gap <= max(1e-8, 20.0 * own), (gap, own)
