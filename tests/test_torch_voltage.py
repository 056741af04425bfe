"""The kinodynamic_voltage variant and the dense KKT path of the port's
LandingSolver against the JAX package (f64, CPU).

- the voltage rows, row labels and relaxation mask at N=21 on the reference
  guess and on a perturbed decision vector, to 1e-12;
- one dense Newton step (the JAX ``solve``'s default step, written out with
  ``jax.jacfwd`` as ip.py:380-427 builds it) on the scaled problem at N=6,
  both Hessian branches of the hybrid mode, to 1e-8 after scaling by
  max(1, |x|);
- a StreamingSolver-style segmented solve of a dense solver equals its
  one-shot solve, and ``structured=False`` on the kinodynamic kind solves on
  the dense path too.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu.problems.landing import kinodynamic_voltage_problem as j_volt_problem
from landing_controller_tpu.solver.ip import _solve_kkt as j_solve_kkt
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.warmstart.reference import (
    initial_guess_from_reference as j_reference_guess,
)
from landing_controller_tpu.warmstart.reference import kinodynamic_params as j_kino_params
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.convert import landing_params_from_numpy
from landing_controller_tpu_torch.models import get_robot_params
from landing_controller_tpu_torch.problems.landing import kinodynamic_voltage_problem
from landing_controller_tpu_torch.solver.ip import make_dense_newton_step

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

Q0 = np.array([0.0, 0.0, 0.55, 0.05, 0.2, -0.02])
QD0 = np.array([0.1, -0.05, 0.0, 0.05, -0.05, -1.0])


def _fields(th):
    return {k: np.asarray(v) for k, v in vars(th).items() if v is not None}


def test_robot_params_carry_motor_constants():
    for robot in ("mc3D", "mcv3D"):
        ours, theirs = get_robot_params(robot), j_get_robot_params(robot)
        for name in ("abad_gear_ratio", "hip_gear_ratio", "knee_gear_ratio", "motor_kt",
                     "motor_r", "motor_tau_max", "battery_v"):
            assert getattr(ours, name) == getattr(theirs, name), (robot, name)


def test_voltage_rows_labels_and_mask_match_jax():
    n = 21
    prob_j = j_volt_problem(j_get_robot_params("mc3D"), n_knots=n)
    prob_t = kinodynamic_voltage_problem(get_robot_params("mc3D"), n_knots=n)
    assert (prob_t.n_vars, prob_t.n_eq, prob_t.n_ineq) == (prob_j.n_vars, prob_j.n_eq,
                                                           prob_j.n_ineq)
    assert prob_t.ineq_row_labels() == prob_j.ineq_row_labels()
    np.testing.assert_array_equal(prob_t.relax_mask(), np.asarray(prob_j.relax_mask()))
    th_j = jax.jit(lambda q, qd: j_kino_params(q, qd, n_knots=n))(jnp.asarray(Q0), jnp.asarray(QD0))
    th_t = landing_params_from_numpy(_fields(th_j), device="cpu")
    z = np.array(jax.jit(lambda th: j_reference_guess(prob_j, th))(th_j))
    ineq_j = jax.jit(prob_j.ineq)
    rng = np.random.default_rng(5)
    z_pert = z + 0.05 * rng.standard_normal(z.shape)
    volt = np.array([":volt[" in lab for lab in prob_j.ineq_row_labels()])
    assert volt.sum() == 24 * (n - 2)
    for zz in (z, z_pert):
        g_j = np.asarray(ineq_j(jnp.asarray(zz), th_j))
        g_t = prob_t.ineq(torch.as_tensor(zz)[None], th_t)[0].numpy()
        np.testing.assert_allclose(g_t, g_j, rtol=1e-12, atol=1e-12)
        assert np.abs(g_t[volt]).max() > 0
    # the home-pose guess has zero GRFs and constant jpos: zero voltage
    g_t = prob_t.ineq(torch.as_tensor(z)[None], th_t)[0].numpy()
    v_from_rows = get_robot_params("mc3D").battery_v - g_t[volt].reshape(-1, 24)[:, :12]
    np.testing.assert_allclose(v_from_rows, 0.0, atol=1e-12)


def _scaled_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.maximum(1.0, np.abs(b))
    np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol)


def test_dense_newton_step_matches_jax():
    js = JaxLandingSolver("kinodynamic_voltage", n_knots=6, dtype=jnp.float64)
    ts = LandingSolver("kinodynamic_voltage", n_knots=6, dtype=torch.float64, device="cpu")
    assert not ts.structured and not js.structured
    cfg_j = js.config
    prob = js.problem
    n, me, mi = prob.n_vars, prob.n_eq, prob.n_ineq
    rng = np.random.default_rng(3)
    L = 2  # lane 0: Gauss-Newton Hessian, lane 1: exact Hessian
    dz0 = 0.01 * rng.standard_normal((L, n))
    y = 0.01 * rng.standard_normal((L, me))
    lam = rng.uniform(0.001, 0.1, (L, mi))
    s = rng.uniform(0.01, 1.0, (L, mi))
    sigma = np.minimum(lam / s, cfg_j.sigma_max)
    use_exact = np.array([False, True])
    rhs_z = rng.standard_normal((L, n))
    rhs_y = 0.1 * rng.standard_normal((L, me))
    delta = np.array([1e-2, 3e-3])

    @jax.jit
    def jax_step(dz0, y, lam, sigma, use_exact, rhs_z, rhs_y, delta):
        theta = js.build_params(jnp.asarray(Q0), jnp.asarray(QD0))
        z0 = js._cold_guess(prob, theta)
        snlp = j_scale_problem(partial(prob.cost, theta=theta), partial(prob.eq, theta=theta),
                               partial(prob.ineq, theta=theta), z0, z_scale=js._z_scale)

        def lagrangian(z, y, lam):
            return snlp.cost(z) + snlp.eq(z) @ y - snlp.ineq(z) @ lam

        hess = jax.jacfwd(jax.grad(lagrangian, argnums=0), argnums=0)

        def one(dz0, y, lam, sigma, ue, rz, ry, d):
            z = snlp.to_scaled(z0) + dz0
            Je = jax.jacfwd(snlp.eq)(z)
            Jg = jax.jacfwd(snlp.ineq)(z)
            uf = ue.astype(z.dtype)
            H = hess(z, uf * y, uf * lam) + Jg.T @ (sigma[:, None] * Jg)
            return j_solve_kkt(H, Je, rz, ry, d, cfg_j)[:3]

        return jax.vmap(one)(dz0, y, lam, sigma, use_exact, rhs_z, rhs_y, delta)

    dz_j, dy_j, du_j = jax_step(dz0, y, lam, sigma, use_exact, rhs_z, rhs_y, delta)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    theta = ts.build_params(t(np.stack([Q0, Q0])), t(np.stack([QD0, QD0])))
    z0 = ts._cold_guess(theta)
    snlp = ts.scaled_problem(theta, z0)
    step = make_dense_newton_step(snlp.cost, snlp.eq, snlp.ineq, ts.config)
    dz_t, dy_t, du_t, resolve = step(snlp.to_scaled(z0) + t(dz0), t(y), t(lam), t(sigma), None,
                                     t(use_exact), None, None, t(rhs_z), t(rhs_y), t(delta))
    assert np.isfinite(np.asarray(dz_j)).all()
    np.testing.assert_array_equal(du_t.numpy(), np.asarray(du_j))
    _scaled_close(dz_t, dz_j, 1e-8)
    _scaled_close(dy_t, dy_j, 1e-8)
    dz_r, dy_r = resolve(t(rhs_z), t(rhs_y))
    torch.testing.assert_close(dz_r, dz_t, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["kinodynamic_voltage", "kinodynamic"])
def test_dense_segments_equal_one_shot_solve(kind):
    cfg = LandingSolver(kind, n_knots=5, dtype=torch.float64, device="cpu",
                        structured=False).config
    ts = LandingSolver(kind, n_knots=5, dtype=torch.float64, device="cpu", structured=False,
                       config=dataclasses.replace(cfg, max_iter=6))
    assert not ts.structured and ts.config.delta_c == 1e-8 and ts.config.refine_steps == 1
    q = np.stack([Q0, Q0 + 0.01])
    qd = np.stack([QD0, QD0 - 0.05])
    mono = ts.solve_batch(q, qd)
    snlp, st = ts.init_lanes(q, qd)
    for _ in range(2):
        summary, st = ts._segment_impl(None, None, st, 3, snlp=snlp)
    torch.testing.assert_close(summary["z"], mono.z, rtol=0, atol=0)
    torch.testing.assert_close(summary["iterations"], mono.iterations)
    assert bool(st.done.all())
