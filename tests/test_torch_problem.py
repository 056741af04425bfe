"""The port's robot constants, dynamics, srbm_lcp problem and non-learned
guesses against the JAX package.

Residuals, parameters and the reference and ballistic cold-start guesses,
from the same numpy-seeded z and theta on both sides, at f64 (tolerance
1e-12 unless stated).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.dynamics.rotations import binv as j_binv
from landing_controller_tpu.dynamics.rotations import rpy_to_rot_xyz as j_rot_xyz
from landing_controller_tpu.dynamics.rotations import rpy_to_rot_zyx as j_rot_zyx
from landing_controller_tpu.dynamics.srbm import srbm_xdot as j_srbm_xdot
from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu.models import srbm_constants as j_srbm_constants
from landing_controller_tpu.problems.landing import srbm_lcp_problem as j_srbm_lcp_problem
from landing_controller_tpu.solver.scaling import landing_z_scale as j_landing_z_scale
from landing_controller_tpu.warmstart import reference as j_ref
from landing_controller_tpu_torch.convert import landing_params_from_numpy
from landing_controller_tpu_torch.dynamics.rotations import binv, rpy_to_rot_xyz, rpy_to_rot_zyx
from landing_controller_tpu_torch.dynamics.srbm import srbm_xdot
from landing_controller_tpu_torch.models import srbm_constants
from landing_controller_tpu_torch.problems.landing import LandingConfig, LandingProblem, srbm_lcp_problem
from landing_controller_tpu_torch.solver.scaling import landing_z_scale
from landing_controller_tpu_torch.warmstart import reference as t_ref

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-12


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _scenario(rng):
    q0 = np.array([0.0, 0.0, 0.6, *rng.uniform(-0.25, 0.25, 3)])
    qd0 = np.array([*rng.uniform(-0.5, 0.5, 3), *rng.uniform(-1, 1, 2), -rng.uniform(0.5, 5.0)])
    return q0, qd0


def _theta_pair(q0, qd0, n):
    th_j = j_ref.srbm_lcp_params(jnp.asarray(q0), jnp.asarray(qd0), n_knots=n)
    fields = {f.name: np.asarray(getattr(th_j, f.name)) for f in dataclasses.fields(th_j)
              if getattr(th_j, f.name) is not None}
    return th_j, landing_params_from_numpy(fields, device="cpu")


def test_srbm_constants_match():
    mass, ib, ib_inv = srbm_constants("mc3D")
    j_mass, j_ib, j_ib_inv = j_srbm_constants("mc3D")
    assert mass == j_mass
    assert abs(mass - 8.252) < 1e-9
    _close(ib, j_ib, 1e-15)
    _close(ib_inv, j_ib_inv, 1e-13)


def test_rotations_and_dynamics_match():
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-1.0, 1.0, (5, 3))
    for t_fn, j_fn in ((rpy_to_rot_xyz, j_rot_xyz), (rpy_to_rot_zyx, j_rot_zyx), (binv, j_binv)):
        _close(t_fn(torch.as_tensor(rpy)), j_fn(jnp.asarray(rpy)))
    mass, ib, ib_inv = j_srbm_constants("mc3D")
    x, u = rng.standard_normal(12), rng.standard_normal(24)
    got = srbm_xdot(torch.as_tensor(x)[None], torch.as_tensor(u)[None], torch.tensor([mass], dtype=torch.float64),
                    torch.as_tensor(ib)[None], torch.as_tensor(ib_inv)[None])[0]
    _close(got, j_srbm_xdot(jnp.asarray(x), jnp.asarray(u), mass, jnp.asarray(ib), jnp.asarray(ib_inv)))


def test_other_problem_kinds_not_ported():
    """The motor-voltage rows (run on the dense KKT path) are ported: a
    kinodynamic config with voltage_limit builds, with the JAX package's
    row counts, labels and relaxation mask (the voltage rows are never
    relaxed)."""
    from landing_controller_tpu.problems.landing import LandingConfig as JLandingConfig
    from landing_controller_tpu.problems.landing import LandingProblem as JLandingProblem
    from landing_controller_tpu_torch.models import get_robot_params

    pt = LandingProblem(LandingConfig(kinodynamic=True, voltage_limit=True, n_knots=7),
                        get_robot_params("mc3D"))
    pj = JLandingProblem(JLandingConfig(kinodynamic=True, voltage_limit=True, n_knots=7),
                         j_get_robot_params("mc3D"))
    assert (pt.n_vars, pt.n_eq, pt.n_ineq) == (pj.n_vars, pj.n_eq, pj.n_ineq)
    assert pt.ineq_row_labels() == pj.ineq_row_labels()
    _close(pt.relax_mask(), pj.relax_mask(), 0)
    assert pt.ineq_row_labels()[-1] == "k5:volt[23]"


@pytest.mark.parametrize("n", [13, 21])
def test_params_residuals_and_masks_match(n):
    rng = np.random.default_rng(n)
    q0, qd0 = _scenario(rng)
    th_j, th_t = _theta_pair(q0, qd0, n)
    th_t2 = t_ref.srbm_lcp_params(torch.as_tensor(q0)[None], torch.as_tensor(qd0)[None], n_knots=n)
    # srbm_lcp carries no running-cost weights and no contact schedule
    fields = [f for f in dataclasses.fields(th_t) if f.name not in ("qx", "qc", "qf", "cs")]
    assert all(getattr(th, k) is None for th in (th_t, th_t2) for k in ("qx", "qc", "qf", "cs"))
    for f in fields:
        _close(getattr(th_t2, f.name), getattr(th_t, f.name))
    pj = j_srbm_lcp_problem(j_get_robot_params("mc3D"), n_knots=n)
    pt = srbm_lcp_problem(None, n_knots=n)
    assert (pt.n_vars, pt.n_eq, pt.n_ineq) == (pj.n_vars, pj.n_eq, pj.n_ineq)
    _close(pt.relax_mask(), pj.relax_mask(), 0)
    _close(landing_z_scale(pt), j_landing_z_scale(pj), 0)
    z = rng.standard_normal((3, pj.n_vars))
    zt = torch.as_tensor(z)
    th_t3 = dataclasses.replace(th_t, **{f.name: getattr(th_t, f.name).expand(
        (3,) + getattr(th_t, f.name).shape[1:]) for f in fields})
    for name in ("cost", "eq", "ineq"):
        got = getattr(pt, name)(zt, th_t3).numpy()
        for i in range(3):
            _close(got[i], getattr(pj, name)(jnp.asarray(z[i]), th_j))


@pytest.mark.parametrize("n", [13, 21])
def test_reference_and_ballistic_guesses_match(n):
    rng = np.random.default_rng(100 + n)
    q0, qd0 = _scenario(rng)
    th_j, th_t = _theta_pair(q0, qd0, n)
    pj = j_srbm_lcp_problem(j_get_robot_params("mc3D"), n_knots=n)
    pt = srbm_lcp_problem(None, n_knots=n)
    _close(t_ref.initial_guess_from_reference(pt, th_t)[0], j_ref.initial_guess_from_reference(pj, th_j))
    _close(t_ref.ballistic_guess(pt, th_t)[0], j_ref.ballistic_guess(pj, th_j))
    assert np.array_equal(t_ref.DT_PRODUCTION, j_ref.DT_PRODUCTION)
