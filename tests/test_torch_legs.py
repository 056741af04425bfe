"""The port's closed-form leg kinematics against the JAX package.

Forward kinematics (hip frame and world frame), the analytic foot
Jacobians and the Jacobian-transpose torques, from the same numpy-seeded
joint angles, base poses and forces on both sides, at f64 (tolerance 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.dynamics import legs as j_legs
from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu_torch.dynamics import legs
from landing_controller_tpu_torch.models import get_robot_params

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-12


def _inputs(seed, b=4):
    rng = np.random.default_rng(seed)
    jpos = rng.uniform(-1.2, 1.2, (b, 12))
    q_base = np.concatenate([rng.uniform(-0.5, 0.5, (b, 3)), rng.uniform(-1.0, 1.0, (b, 3))], 1)
    f = 50.0 * rng.standard_normal((b, 12))
    return jpos, q_base, f


@pytest.mark.parametrize("robot", ["mc3D", "mcv3D"])
def test_link_lengths_match(robot):
    pt, pj = get_robot_params(robot), j_get_robot_params(robot)
    for name in ("l1", "l2", "l3", "knee_link_y_offset", "leg_rad"):
        assert getattr(pt, name) == getattr(pj, name)
    np.testing.assert_array_equal(pt.abad_location, pj.abad_location)
    np.testing.assert_array_equal(legs.SIDE_SIGN, j_legs.SIDE_SIGN)
    np.testing.assert_array_equal(legs.SIDE_SIGN_XYZ, j_legs.SIDE_SIGN_XYZ)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_kinematics_match(seed):
    pt, pj = get_robot_params("mc3D"), j_get_robot_params("mc3D")
    jpos, q_base, _ = _inputs(seed)
    hip = legs.foot_positions_hip(pt, torch.as_tensor(jpos)).numpy()
    world = legs.foot_positions_world(pt, torch.as_tensor(q_base), torch.as_tensor(jpos)).numpy()
    assert hip.shape == world.shape == (4, 4, 3)
    for i in range(len(jpos)):
        np.testing.assert_allclose(hip[i], j_legs.foot_positions_hip(pj, jnp.asarray(jpos[i])),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            world[i], j_legs.foot_positions_world(pj, jnp.asarray(q_base[i]), jnp.asarray(jpos[i])),
            rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_jacobians_and_torques_match(seed):
    pt, pj = get_robot_params("mc3D"), j_get_robot_params("mc3D")
    jpos, q_base, f = _inputs(seed)
    J = legs.leg_jacobians(pt, torch.as_tensor(jpos)).numpy()
    tau = legs.leg_torques(pt, torch.as_tensor(jpos), torch.as_tensor(q_base[:, 3:]),
                           torch.as_tensor(f)).numpy()
    assert J.shape == (4, 4, 3, 3) and tau.shape == (4, 12)
    for i in range(len(jpos)):
        np.testing.assert_allclose(J[i], j_legs.leg_jacobians(pj, jnp.asarray(jpos[i])),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            tau[i], j_legs.leg_torques(pj, jnp.asarray(jpos[i]), jnp.asarray(q_base[i, 3:]),
                                       jnp.asarray(f[i])), rtol=TOL, atol=TOL)


def test_jacobian_carries_the_knee_offset_fk_does_not():
    """The reference's FK omits the 0.004 m knee y-offset and its Jacobian
    includes it: d(FK)/d(abad) differs from J[:, :, 0] by exactly the
    offset's terms, and the other columns agree."""
    pt = get_robot_params("mc3D")
    jpos = torch.as_tensor(_inputs(5, b=1)[0][0])
    J_fk = torch.func.jacfwd(lambda q: legs.foot_positions_hip(pt, q))(jpos)  # (4, 3, 12)
    J = legs.leg_jacobians(pt, jpos)
    l4 = pt.knee_link_y_offset
    side = torch.as_tensor(legs.SIDE_SIGN)
    for leg in range(4):
        own = J_fk[leg][:, 3 * leg : 3 * leg + 3]
        torch.testing.assert_close(own[:, 1:], J[leg][:, 1:], rtol=1e-12, atol=1e-12)
        q1 = jpos[3 * leg]
        extra = torch.stack([torch.zeros(()).double(), -l4 * torch.sin(q1) * side[leg],
                             l4 * side[leg] * torch.cos(q1)])
        torch.testing.assert_close(J[leg][:, 0] - own[:, 0], extra, rtol=1e-12, atol=1e-12)
