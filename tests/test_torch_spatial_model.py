"""The port's rotation, spatial-algebra and quaternion kits, its quad3D model
and its SRBM helpers against the JAX package.

Same numpy-seeded inputs on both sides, f64 (``jax_enable_x64``).  The JAX
functions take one configuration at a time (a loop of eager calls, not
jitted, for a batch); the port takes the batch as leading dimensions.  Tolerance 1e-12
(absolute and relative) unless a test states another; the model's arrays
are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.dynamics import quaternion as jq
from landing_controller_tpu.dynamics import rotations as jr
from landing_controller_tpu.dynamics import spatial as js
from landing_controller_tpu.dynamics import srbm as jsrbm
from landing_controller_tpu.models import model as jmodel
from landing_controller_tpu.models import params as jparams
from landing_controller_tpu_torch.dynamics import quaternion as tq
from landing_controller_tpu_torch.dynamics import rotations as tr
from landing_controller_tpu_torch.dynamics import spatial as ts
from landing_controller_tpu_torch.dynamics import srbm as tsrbm
from landing_controller_tpu_torch.models import model as tmodel
from landing_controller_tpu_torch.models import params as tparams

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-12
B = 4


def jloop(fn):
    """fn over the leading axis of its array arguments, one eager JAX call
    each (eager calls share their compiled primitives, where each new
    ``jax.vmap`` compiles its own), the results stacked."""
    def run(*arrays):
        outs = [fn(*(a[i] for a in arrays)) for i in range(arrays[0].shape[0])]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)
    return run


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


def T(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("name", ["rx", "ry", "rz"])
def test_axis_rotations(name):
    theta = _rng(0).uniform(-3.0, 3.0, B)
    close(getattr(tr, name)(T(theta)), getattr(jr, name)(jnp.asarray(theta)))


def test_skew_and_unskew():
    v = _rng(1).standard_normal((B, 3))
    A = _rng(2).standard_normal((B, 3, 3))
    close(tr.skew(T(v)), jr.skew(jnp.asarray(v)))
    close(tr.unskew(T(A)), jr.unskew(jnp.asarray(A)))
    close(tr.unskew(tr.skew(T(v))), v)


def _spatial_inputs(seed):
    rng = _rng(seed)
    E = np.asarray(jloop(jr.rpy_to_rot_xyz)(jnp.asarray(rng.uniform(-1, 1, (B, 3)))))
    r = rng.standard_normal((B, 3))
    v = rng.standard_normal((B, 6))
    theta = rng.uniform(-3, 3, B)
    mass = rng.uniform(0.1, 3.0, B)
    com = 0.1 * rng.standard_normal((B, 3))
    M = rng.standard_normal((B, 3, 3))
    I3 = M @ M.transpose(0, 2, 1) * 1e-3 + 1e-3 * np.eye(3)
    return E, r, v, theta, mass, com, I3


def test_plucker_transforms():
    E, r, _, theta, _, _, _ = _spatial_inputs(3)
    X = ts.plux(T(E), T(r))
    close(X, jloop(js.plux)(jnp.asarray(E), jnp.asarray(r)))
    Et, rt = ts.plux_inv(X)
    Ej, rj = jloop(js.plux_inv)(jnp.asarray(np.asarray(X)))
    close(Et, Ej)
    close(rt, rj)
    close(rt, r)
    close(ts.rot_spatial(T(E)), jloop(js.rot_spatial)(jnp.asarray(E)))
    close(ts.xlt(T(r)), jloop(js.xlt)(jnp.asarray(r)))
    for name in ("rotx", "roty", "rotz"):
        close(getattr(ts, name)(T(theta)), jloop(getattr(js, name))(jnp.asarray(theta)))


def test_cross_operators():
    _, _, v, _, _, _, _ = _spatial_inputs(4)
    close(ts.crm(T(v)), jloop(js.crm)(jnp.asarray(v)))
    close(ts.crf(T(v)), jloop(js.crf)(jnp.asarray(v)))


def test_spatial_inertia_round_trip_and_flip():
    _, _, _, _, mass, com, I3 = _spatial_inputs(5)
    I6 = ts.spatial_inertia(T(mass), T(com), T(I3))
    I6j = jloop(js.spatial_inertia)(jnp.asarray(mass), jnp.asarray(com), jnp.asarray(I3))
    close(I6, I6j)
    for t, j in zip(ts.spatial_inertia_decompose(I6), jloop(js.spatial_inertia_decompose)(I6j)):
        close(t, j)
    close(ts.flip_spatial_inertia_y(I6), jloop(js.flip_spatial_inertia_y)(I6j))


@pytest.mark.parametrize("code", range(6))
def test_jcalc(code):
    q = _rng(6 + code).uniform(-2, 2, B)
    Xt, St = ts.jcalc(code, T(q))
    Xj, Sj = jloop(lambda qq: js.jcalc(code, qq))(jnp.asarray(q))
    close(Xt, Xj)
    close(St, Sj[0])
    np.testing.assert_array_equal(ts._S_TABLE, js._S_TABLE)
    with pytest.raises(ValueError):
        ts.jcalc(6, T(q))


def _quats(seed, n=B):
    q = _rng(seed).standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _near_pi_rotations():
    """Rotations a hair short of, and exactly at, a half turn, about the axes
    of the JAX test and a generic one: the large-angle branch."""
    axes = np.array([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0.6, -0.64, 0.48]])
    v = np.concatenate([axes * (np.pi - 1e-6), axes * np.pi])
    return v, np.asarray(jloop(jq.rotvec_to_rot)(jnp.asarray(v)))


def test_quaternion_to_rotation_and_normalize():
    q = 1.7 * _quats(7)
    close(tq.quat_normalize(T(q)), jloop(jq.quat_normalize)(jnp.asarray(q)))
    close(tq.quat_to_rot(T(q)), jloop(jq.quat_to_rot)(jnp.asarray(q)))


@pytest.mark.parametrize("case", ["random", "near_pi", "identity_and_axes"])
def test_rot_to_quat(case):
    if case == "random":
        E = np.asarray(jloop(jq.quat_to_rot)(jnp.asarray(_quats(8, 16))))
    elif case == "near_pi":
        E = _near_pi_rotations()[1]
    else:
        E = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                      np.diag([-1.0, -1.0, 1.0])])
    qt = tq.rot_to_quat(T(E))
    close(qt, jloop(jq.rot_to_quat)(jnp.asarray(E)))
    close(tq.quat_to_rot(qt), E, tol=1e-9)


def test_quaternion_derivatives():
    rng = _rng(9)
    q = 1.1 * _quats(9)
    w = rng.standard_normal((B, 3))
    close(tq.quat_derivative(T(q), T(w)), jloop(jq.quat_derivative)(jnp.asarray(q), jnp.asarray(w)))
    close(tq.quat_derivative_world(T(w), T(q)),
          jloop(jq.quat_derivative_world)(jnp.asarray(w), jnp.asarray(q)))


def test_rotation_vectors():
    rng = _rng(10)
    v = np.concatenate([rng.standard_normal((B, 3)), [[1e-10, -2e-10, 0.0], [0.0, 0.0, 0.0]],
                        _near_pi_rotations()[0]])
    Et = tq.rotvec_to_rot(T(v))
    close(Et, jloop(jq.rotvec_to_rot)(jnp.asarray(v)))
    close(tq.rot_to_rotvec(Et), jloop(jq.rot_to_rotvec)(jnp.asarray(np.asarray(Et))))


ARRAYS = ("parent", "xtree", "inertia", "xfoot", "b_foot", "gravity", "q_home", "gear_ratio", "kt",
          "rm", "tau_max")


@pytest.mark.parametrize("robot", ["mc3D", "mcv3D"])
def test_robot_model_is_bit_identical(robot):
    mt, mj = tmodel.get_robot_model(robot), jmodel.get_robot_model(robot)
    for name in ARRAYS:
        a, b = getattr(mt, name), getattr(mj, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name
    assert (mt.nb, mt.nlegs, mt.jtype, mt.battery_v) == (mj.nb, mj.nlegs, mj.jtype, mj.battery_v)
    np.testing.assert_array_equal(mt.tau_max_leg, mj.tau_max_leg)
    np.testing.assert_array_equal(tmodel.SIDE_SIGN, jmodel.SIDE_SIGN)
    np.testing.assert_array_equal(tmodel.SIDE_SIGN_XYZ, jmodel.SIDE_SIGN_XYZ)
    np.testing.assert_array_equal(tmodel.FOOT_SIGN_CONVENTION, jmodel.FOOT_SIGN_CONVENTION)


def test_model_tensors_are_built_once_per_dtype_and_device():
    m = tmodel.get_robot_model("mc3D")
    a = m.tensors(torch.float64, "cpu")
    assert all(x is y for x, y in zip(m.tensors(torch.float64, torch.device("cpu")), a, strict=True))
    b = m.tensors(torch.float32, "cpu")
    assert b.inertia is not a.inertia and b.inertia.dtype == torch.float32
    np.testing.assert_array_equal(a.inertia.numpy(), m.inertia)
    np.testing.assert_array_equal(a.xtree.numpy(), m.xtree)
    np.testing.assert_array_equal(a.a_grav.numpy(), [0, 0, 0, 0, 0, 9.81])


def test_composite_inertia_np():
    """At the home pose and at seeded configurations, 1e-14."""
    m, mj = tmodel.get_robot_model("mc3D"), jmodel.get_robot_model("mc3D")
    rng = _rng(11)
    for q in [m.q_home] + [np.concatenate([rng.standard_normal(6), rng.uniform(-1.5, 1.5, 12)])
                           for _ in range(3)]:
        np.testing.assert_allclose(tmodel.composite_inertia_np(m, q),
                                   jmodel.composite_inertia_np(mj, q), rtol=1e-14, atol=1e-14)


# the port's mc3D constants before they were rebuilt on composite_inertia_np:
# mass 8.251999999999999 (one ulp below the float64 nearest 8.252, in both
# packages), the diagonals of the body inertia and of its inverse
BEFORE = (8.251999999999999, np.array([0.05757729852959269, 0.23400899479539086, 0.2796738482657981]),
          np.array([17.37746888893693, 4.27334000932043, 3.577551923825657]))


@pytest.mark.parametrize("robot", ["mc3D", "mcv3D"])
def test_srbm_constants_unchanged(robot):
    mass, ib, ib_inv = tmodel.srbm_constants(robot)
    jm, jib, jib_inv = jmodel.srbm_constants(robot)
    assert mass == jm
    np.testing.assert_allclose(ib, jib, rtol=0, atol=1e-15)
    np.testing.assert_allclose(ib_inv, jib_inv, rtol=1e-15, atol=0)
    if robot == "mc3D":
        assert mass == BEFORE[0] and abs(mass - 8.252) < 2e-15
        np.testing.assert_allclose(ib, BEFORE[1], rtol=0, atol=1e-15)
        np.testing.assert_allclose(ib_inv, BEFORE[2], rtol=1e-15, atol=0)


def test_register_robot():
    """A parameter set registered in both packages builds the same model and
    constants."""
    tparams.register_robot("mc3D_heavy_test", lambda: dataclasses.replace(
        tparams.get_robot_params("mc3D"), name="mc3D_heavy_test", body_mass=4.1,
        body_inertia=tparams._spatial_inertia_np(4.1, [0, 0, 0], np.diag([0.012, 0.037, 0.044]))))
    jparams.register_robot("mc3D_heavy_test", lambda: dataclasses.replace(
        jparams.get_robot_params("mc3D"), name="mc3D_heavy_test", body_mass=4.1,
        body_inertia=jparams._spatial_inertia_np(4.1, [0, 0, 0], np.diag([0.012, 0.037, 0.044]))))
    mt, mj = tmodel.get_robot_model("mc3D_heavy_test"), jmodel.get_robot_model("mc3D_heavy_test")
    for name in ARRAYS:
        assert np.array_equal(getattr(mt, name), getattr(mj, name)), name
    assert tmodel.srbm_constants("mc3D_heavy_test")[0] == jmodel.srbm_constants("mc3D_heavy_test")[0]
    assert abs(tmodel.srbm_constants("mc3D_heavy_test")[0] - (8.252 - 3.3 + 4.1)) < 1e-12
    with pytest.raises(KeyError):
        tparams.get_robot_params("no_such_robot")


def _srbm_inputs(seed, n):
    """A gentle stance: feet under the hips, forces near a quarter of the
    weight each, small velocities (a spinning body would amplify the
    packages' rounding differences past the tolerance)."""
    rng = _rng(seed)
    x0 = np.concatenate([[0.0, 0.0, 0.3], rng.uniform(-0.1, 0.1, 3),
                         0.1 * rng.standard_normal(3), 0.1 * rng.standard_normal(3)])
    c = np.tile([0.19, -0.11, 0.0, 0.19, 0.11, 0.0, -0.19, -0.11, 0.0, -0.19, 0.11, 0.0],
                (n - 1, 1)) + 0.01 * rng.standard_normal((n - 1, 12))
    f = np.tile([0.0, 0.0, 20.0], (n - 1, 4)) + 0.2 * rng.standard_normal((n - 1, 12))
    U = np.concatenate([c, f], 1)
    dts = rng.uniform(0.01, 0.03, n - 1)
    return x0, U, dts


def test_split_state_and_control():
    x0, U, _ = _srbm_inputs(12, 3)
    for t, j in zip(tsrbm.split_state(T(x0)), jsrbm.split_state(jnp.asarray(x0))):
        close(t, j)
    for t, j in zip(tsrbm.split_control(T(U[0])), jsrbm.split_control(jnp.asarray(U[0]))):
        close(t, j)
    assert tsrbm.split_control(T(U))[1].shape == (2, 4, 3)


def test_rollout_and_euler_defect():
    """rollout at N = 21, and the defects of its states (zero) and of a
    perturbed trajectory, batched over the knots, against JAX knot by knot."""
    mass, ib, ib_inv = jmodel.srbm_constants("mc3D")
    x0, U, dts = _srbm_inputs(13, 21)
    Xt = tsrbm.rollout(T(x0), T(U), T(dts), mass, ib, ib_inv)
    Xj = jsrbm.rollout(jnp.asarray(x0), jnp.asarray(U), jnp.asarray(dts), mass, jnp.asarray(ib),
                       jnp.asarray(ib_inv))
    assert Xt.shape == (21, 12)
    close(Xt, Xj)
    Xp = np.asarray(Xj) + 1e-3 * _rng(14).standard_normal((21, 12))
    dt_ = tsrbm.euler_defect(T(Xp[:-1]), T(Xp[1:]), T(U), T(dts), mass, ib, ib_inv)
    dj = jloop(lambda a, b, u, d: jsrbm.euler_defect(a, b, u, d, mass, jnp.asarray(ib),
                                                        jnp.asarray(ib_inv)))(
        jnp.asarray(Xp[:-1]), jnp.asarray(Xp[1:]), jnp.asarray(U), jnp.asarray(dts))
    close(dt_, dj)
    zero = tsrbm.euler_defect(Xt[:-1], Xt[1:], T(U), T(dts), mass, ib, ib_inv)
    assert float(zero.abs().max()) < 1e-12
    # a batch of two rollouts is two single ones
    X2 = tsrbm.rollout(torch.stack([T(x0), T(x0) + 0.01]), T(U).expand(2, 20, 24), T(dts),
                       mass, ib, ib_inv)
    close(X2[0], Xt, tol=0)
