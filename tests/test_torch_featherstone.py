"""The port's Featherstone algorithms against the JAX package.

Four numpy-seeded configurations of the mc3D model (base pose, joint angles
near the home pose, velocities, torques, accelerations, world spatial
forces on every body), f64 on both sides.  The JAX functions take one
configuration at a time (a loop, not jitted: eager JAX calls share their
compiled primitives, where each new ``jax.vmap`` compiles its own); the port
takes the four as a leading batch dimension.  Tolerance: 1e-10 relative to
the largest entry of the JAX result (the packages sum in other orders);
``joint_pd_sim`` over 20 steps at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.dynamics import featherstone as jf
from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu.models.model import get_robot_model as j_get_robot_model
from landing_controller_tpu_torch.dynamics import featherstone as tf
from landing_controller_tpu_torch.models import get_robot_model, get_robot_params

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-10
B = 4


def close(t, j, rel=REL):
    j = np.asarray(j)
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() / max(1.0, np.abs(j).max())
    assert err <= rel, err


def jloop(fn):
    """fn over the leading axis of its array arguments (None passes through),
    one configuration per eager JAX call, the results stacked."""
    def run(*arrays):
        n = next(a.shape[0] for a in arrays if a is not None)
        outs = [fn(*(None if a is None else a[i] for a in arrays)) for i in range(n)]
        return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *outs)
    return run


@pytest.fixture(scope="module")
def models():
    return get_robot_model("mc3D"), j_get_robot_model("mc3D")


@pytest.fixture(scope="module")
def cases(models):
    """q, qd, tau, qdd (B, 18), f_ext (B, 18, 6) and grf (B, 4, 3)."""
    m, _ = models
    rng = np.random.default_rng(21)
    q = np.concatenate([rng.uniform(-0.3, 0.3, (B, 3)) + [0, 0, 0.4], rng.uniform(-0.4, 0.4, (B, 3)),
                        m.q_home[6:] + rng.uniform(-0.3, 0.3, (B, 12))], 1)
    qd = rng.uniform(-1, 1, (B, 18))
    tau = rng.uniform(-5, 5, (B, 18))
    qdd = rng.uniform(-3, 3, (B, 18))
    f_ext = rng.uniform(-2, 2, (B, 18, 6))
    grf = np.concatenate([rng.uniform(-5, 5, (B, 4, 2)), rng.uniform(0, 40, (B, 4, 1))], -1)
    return {k: np.asarray(v, np.float64) for k, v in
            dict(q=q, qd=qd, tau=tau, qdd=qdd, f_ext=f_ext, grf=grf).items()}


def tt(cases, *names):
    return [torch.as_tensor(cases[n]) for n in names]


def jj(cases, *names):
    return [jnp.asarray(cases[n]) for n in names]


def test_fk_feet_and_bodies(models, cases):
    m, mj = models
    (q,), (qj,) = tt(cases, "q"), jj(cases, "q")
    close(tf.fk_feet(m, q), jloop(lambda x: jf.fk_feet(mj, x))(qj))
    for t, j in zip(tf.fk_bodies(m, q), jloop(lambda x: jf.fk_bodies(mj, x))(qj)):
        close(t, j)


def test_mass_matrix_and_composite_inertia(models, cases):
    m, mj = models
    (q,), (qj,) = tt(cases, "q"), jj(cases, "q")
    for t, j in zip(tf.mass_matrix(m, q), jloop(lambda x: jf.mass_matrix(mj, x))(qj)):
        close(t, j)
    ic = jf.composite_body_inertia(mj, qj[0])
    close(tf.composite_body_inertia(m, cases["q"][0], device="cpu"), ic)  # an array
    close(tf.composite_body_inertia(m, q[0]), ic)  # a tensor keeps its device
    close(tf.crba_open(m, q), jloop(lambda x: jf.crba_open(mj, x))(qj))


@pytest.mark.parametrize("with_f_ext", [False, True])
def test_rnea_and_h_and_c(models, cases, with_f_ext):
    m, mj = models
    q, qd, qdd, fx = tt(cases, "q", "qd", "qdd", "f_ext")
    qj, qdj, qddj, fxj = jj(cases, "q", "qd", "qdd", "f_ext")
    fx, fxj = (fx, fxj) if with_f_ext else (None, None)
    close(tf.rnea(m, q, qd, qdd, f_ext_world=fx),
          jloop(lambda a, b, c, f: jf.rnea(mj, a, b, c, f_ext_world=f))(qj, qdj, qddj, fxj))
    for t, j in zip(tf.h_and_c(m, q, qd, f_ext_world=fx),
                    jloop(lambda a, b, f: jf.h_and_c(mj, a, b, f_ext_world=f))(qj, qdj, fxj)):
        close(t, j)


@pytest.mark.parametrize("with_f_ext", [False, True])
def test_forward_dynamics(models, cases, with_f_ext):
    """fd_ab and fd_crb against JAX, against each other, and rnea(fd_ab(tau)) = tau."""
    m, mj = models
    q, qd, tau, fx = tt(cases, "q", "qd", "tau", "f_ext")
    qj, qdj, tauj, fxj = jj(cases, "q", "qd", "tau", "f_ext")
    fx, fxj = (fx, fxj) if with_f_ext else (None, None)
    ab = tf.fd_ab(m, q, qd, tau, f_ext_world=fx)
    close(ab, jloop(lambda a, b, c, f: jf.fd_ab(mj, a, b, c, f_ext_world=f))(qj, qdj, tauj, fxj))
    crb = tf.fd_crb(m, q, qd, tau, f_ext_world=fx)
    close(crb, jloop(lambda a, b, c, f: jf.fd_crb(mj, a, b, c, f_ext_world=f))(qj, qdj, tauj, fxj))
    close(ab, crb.numpy(), rel=1e-9)
    close(tf.rnea(m, q, qd, ab, f_ext_world=fx), cases["tau"], rel=1e-9)


FD_PATTERNS = {
    "floating_base": (True,) * 6 + (False,) * 12,
    "mixed": tuple(bool(b) for b in np.random.default_rng(5).integers(0, 2, 18)),
}


@pytest.mark.parametrize("pattern", sorted(FD_PATTERNS))
@pytest.mark.parametrize("with_f_ext", [False, True])
def test_hybrid_dynamics(models, cases, pattern, with_f_ext):
    m, mj = models
    fd = FD_PATTERNS[pattern]
    q, qd, qdd, tau, fx = tt(cases, "q", "qd", "qdd", "tau", "f_ext")
    qj, qdj, qddj, tauj, fxj = jj(cases, "q", "qd", "qdd", "tau", "f_ext")
    fx, fxj = (fx, fxj) if with_f_ext else (None, None)
    out = tf.hybrid_dynamics(m, fd, q, qd, qdd, tau, f_ext_world=fx)
    ref = jloop(lambda a, b, c, d, f: jf.hybrid_dynamics(mj, fd, a, b, c, d, f_ext_world=f))(
        qj, qdj, qddj, tauj, fxj)
    for t, j in zip(out, ref):
        close(t, j)


@pytest.mark.parametrize("with_f_ext", [False, True])
def test_id_floating_base(models, cases, with_f_ext):
    m, mj = models
    q, qd, qdd, fx = tt(cases, "q", "qd", "qdd", "f_ext")
    qj, qdj, qddj, fxj = jj(cases, "q", "qd", "qdd", "f_ext")
    fx, fxj = (fx, fxj) if with_f_ext else (None, None)
    out = tf.id_floating_base(m, q, qd, qdd[:, 6:], f_ext_world=fx)
    ref = jloop(lambda a, b, c, f: jf.id_floating_base(mj, a, b, c, f_ext_world=f))(
        qj, qdj, qddj[:, 6:], fxj)
    for t, j in zip(out, ref):
        close(t, j)


def test_rotors(models, cases):
    """quad3d_rotor_model builds JAX's arrays bit for bit; h_and_c_rotors
    with it matches JAX, and a zero rotor leaves h_and_c unchanged."""
    m, mj = models
    rt = tf.quad3d_rotor_model(m, get_robot_params("mc3D"), 2.5e-5, rotor_mass=0.05)
    rj = jf.quad3d_rotor_model(mj, j_get_robot_params("mc3D"), 2.5e-5, rotor_mass=0.05)
    assert rt.nr == rj.nr == 12
    for name in ("gamma", "gr", "inertia", "x_mu"):
        assert np.array_equal(getattr(rt, name), getattr(rj, name)), name
    q, qd = tt(cases, "q", "qd")
    qj, qdj = jj(cases, "q", "qd")
    for t, j in zip(tf.h_and_c_rotors(m, rt, q, qd),
                    jloop(lambda a, b: jf.h_and_c_rotors(mj, rj, a, b))(qj, qdj)):
        close(t, j)
    zero = tf.RotorModel(rt.gamma, rt.gr, np.zeros_like(rt.inertia), rt.x_mu)
    for t, j in zip(tf.h_and_c_rotors(m, zero, q, qd), tf.h_and_c(m, q, qd)):
        close(t, j.numpy())


def test_energy_momentum(models, cases):
    m, mj = models
    q, qd = tt(cases, "q", "qd")
    qj, qdj = jj(cases, "q", "qd")
    out = tf.energy_momentum(m, q, qd)
    ref = jloop(lambda a, b: jf.energy_momentum(mj, a, b))(qj, qdj)
    assert sorted(out) == sorted(ref)
    for k in out:
        close(out[k], ref[k])


def test_foot_forces_to_spatial(models, cases):
    m, mj = models
    q, grf = tt(cases, "q", "grf")
    qj, grfj = jj(cases, "q", "grf")
    close(tf.foot_forces_to_spatial(m, q, grf),
          jloop(lambda a, g: jf.foot_forces_to_spatial(mj, a, g))(qj, grfj))


def test_floating_base_kinematics(models, cases):
    """fbkin_fwd with and without rates, fbkin_inv of both layouts, and the
    gimbal-lock neighbourhood (pitch pi/2 - 1e-7)."""
    q6 = cases["q"][:, :6].copy()
    q6[1, 4] = np.pi / 2 - 1e-7
    qd6 = cases["qd"][:, :6]
    q6t, qd6t = torch.as_tensor(q6), torch.as_tensor(qd6)
    p = tf.fbkin_fwd(q6t)
    close(p, jloop(jf.fbkin_fwd)(jnp.asarray(q6)))
    x = tf.fbkin_fwd(q6t, qd6t)
    close(x, jloop(jf.fbkin_fwd)(jnp.asarray(q6), jnp.asarray(qd6)))
    close(tf.fbkin_inv(p), jloop(jf.fbkin_inv)(jnp.asarray(p.numpy())))
    keep = [0, 2, 3]  # the rates are singular at the gimbal lock, in both packages
    for t, j in zip(tf.fbkin_inv(x[keep]), jloop(jf.fbkin_inv)(jnp.asarray(x.numpy()[keep]))):
        close(t, j, rel=1e-9)


def test_joint_pd_sim(models):
    """The gains of tests/test_forward_dynamics.py (kp 1000, kd 30, dt 1e-4,
    torques limited) for 20 steps, at 1e-9, from the home pose with the feet
    (0.0958 m below the base there) 5 mm into the ground, so that the
    contact forces are exercised."""
    m, mj = models
    q0 = m.q_home.copy()
    q0[2] = 0.0908
    args = dict(kp=1000.0, kd=30.0, dt=1e-4, n_steps=20)
    out = tf.joint_pd_sim(m, torch.as_tensor(q0), torch.zeros(18, dtype=torch.float64),
                          torch.as_tensor(m.q_home[6:]), torch.zeros(12, dtype=torch.float64),
                          tau_limit=torch.as_tensor(m.tau_max[:12]), **args)
    ref = jf.joint_pd_sim(mj, jnp.asarray(q0), jnp.zeros(18), jnp.asarray(mj.q_home[6:]),
                          jnp.zeros(12), tau_limit=jnp.asarray(mj.tau_max[:12]), **args)
    assert float(np.asarray(ref[2])[:, :, 2].sum(-1).max()) > 1.0  # the ground pushes back
    for t, j in zip(out, ref):
        close(t, j, rel=1e-9)


def test_batched_calls_equal_single_calls(models, cases):
    """One call over the batch gives each configuration's own call (to 1e-13:
    a batched matrix product may sum in another order than a single one),
    and a joint_pd_sim of two lanes each lane's own run."""
    m, _ = models
    q, qd, tau, fx = tt(cases, "q", "qd", "tau", "f_ext")
    fns = (lambda a, b, c, f: tf.fd_ab(m, a, b, c, f_ext_world=f),
           lambda a, b, c, f: tf.rnea(m, a, b, c, f_ext_world=f),
           lambda a, b, c, f: tf.mass_matrix(m, a)[0],
           lambda a, b, c, f: tf.h_and_c(m, a, b, f_ext_world=f)[1])
    for fn in fns:
        batched = fn(q, qd, tau, fx)
        for i in range(B):
            close(batched[i], fn(q[i], qd[i], tau[i], fx[i]).numpy(), rel=1e-13)
    q0 = torch.as_tensor(np.stack([m.q_home, m.q_home]))
    q0[:, 2] = torch.tensor([0.2, 0.25], dtype=torch.float64)
    runs = tf.joint_pd_sim(m, q0, torch.zeros_like(q0), m.q_home[6:], np.zeros(12), 400.0, 10.0,
                           1e-4, 5)
    for i in range(2):
        single = tf.joint_pd_sim(m, q0[i], torch.zeros(18, dtype=torch.float64), m.q_home[6:],
                                 np.zeros(12), 400.0, 10.0, 1e-4, 5)
        for b_, s in zip(runs, single):
            close(b_[i], s.numpy(), rel=1e-13)
