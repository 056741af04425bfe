"""The port's IK, cascade seeds and warm-start cascade against the JAX
package (f64, CPU).

- closed-form IK in the zyx and xyz conventions and the Newton polish on
  random feet near the workspace, to 1e-10; the polish's fall-back to its
  guess on an unreachable target;
- the stage-2 seeds of both seed modes ("full": kinodynamic_guess_from_srbm,
  with and without the joint-limit clip; "x_grf": stage-1 X and GRFs with
  the ballistic feet and jpos), to 1e-10;
- make_cascade: stage 1 rebuilt on stage 2's dt schedule, the n_knots guard;
- make_cascade of srbm_lcp and kinodynamic solvers at N=6 with max_iter 5,
  both stages' iterates held by the rule of tests/test_torch_iterates_kino.py
  (1e-8, or 20 times the port's own change under a one-part-in-1e15 nudge of
  the scenario; ROADMAP §3 has the readings), with JAX's iteration counts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import LandingSolver as JaxLandingSolver
from landing_controller_tpu.dynamics import legs as j_legs
from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu.problems.landing import LandingVars as JaxLandingVars
from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.warmstart import cascade as j_cascade
from landing_controller_tpu.warmstart.reference import ballistic_guess as j_ballistic
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.dynamics import legs
from landing_controller_tpu_torch.models import get_robot_params
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.warmstart import cascade

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

RP_J, RP_T = j_get_robot_params("mc3D"), get_robot_params("mc3D")


def _feet_cases(n=16, seed=0):
    """Base poses and world feet from the FK of random joint angles, nudged."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([rng.uniform(-0.1, 0.1, (n, 2)), rng.uniform(0.25, 0.4, (n, 1)),
                           rng.uniform(-0.2, 0.2, (n, 3))], 1)
    jpos = np.tile([0.0, -0.8, 1.6], 4)[None] + rng.uniform(-0.3, 0.3, (n, 12))
    fk = jax.vmap(lambda b, j: j_legs.foot_positions_world(RP_J, b, j).reshape(12))
    feet = np.asarray(fk(jnp.asarray(base), jnp.asarray(jpos))) + 0.005 * rng.standard_normal(
        (n, 12))
    return base, feet, jpos


@pytest.mark.parametrize("convention", ["zyx", "xyz"])
def test_inverse_kinematics_matches_jax(convention):
    base, feet, _ = _feet_cases()
    got = legs.inverse_kinematics(RP_T, torch.as_tensor(base), torch.as_tensor(feet),
                                  convention=convention).numpy()
    want = np.asarray(jax.vmap(lambda b, p: j_legs.inverse_kinematics(
        RP_J, b, p, convention=convention))(jnp.asarray(base), jnp.asarray(feet)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("convention", ["zyx", "xyz"])
def test_inverse_kinematics_newton_matches_jax(convention):
    base, feet, jpos = _feet_cases(seed=1)
    guess = jpos + 0.05 * np.random.default_rng(2).standard_normal(jpos.shape)
    # the last case: a target 2 m away, out of reach: the guess comes back
    feet[-1] += 2.0
    got = legs.inverse_kinematics_newton(RP_T, torch.as_tensor(base), torch.as_tensor(feet),
                                         torch.as_tensor(guess), convention=convention).numpy()
    want = np.asarray(jax.jit(jax.vmap(lambda b, p, g: j_legs.inverse_kinematics_newton(
        RP_J, b, p, g, convention=convention)))(jnp.asarray(base), jnp.asarray(feet),
                                                jnp.asarray(guess)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got[-1], guess[-1])
    # the polish lands on the FK-consistent angles of reachable feet
    fk = legs.foot_positions_world(RP_T, torch.as_tensor(base),
                                   torch.as_tensor(got)).reshape(-1, 12).numpy()
    if convention == "xyz":
        assert np.abs(fk[:-1] - feet[:-1]).max() < 1e-2


N = 6
Q0 = np.array([[0.0, 0.0, 0.55, 0.05, 0.2, -0.02], [0.0, 0.0, 0.6, -0.05, -0.3, 0.1]])
QD0 = np.array([[0.1, -0.05, 0.0, 0.05, -0.05, -1.0], [-0.2, 0.3, 0.1, -0.1, 0.2, -2.0]])
KW = dict(max_iter=5, hessian_mode="hybrid", mu_min=1e-6, tol=1e-4, sigma_max=1e8,
          refine_steps=1, relax_scale=1.0, delta_c=1e-6)


def _solvers(tag="port"):
    if tag == "port":
        cfg = IPConfig(kkt_backend="cri", **KW)
        return (LandingSolver("srbm_lcp", n_knots=N, dtype=torch.float64, config=cfg,
                              device="cpu"),
                LandingSolver("kinodynamic", n_knots=N, dtype=torch.float64, config=cfg,
                              device="cpu"))
    cfg = JaxIPConfig(kkt_backend="cri_ref", **KW)
    return (JaxLandingSolver("srbm_lcp", n_knots=N, dtype=jnp.float64, config=cfg),
            JaxLandingSolver("kinodynamic", n_knots=N, dtype=jnp.float64, config=cfg))


@pytest.mark.parametrize("seed_mode", ["full", "x_grf"])
def test_cascade_seeds_match_jax(seed_mode):
    (_, kino_t), (_, kino_j) = _solvers("port"), _solvers("jax")
    rng = np.random.default_rng(3)
    th_t = kino_t.build_params(Q0, QD0)
    z_b = kino_t._cold_guess(th_t)
    v = kino_t.problem.unpack(z_b)
    X = v.X + 0.01 * torch.as_tensor(rng.standard_normal(v.X.shape))
    U = v.U + 0.01 * torch.as_tensor(rng.standard_normal(v.U.shape))
    jl = (th_t.jpos_min, th_t.jpos_max)
    for clip in ((jl, None) if seed_mode == "full" else (jl,)):
        got = cascade.cascade_seed(kino_t.problem, RP_T, th_t, X, U, seed_mode, clip).numpy()
        for lane in range(2):
            th_j = kino_j.build_params(jnp.asarray(Q0[lane]), jnp.asarray(QD0[lane]))
            Xl, Ul = jnp.asarray(X[lane].numpy()), jnp.asarray(U[lane].numpy())
            if seed_mode == "full":
                jl_j = None if clip is None else (th_j.jpos_min, th_j.jpos_max)
                want = j_cascade.kinodynamic_guess_from_srbm(kino_j.problem, RP_J, Xl, Ul, jl_j)
            else:
                vb = kino_j.problem.unpack(j_ballistic(kino_j.problem, th_j))
                want = kino_j.problem.pack(JaxLandingVars(
                    X=Xl, jpos=vb.jpos, U=jnp.concatenate([vb.U[:, :12], Ul[:, 12:]], 1)))
            np.testing.assert_allclose(got[lane], np.asarray(want), rtol=0, atol=1e-10)


def test_stage_one_rebuilt_on_the_kinodynamic_grid():
    """A stage 1 on another dt schedule (here an override; at N=21 the
    srbm_lcp default is uniform and the kinodynamic one the production grid)
    is rebuilt on stage 2's, keeping its other overrides and settings."""
    srbm, kino = _solvers("port")
    srbm = LandingSolver("srbm_lcp", n_knots=N, dtype=torch.float64, config=srbm.config,
                         theta_overrides={"dt": np.full(N - 1, 0.1), "mu": 0.5}, device="cpu")
    z = np.zeros((1, 6))
    dt_kino = kino.build_params(z, z).dt
    assert not torch.allclose(srbm.build_params(z, z).dt, dt_kino)
    fn = cascade.make_cascade(srbm, kino)
    th1 = fn.stage1.build_params(z, z)
    torch.testing.assert_close(th1.dt, dt_kino, rtol=0, atol=0)
    assert float(th1.mu[0]) == 0.5
    assert fn.stage1.config == srbm.config and fn.stage2 is kino
    # the production grids at N=21 differ: the rebuild happens by default
    s21 = LandingSolver("srbm_lcp", device="cpu")
    k21 = LandingSolver("kinodynamic", device="cpu")
    fn21 = cascade.make_cascade(s21, k21)
    assert fn21.stage1 is not s21
    torch.testing.assert_close(fn21.stage1.build_params(z, z).dt, k21.build_params(z, z).dt)
    assert cascade.make_cascade(srbm, kino, warm_mu_init=1e-2).stage2.config.mu_init == 1e-2
    other = LandingSolver("srbm_lcp", n_knots=N + 1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="n_knots"):
        cascade.make_cascade(other, kino)


def test_make_cascade_matches_jax():
    srbm_t, kino_t = _solvers("port")
    srbm_j, kino_j = _solvers("jax")
    fn_t = cascade.make_cascade(srbm_t, kino_t)
    fn_j = j_cascade.make_cascade(srbm_j, kino_j)
    s2_t, s1_t = fn_t(Q0, QD0)
    # the port's own sensitivity: the same cascade from q0 * (1 + 1e-15)
    s2_n, s1_n = fn_t(Q0 * (1.0 + 1e-15), QD0)
    for lane in range(2):
        s2_j, s1_j = fn_j(jnp.asarray(Q0[lane]), jnp.asarray(QD0[lane]))
        for got, nudged, want in ((s1_t, s1_n, s1_j), (s2_t, s2_n, s2_j)):
            want_z = np.asarray(want.z)
            scale = np.maximum(1.0, np.abs(want_z))
            z = got.z[lane].numpy()
            own = float(np.abs((nudged.z[lane].numpy() - z) / scale).max())
            gap = float(np.abs((z - want_z) / scale).max())
            print(f"[reading] cascade lane {lane}: gap {gap:.3e}, own {own:.3e}")
            assert gap <= max(1e-8, 20.0 * own), (lane, gap, own)
            assert int(got.iterations[lane]) == int(want.iterations)
    assert dataclasses.is_dataclass(s2_t) and s2_t.jpos.shape == (2, N - 1, 12)
