"""The port's VBL (variational dynamics and Riccati value function) against
the JAX package.

Numpy-seeded references and the trajectory of tests/test_vbl.py, f64 on
both sides.  ``variational_dynamics``, the error-state derivative and the
single RDE steps at 1e-12 (relative to the largest entry);
``riccati_value_function`` along the trajectory at 1e-9 relative (an Euler
sweep of 21 steps that multiplies the packages' rounding differences); a
batch of three trajectories equals three single calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.analysis import vbl as jv
from landing_controller_tpu_torch import analysis
from landing_controller_tpu_torch.analysis import vbl as tv

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def close(t, j, rel=1e-12):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape, (t.shape, j.shape)
    err = np.abs(t - j).max() / max(1.0, np.abs(j).max())
    assert err <= rel, err


def _references(seed, n=3):
    """x_ref (n, 24) and f_ref (n, 12) as in tests/test_vbl.py."""
    rng = np.random.default_rng(seed)
    x_ref = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(-0.3, 0.3, (n, 3)),
                            rng.normal(size=(n, 6)) * 0.3, rng.normal(size=(n, 12)) * 0.2], 1)
    return x_ref, rng.uniform(0, 30, (n, 12))


def _ib():
    return tuple(np.asarray(a) for a in tv._full_body_inertia("mc3D"))


def test_error_state_xdot():
    x_ref, f_ref = _references(0)
    rng = np.random.default_rng(1)
    dx, df = rng.standard_normal((3, 24)), rng.standard_normal((3, 12))
    ib, ib_inv = _ib()
    out = tv.error_state_xdot(*(torch.as_tensor(a) for a in (dx, df, x_ref, f_ref)), 8.252,
                              torch.as_tensor(ib), torch.as_tensor(ib_inv))
    ref = jax.vmap(lambda a, b, c, d: jv.error_state_xdot(a, b, c, d, 8.252, jnp.asarray(ib),
                                                          jnp.asarray(ib_inv)))(
        jnp.asarray(dx), jnp.asarray(df), jnp.asarray(x_ref), jnp.asarray(f_ref))
    close(out, ref)


def test_variational_dynamics():
    x_ref, f_ref = _references(2)
    A, B = tv.variational_dynamics(torch.as_tensor(x_ref), torch.as_tensor(f_ref))
    assert A.shape == (3, 24, 24) and B.shape == (3, 24, 12)
    for i in range(3):
        Aj, Bj = jv.variational_dynamics(jnp.asarray(x_ref[i]), jnp.asarray(f_ref[i]))
        close(A[i], Aj)
        close(B[i], Bj)


@pytest.mark.parametrize("direction", ["backward", "forward"])
def test_riccati_steps(direction):
    x_ref, f_ref = _references(3, n=1)
    F, Q, R = (np.asarray(a) for a in jv.default_vbl_weights())
    rng = np.random.default_rng(4)
    M = rng.standard_normal((24, 24))
    P = F + 0.1 * (M @ M.T)
    name = f"riccati_step_{direction}"
    out = getattr(tv, name)(*(torch.as_tensor(a) for a in (P, x_ref[0], f_ref[0], Q, R)), 0.022)
    ref = getattr(jv, name)(*(jnp.asarray(a) for a in (P, x_ref[0], f_ref[0], Q, R)), 0.022)
    close(out, ref)


def test_default_weights():
    for t, j in zip(tv.default_vbl_weights(device="cpu"), jv.default_vbl_weights()):
        assert t.dtype == torch.float64
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for name in ("variational_dynamics", "riccati_step_backward", "riccati_step_forward",
                 "riccati_value_function", "default_vbl_weights"):
        assert getattr(analysis, name) is getattr(tv, name) and name in analysis.__all__


def _trajectory(z0=0.5, z1=0.25, fz=20.0):
    """tests/test_vbl.py:36-45: a descending reference, feet fixed, N = 21."""
    n = 21
    t_star = np.concatenate([[0], np.cumsum(np.full(n - 1, 0.03))])
    X = np.zeros((n, 12))
    X[:, 2] = np.linspace(z0, z1, n)
    U = np.zeros((n - 1, 24))
    U[:, :12] = np.tile([0.19, -0.12, 0, 0.19, 0.12, 0, -0.19, -0.12, 0, -0.19, 0.12, 0], (n - 1, 1))
    U[:, 14::3] = fz
    return X, U, t_star


def test_riccati_value_function_matches_jax():
    X, U, t_star = _trajectory()
    P, P_fwd = tv.riccati_value_function(*(torch.as_tensor(a) for a in (X, U, t_star)))
    Pj, Pj_fwd = jv.riccati_value_function(*(jnp.asarray(a) for a in (X, U, t_star)))
    assert P.shape == (28, 24, 24)
    close(P, Pj, rel=1e-9)
    close(P_fwd, Pj_fwd, rel=1e-9)
    np.testing.assert_array_equal(P[-1].numpy(), np.asarray(jv.default_vbl_weights()[0]))


def test_batch_of_trajectories_equals_single_calls():
    """Three trajectories in one call (times shared) give each one's own call."""
    trajs = [_trajectory(), _trajectory(0.45, 0.3, 18.0), _trajectory(0.55, 0.2, 22.0)]
    X = torch.as_tensor(np.stack([t[0] for t in trajs]))
    U = torch.as_tensor(np.stack([t[1] for t in trajs]))
    P, P_fwd = tv.riccati_value_function(X, U, torch.as_tensor(trajs[0][2]))
    assert P.shape == (3, 28, 24, 24)
    for i, (Xi, Ui, ti) in enumerate(trajs):
        Pi, Pi_fwd = tv.riccati_value_function(*(torch.as_tensor(a) for a in (Xi, Ui, ti)))
        close(P[i], Pi.numpy())
        close(P_fwd[i], Pi_fwd.numpy())
    with pytest.raises(ValueError):
        tv.riccati_value_function(X, U, torch.as_tensor(np.stack([trajs[0][2]] * 2 + [
            trajs[0][2] * 1.1])))
