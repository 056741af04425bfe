"""The port's NN warm start and problem scaling against the JAX package.

The NN guess (committed weights through ``convert.py``), the denormalization
with its touchdown shift, and the scaled NLP's row scales, from the same
numpy-seeded inputs on both sides, at f64 (tolerance 1e-12 unless stated).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu.problems.landing import srbm_lcp_problem as j_srbm_lcp_problem
from landing_controller_tpu.solver.scaling import landing_z_scale as j_landing_z_scale
from landing_controller_tpu.solver.scaling import scale_problem as j_scale_problem
from landing_controller_tpu.warmstart import nn as j_nn
from landing_controller_tpu.warmstart import reference as j_ref
from landing_controller_tpu_torch.convert import mlp_from_numpy
from landing_controller_tpu_torch.problems.landing import srbm_lcp_problem
from landing_controller_tpu_torch.solver.scaling import landing_z_scale, scale_problem
from landing_controller_tpu_torch.warmstart import nn as t_nn
from test_torch_problem import _close, _scenario, _theta_pair

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def test_nn_guess_matches_through_convert():
    """The committed warm-start weights, converted through convert.py, give
    the JAX package's NN guess (f64 both sides)."""
    import os

    path = os.path.join(os.path.dirname(j_nn.__file__), "..", "data", "nn_TO_landing.npz")
    params_j, stats_j = j_nn.load_warmstart(path, dtype=jnp.float64)
    stats = {k: np.asarray(getattr(stats_j, k)) for k in stats_j._fields}
    mlp, stats_t = mlp_from_numpy([np.asarray(w) for w in params_j.weights],
                                  [np.asarray(b) for b in params_j.biases], stats,
                                  dtype=torch.float64, device="cpu")
    pj = j_srbm_lcp_problem(j_get_robot_params("mc3D"), n_knots=21)
    pt = srbm_lcp_problem(None, n_knots=21)
    rng = np.random.default_rng(7)
    qs, qds = zip(*(_scenario(rng) for _ in range(4)))
    q, qd = np.stack(qs), np.stack(qds)
    got = t_nn.nn_warmstart_guess(mlp, stats_t, torch.as_tensor(q), torch.as_tensor(qd), pt).numpy()
    want = jax.jit(jax.vmap(lambda a, b: j_nn.nn_warmstart_guess(params_j, stats_j, a, b, pj)))(
        jnp.asarray(q), jnp.asarray(qd))
    _close(got, want, 1e-9)
    # and the port's own loader reads the same artifact
    mlp2, stats2 = t_nn.load_warmstart(path, dtype=torch.float64, device="cpu")
    x = torch.as_tensor(rng.standard_normal((3, 9)))
    torch.testing.assert_close(mlp2(x), mlp(x), rtol=1e-6, atol=1e-6)


def test_nn_denormalize_touchdown_shift_matches():
    """Random network outputs (touchdown labels spread over 0..N-1) through
    denormalize_output on both sides."""
    rng = np.random.default_rng(8)
    stats = {
        "mean_input": rng.standard_normal(9), "std_input": rng.uniform(0.5, 2, 9),
        "mean_X": rng.standard_normal((21, 12)), "std_X": rng.uniform(0.5, 2, (21, 12)),
        "mean_c": rng.standard_normal((20, 12)), "std_c": rng.uniform(0.5, 2, (20, 12)),
        "mean_jpos": rng.standard_normal((20, 12)), "std_jpos": rng.uniform(0.5, 2, (20, 12)),
        "mass": np.asarray(8.252),
    }
    y = rng.standard_normal((5, t_nn.OUTPUT_DIM))
    y[:, -4:] = rng.uniform(-1.4, 21.4, (5, 4))
    stats_j = j_nn.DataStats(**{k: jnp.asarray(v) for k, v in stats.items()})
    _, stats_t = mlp_from_numpy([np.zeros((9, 2)), np.zeros((2, 976))], [np.zeros(2), np.zeros(976)],
                                stats, dtype=torch.float64, device="cpu")
    X, U, jp = t_nn.denormalize_output(stats_t, torch.as_tensor(y))
    for i in range(5):
        Xj, Uj, jpj = j_nn.denormalize_output(stats_j, jnp.asarray(y[i]))
        _close(X[i], Xj)
        _close(U[i], Uj)
        _close(jp[i], jpj)


@pytest.mark.parametrize("n", [13, 21])
def test_scale_problem_matches(n):
    rng = np.random.default_rng(200 + n)
    q0, qd0 = _scenario(rng)
    th_j, th_t = _theta_pair(q0, qd0, n)
    pj = j_srbm_lcp_problem(j_get_robot_params("mc3D"), n_knots=n)
    pt = srbm_lcp_problem(None, n_knots=n)
    z0 = np.asarray(j_ref.ballistic_guess(pj, th_j))
    zt = rng.standard_normal(pj.n_vars)

    @jax.jit
    def jax_side(z0, zt):
        sj = j_scale_problem(partial(pj.cost, theta=th_j), partial(pj.eq, theta=th_j),
                             partial(pj.ineq, theta=th_j), z0, z_scale=j_landing_z_scale(pj))
        return (sj.f_scale, sj.eq_scale, sj.ineq_scale, sj.cost(zt), sj.eq(zt), sj.ineq(zt),
                sj.ineq(z0))

    f_s, e_s, g_s, c_z, e_z, g_z, g_z0 = jax_side(jnp.asarray(z0), jnp.asarray(zt))
    st = scale_problem(pt, th_t, torch.as_tensor(z0)[None], z_scale=landing_z_scale(pt))
    _close(st.f_scale[0], f_s)
    _close(st.eq_scale[0], e_s)
    _close(st.ineq_scale[0], g_s)
    ztt = torch.as_tensor(zt)[None]
    _close(st.cost(ztt)[0], c_z)
    _close(st.eq(ztt)[0], e_z)
    _close(st.ineq(ztt)[0], g_z)
    # k lane-major rows per lane (the line-search layout)
    rows = torch.as_tensor(np.stack([zt, z0, zt]))
    _close(st.ineq(rows)[1], g_z0)
