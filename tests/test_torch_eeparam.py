"""The port's eeParam (free contact timing) problem and EEParamSolver
against the JAX package (f64 unless stated, CPU).

- the fast tests of tests/test_eeparam.py: Hermite endpoints, spline-chain
  selection, the horizon guard; plus chain selection at times on interval
  boundaries (a start time and the end of the last interval);
- cost, eq, ineq and the initial guess against JAX on the guess and on a
  perturbed decision vector of two lanes, to 1e-12;
- one dense Newton step of EEParamSolver's settings against the JAX step, to
  1e-8 relative (the first five iterates are in
  tests/test_torch_eeparam_iterates.py);
- EEParamSolver's settings against the JAX solver's, build_params and the
  batch horizon guard.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.api import EEParamSolver as JaxEEParamSolver
from landing_controller_tpu.problems import eeparam as j_ee
from landing_controller_tpu.solver.ip import _solve_kkt as j_solve_kkt
from landing_controller_tpu_torch.api import EEParamSolver
from landing_controller_tpu_torch.problems import eeparam as t_ee
from landing_controller_tpu_torch.solver.ip import make_dense_newton_step
from landing_controller_tpu_torch.solver.scaling import scale_problem

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def test_hermite_conversion_endpoints():
    """Power coefficients reproduce the Hermite endpoint conditions, and the
    normalized-time form equals the physical one."""
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.normal(size=(3, 4)))
    d = torch.tensor(0.37, dtype=torch.float64)
    p = t_ee._hermite_to_power(h, d)
    torch.testing.assert_close(t_ee._polyval(p, 0.0), h[:, 0], rtol=0, atol=1e-12)
    torch.testing.assert_close(t_ee._polyval(p, d), h[:, 2], rtol=0, atol=1e-12)
    dp = t_ee._deriv(p)
    torch.testing.assert_close(t_ee._polyval(dp, 0.0), h[:, 1], rtol=0, atol=1e-12)
    torch.testing.assert_close(t_ee._polyval(dp, d), h[:, 3], rtol=0, atol=1e-12)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_ee._hermite_to_power(jnp.asarray(h.numpy()),
                                                                            0.37)), atol=1e-12)
    pt = t_ee._hermite_to_power_tau(h, d)
    torch.testing.assert_close(t_ee._polyval(pt, 0.4), t_ee._polyval(p, 0.4 * d), rtol=0,
                               atol=1e-12)


def test_chain_eval_selects_correct_spline():
    prob = t_ee.eeparam_problem()
    rng = np.random.default_rng(1)
    coefs = rng.normal(size=(4, 3, 4))
    durs = np.array([0.2, 0.1, 0.1, 0.1])
    # inside spline 2 (starts at 0.3)
    val = prob._eval_chain(torch.as_tensor(coefs), torch.as_tensor(durs),
                           torch.tensor(0.35, dtype=torch.float64))
    expected = t_ee._polyval(t_ee._hermite_to_power(torch.as_tensor(coefs[2]),
                                                    torch.tensor(0.1, dtype=torch.float64)), 0.05)
    torch.testing.assert_close(val, expected, rtol=0, atol=1e-12)


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.75, 1.0, 0.6])
def test_chain_eval_on_interval_boundaries_matches_jax(t):
    """Durations that are exact binary fractions put t on a start time
    (0.25, 0.5, 0.75: the later spline), on the end of the chain (1.0: the
    last interval is closed) and inside (0.6), for a batch of chains."""
    prob_j, prob_t = j_ee.eeparam_problem(), t_ee.eeparam_problem()
    rng = np.random.default_rng(2)
    coefs = rng.normal(size=(2, 4, 3, 4))
    durs = np.array([[0.25, 0.25, 0.25, 0.25], [0.5, 0.125, 0.125, 0.25]])
    got = prob_t._eval_chain(torch.as_tensor(coefs), torch.as_tensor(durs),
                             torch.tensor(t, dtype=torch.float64))
    for lane in range(2):
        want = np.asarray(prob_j._eval_chain(jnp.asarray(coefs[lane]), jnp.asarray(durs[lane]),
                                             jnp.asarray(t)))
        np.testing.assert_allclose(got[lane].numpy(), want, rtol=0, atol=1e-12)
    # at a start time the later spline's value is its x0
    if t == 0.5:
        np.testing.assert_allclose(got[0].numpy(), coefs[0, 2, :, 0], atol=1e-12)
        np.testing.assert_allclose(got[1].numpy(), coefs[1, 1, :, 0], atol=1e-12)
    if t == 1.0:  # the closed last interval: its end value
        np.testing.assert_allclose(got.numpy(), coefs[:, 3, :, 2], atol=1e-12)


def test_horizon_consistency_guard():
    prob = t_ee.eeparam_problem()
    theta = t_ee.default_eeparam_params(device="cpu", batch=3)
    prob.check_params(theta)  # consistent: no raise
    bad = dataclasses.replace(theta, horizon=torch.tensor([0.8, 0.6, 0.8]))
    with pytest.raises(ValueError, match="horizon"):
        prob.check_params(bad)
    s = EEParamSolver(device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        s.solve_batch(bad)


def _params_pair(heights, vzs):
    """The same B scenarios for both packages (f64): JAX (per lane) and port."""
    base_j = j_ee.default_eeparam_params(jnp.float64)
    th_j = [dataclasses.replace(base_j, r_init=jnp.asarray([0.0, 0.0, h]),
                                rdot_init=jnp.asarray([0.0, 0.0, vz])) for h, vz in zip(heights, vzs)]
    th_t = t_ee.default_eeparam_params(torch.float64, "cpu", batch=len(heights))
    th_t = dataclasses.replace(
        th_t, r_init=torch.tensor([[0.0, 0.0, h] for h in heights], dtype=torch.float64),
        rdot_init=torch.tensor([[0.0, 0.0, vz] for vz in vzs], dtype=torch.float64))
    return th_j, th_t


def test_problem_rows_match_jax():
    prob_j, prob_t = j_ee.eeparam_problem(), t_ee.eeparam_problem()
    th_j, th_t = _params_pair([0.5, 0.62], [-1.0, -1.4])
    z_t = prob_t.initial_guess(th_t)
    rng = np.random.default_rng(3)
    fns_j = {k: jax.jit(getattr(prob_j, k)) for k in ("cost", "eq", "ineq")}
    for lane, th in enumerate(th_j):
        z_j = np.asarray(jax.jit(prob_j.initial_guess)(th))
        np.testing.assert_allclose(z_t[lane].numpy(), z_j, rtol=0, atol=1e-12)
    z_pert = z_t + 0.02 * torch.as_tensor(rng.standard_normal(z_t.shape))
    for z in (z_t, z_pert):
        for name, fn_j in fns_j.items():
            got = getattr(prob_t, name)(z, th_t).numpy()
            for lane, th in enumerate(th_j):
                want = np.asarray(fn_j(jnp.asarray(z[lane].numpy()), th))
                np.testing.assert_allclose(got[lane], want, rtol=1e-12, atol=1e-12, err_msg=name)
    assert (prob_t.n_eq, prob_t.n_ineq) == (348, 380)
    np.testing.assert_array_equal(prob_t.relax_mask(), np.asarray(prob_j.relax_mask()))
    v = prob_t.unpack(z_pert)
    torch.testing.assert_close(prob_t.pack(v), z_pert, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rotation_products_equal_the_matmul(dtype):
    """The rows' 3x3 products (elementwise sums) equal M @ v and so do their
    forward-mode tangents, with the rows' broadcasting too (a rotation per
    lane and time against the four hips), to the rounding of three terms."""
    g = torch.Generator().manual_seed(5)

    def t(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    def matmul(M, v):
        return (M @ v[..., None])[..., 0]

    M, v, dM, dv = t(6, 10, 3, 3), t(6, 10, 3), t(6, 10, 3, 3), t(6, 10, 3)
    hips = t(4, 3)
    tol = dict(rtol=0, atol=8 * torch.finfo(dtype).eps * 10)
    torch.testing.assert_close(t_ee._mv(M, v), matmul(M, v), **tol)
    torch.testing.assert_close(t_ee._mv(M[..., None, :, :], hips), matmul(M[..., None, :, :], hips),
                               **tol)
    for got, want in zip(torch.func.jvp(t_ee._mv, (M, v), (dM, dv)),
                         torch.func.jvp(matmul, (M, v), (dM, dv))):
        torch.testing.assert_close(got, want, **tol)


def test_solver_settings_match_jax():
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        ours = dataclasses.asdict(EEParamSolver(dtype=tdt, device="cpu").config)
        theirs = dataclasses.asdict(JaxEEParamSolver(dtype=jdt).config)
        assert ours == theirs
    s = EEParamSolver(dtype=torch.float64, device="cpu")
    th = s.build_params(r_init=[[0.0, 0.0, 0.5], [0.0, 0.0, 0.6]])
    assert th.batch == 2 and th.rdot_init.shape == (2, 3)
    assert s.build_params().batch == 1


def test_dense_newton_step_matches_jax():
    """EEParamSolver's Newton step (Gauss-Newton Hessian, 2-candidate ladder)
    at the scaled initial guess with random multipliers and right-hand sides,
    against the JAX default step written out as ip.py:380-427 builds it.  The
    cost's curvature is 2e-8 I, so the step is huge (|dz| ~ 1e8) along
    directions no inequality row touches: held to 1e-8 relative to its largest
    entry."""
    cfg_t = EEParamSolver(dtype=torch.float64, device="cpu").config
    cfg_j = JaxEEParamSolver(dtype=jnp.float64).config
    prob_j, prob_t = j_ee.eeparam_problem(), t_ee.eeparam_problem()
    th_j, th_t = _params_pair([0.55, 0.48], [-1.2, -0.7])
    n, me, mi = prob_t.n_vars, prob_t.n_eq, prob_t.n_ineq
    rng = np.random.default_rng(6)
    L = 2
    y = 0.01 * rng.standard_normal((L, me))
    lam = rng.uniform(0.001, 0.1, (L, mi))
    sigma = lam / rng.uniform(0.01, 1.0, (L, mi))
    rhs_z = rng.standard_normal((L, n))
    rhs_y = 0.1 * rng.standard_normal((L, me))
    delta = np.array([1e-2, 3e-3])

    t = torch.as_tensor
    z0 = prob_t.initial_guess(th_t)
    snlp = scale_problem(prob_t, th_t, z0)
    step = make_dense_newton_step(snlp.cost, snlp.eq, snlp.ineq, cfg_t)
    dz_t, dy_t, du_t, _ = step(snlp.to_scaled(z0), t(y), t(lam), t(sigma), None,
                               torch.zeros(L, dtype=torch.bool), None, None, t(rhs_z), t(rhs_y),
                               t(delta))

    # the JAX side on the same scaled closures (the scales are the port's,
    # which test_problem_rows_match_jax's rows and the scaling tests tie to
    # JAX's; JAX's own scale_problem would add half a minute of compile)
    @jax.jit
    def jax_step(theta, z, fs, es, gs, sigma, rz, ry, d):
        Je = jax.jacfwd(lambda zz: prob_j.eq(zz, theta) * es)(z)
        Jg = jax.jacfwd(lambda zz: prob_j.ineq(zz, theta) * gs)(z)
        W = jax.jacfwd(jax.grad(lambda zz: prob_j.cost(zz, theta) * fs))(z)
        return j_solve_kkt(W + Jg.T @ (sigma[:, None] * Jg), Je, rz, ry, d, cfg_j)[:3]

    for lane in range(L):
        scales = [a[lane].numpy() for a in (snlp.f_scale, snlp.eq_scale, snlp.ineq_scale)]
        dz_j, dy_j, du_j = (np.asarray(a) for a in jax_step(
            th_j[lane], z0[lane].numpy(), *scales, sigma[lane], rhs_z[lane], rhs_y[lane],
            delta[lane]))
        assert du_t[lane].item() == du_j
        for got, want in ((dz_t[lane].numpy(), dz_j), (dy_t[lane].numpy(), dy_j)):
            assert np.isfinite(want).all()
            assert np.abs(got - want).max() <= 1e-8 * np.abs(want).max()
