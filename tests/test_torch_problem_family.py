"""The kinodynamic, sliding, ccc and contact-scheduled problems of the port
against the JAX package.

Row counts, relaxation masks, row labels, variable scales, parameter sets,
cost / eq / ineq residuals and the two non-learned cold guesses, from the
same numpy-seeded scenario and decision vectors on both sides, at f64
(tolerance 1e-12), at a small knot count; the learned guess with its joint
angles at f64 (1e-9) and at f32 (2e-5 after scaling by max(1, |z|): the
MLP's three 256-wide layers sum in another order, and the GRF block
multiplies that rounding by m*g = 81).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.models import get_robot_params as j_get_robot_params
from landing_controller_tpu.problems import landing as j_landing
from landing_controller_tpu.solver.scaling import landing_z_scale as j_landing_z_scale
from landing_controller_tpu.warmstart import nn as j_nn
from landing_controller_tpu.warmstart import reference as j_ref
from landing_controller_tpu_torch.convert import landing_params_from_numpy
from landing_controller_tpu_torch.models import get_robot_params
from landing_controller_tpu_torch.problems import landing as t_landing
from landing_controller_tpu_torch.solver.scaling import landing_z_scale
from landing_controller_tpu_torch.warmstart import nn as t_nn
from landing_controller_tpu_torch.warmstart import reference as t_ref

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TOL = 1e-12
N = 6
KINDS = {
    "kinodynamic": ("kinodynamic_problem", "kinodynamic_params"),
    "sliding": ("sliding_problem", "srbm_lcp_params"),
    "ccc": ("ccc_problem", "ccc_params"),
    "contact_scheduled": ("contact_scheduled_problem", "contact_scheduled_params"),
}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def _scenario(rng):
    q0 = np.array([0.0, 0.0, 0.6, *rng.uniform(-0.25, 0.25, 3)])
    qd0 = np.array([*rng.uniform(-0.5, 0.5, 3), *rng.uniform(-1, 1, 2), -rng.uniform(0.5, 5.0)])
    return q0, qd0


def _fields(th_j):
    return {f.name: np.asarray(getattr(th_j, f.name)) for f in dataclasses.fields(th_j)
            if getattr(th_j, f.name) is not None}


def _pair(kind, n=N):
    prob_fn, params_fn = KINDS[kind]
    pj = getattr(j_landing, prob_fn)(j_get_robot_params("mc3D"), n_knots=n)
    pt = getattr(t_landing, prob_fn)(get_robot_params("mc3D"), n_knots=n)
    return pj, pt, getattr(j_ref, params_fn), getattr(t_ref, params_fn)


def test_default_knot_counts_match():
    for prob_fn, _ in KINDS.values():
        pj = getattr(j_landing, prob_fn)(j_get_robot_params("mc3D"))
        pt = getattr(t_landing, prob_fn)(get_robot_params("mc3D"))
        assert pt.config.n_knots == pj.config.n_knots
        assert dataclasses.asdict(pt.config) == dataclasses.asdict(pj.config)
    with pytest.raises(NotImplementedError):
        t_landing.kinodynamic_voltage_problem(get_robot_params("mc3D"))


@pytest.mark.parametrize("kind", list(KINDS))
def test_counts_masks_labels_and_scales_match(kind):
    pj, pt, _, _ = _pair(kind)
    assert (pt.n_vars, pt.n_eq, pt.n_ineq) == (pj.n_vars, pj.n_eq, pj.n_ineq)
    mask = pt.relax_mask()
    assert mask.shape == (pt.n_ineq,)
    _close(mask, pj.relax_mask(), 0)
    assert pt.ineq_row_labels() == pj.ineq_row_labels()
    assert len(pt.ineq_row_labels()) == pt.n_ineq
    _close(landing_z_scale(pt), j_landing_z_scale(pj), 0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_params_match(kind):
    _, _, j_params, t_params = _pair(kind)
    rng = np.random.default_rng(len(kind))
    scen = [_scenario(rng) for _ in range(2)]
    th_t = t_params(torch.as_tensor(np.stack([s[0] for s in scen])),
                    torch.as_tensor(np.stack([s[1] for s in scen])), n_knots=N)
    for i, (q0, qd0) in enumerate(scen):
        th_j = j_params(jnp.asarray(q0), jnp.asarray(qd0), n_knots=N)
        for f in dataclasses.fields(th_j):
            want, got = getattr(th_j, f.name), getattr(th_t, f.name)
            assert (want is None) == (got is None), f.name
            if want is not None:
                _close(got[i], want)


def test_kinodynamic_params_production_grid():
    """N=21 takes the production dt schedule (the other counts a uniform one)."""
    q0, qd0 = _scenario(np.random.default_rng(9))
    th_j = j_ref.kinodynamic_params(jnp.asarray(q0), jnp.asarray(qd0))
    th_t = t_ref.kinodynamic_params(torch.as_tensor(q0)[None], torch.as_tensor(qd0)[None])
    _close(th_t.dt[0], th_j.dt)
    _close(th_t.dt[0], t_ref.DT_PRODUCTION, 0)
    _close(th_t.u_ref[0], th_j.u_ref)
    _close(th_t.kin_box[0], th_j.kin_box)


@pytest.mark.parametrize("kind", list(KINDS))
def test_residuals_match(kind):
    pj, pt, j_params, _ = _pair(kind)
    rng = np.random.default_rng(10 + len(kind))
    q0, qd0 = _scenario(rng)
    th_j = j_params(jnp.asarray(q0), jnp.asarray(qd0), n_knots=N)
    if kind == "contact_scheduled":
        # a non-trivial schedule: legs touch down at different knots, one lifts off again
        cs = np.ones((N - 1, 4))
        cs[:2, :] = 0.0
        cs[2, 1] = 0.0
        cs[3:, 2] = 0.0
        th_j = dataclasses.replace(th_j, cs=jnp.asarray(cs))
    th_t = landing_params_from_numpy(_fields(th_j))
    z = rng.standard_normal((3, pj.n_vars))
    th_t3 = dataclasses.replace(th_t, **{
        k: torch.as_tensor(np.array(v)).expand((3,) + v.shape).clone()
        for k, v in _fields(th_j).items()})
    for name in ("cost", "eq", "ineq"):
        got = getattr(pt, name)(torch.as_tensor(z), th_t3).numpy()
        for i in range(3):
            _close(got[i], getattr(pj, name)(jnp.asarray(z[i]), th_j))
    # pack and unpack round-trip with the jpos block in its place
    v = pt.unpack(torch.as_tensor(z))
    vj = pj.unpack(jnp.asarray(z[0]))
    _close(v.jpos[0], vj.jpos, 0)
    _close(v.U[0], vj.U, 0)
    _close(pt.pack(v), z, 0)


@pytest.mark.parametrize("kind", list(KINDS))
def test_cold_guesses_match(kind):
    pj, pt, j_params, _ = _pair(kind)
    q0, qd0 = _scenario(np.random.default_rng(20 + len(kind)))
    th_j = j_params(jnp.asarray(q0), jnp.asarray(qd0), n_knots=N)
    th_t = landing_params_from_numpy(_fields(th_j))
    _close(t_ref.initial_guess_from_reference(pt, th_t)[0],
           j_ref.initial_guess_from_reference(pj, th_j))
    _close(t_ref.ballistic_guess(pt, th_t)[0], j_ref.ballistic_guess(pj, th_j))


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float64, torch.float64, 1e-9),
                                         (jnp.float32, torch.float32, 2e-5)])
def test_nn_guess_keeps_jpos_for_kinodynamic(jdt, tdt, tol):
    """The learned guess on the production grid: the kinodynamic layout
    keeps the predicted joint angles."""
    path = os.path.join(os.path.dirname(j_nn.__file__), "..", "data", "nn_TO_landing.npz")
    params_j, stats_j = j_nn.load_warmstart(path, dtype=jdt)
    mlp, stats_t = t_nn.load_warmstart(path, dtype=tdt)
    pj = j_landing.kinodynamic_problem(j_get_robot_params("mc3D"))
    pt = t_landing.kinodynamic_problem(get_robot_params("mc3D"))
    rng = np.random.default_rng(7)
    qs, qds = zip(*(_scenario(rng) for _ in range(3)))
    q, qd = np.stack(qs), np.stack(qds)
    got = t_nn.nn_warmstart_guess(mlp, stats_t, torch.as_tensor(q, dtype=tdt),
                                  torch.as_tensor(qd, dtype=tdt), pt)
    want = jax.jit(jax.vmap(lambda a, b: j_nn.nn_warmstart_guess(params_j, stats_j, a, b, pj)))(
        jnp.asarray(q, jdt), jnp.asarray(qd, jdt))
    assert got.shape == (3, pt.n_vars) and pt.n_vars == 12 * 21 + 36 * 20
    scale = np.maximum(1.0, np.abs(np.asarray(want)))
    np.testing.assert_allclose(got.numpy() / scale, np.asarray(want) / scale, rtol=0, atol=tol)
    jpos = pt.unpack(got).jpos
    assert jpos.shape == (3, 20, 12) and float(jpos.abs().max()) > 0.1
