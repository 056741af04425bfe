"""The port's receding-horizon Replanner against the JAX package (f64, CPU).

``warm_config`` field for field; a plan and a warm, iteration-capped replan
from a measured state nudged by 1e-3, on srbm_lcp at N=6 with 5 iterations
per solve, each solution's iterate held by the rule of
tests/test_torch_iterates_kino.py (1e-8, or 20 times the port's own change
under a one-part-in-1e15 nudge of the scenario) with JAX's iteration counts;
the batched API against the single-scenario one; the two-tier ``step``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from landing_controller_tpu.solver import IPConfig as JaxIPConfig
from landing_controller_tpu.warmstart import replan as j_replan
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.warmstart import replan

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

N = 6
Q0 = np.array([0.0, 0.0, 0.65, 0.05, 0.3, -0.05])
QD0 = np.array([0.1, -0.2, 0.1, 0.2, -0.1, -2.0])
DQ = 1e-3 * np.array([0.0, 0.0, 1.0, 1.0, -1.0, 0.5])
PLAN = dict(max_iter=5, hessian_mode="hybrid", mu_min=1e-6, tol=1e-4, sigma_max=1e8,
            refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri")


def test_warm_config_matches_jax():
    for kw in ({}, {"iter_cap": 12}, {"mu_init": 1e-2, "iter_cap": 120}):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
            ours = dataclasses.asdict(replan.warm_config(dtype=tdt, **kw))
            theirs = dataclasses.asdict(j_replan.warm_config(dtype=jdt, **kw))
            assert ours == theirs


def _close_by_rule(got, nudged, want):
    want = np.asarray(want)
    scale = np.maximum(1.0, np.abs(want))
    own = float(np.abs((nudged - got) / scale).max())
    gap = float(np.abs((got - want) / scale).max())
    print(f"[reading] replan: gap {gap:.3e}, own {own:.3e}")
    assert gap <= max(1e-8, 20.0 * own), (gap, own)


def test_plan_and_replan_match_jax():
    rp_j = j_replan.Replanner("srbm_lcp", n_knots=N, iter_cap=5, dtype=jnp.float64,
                              plan_config=JaxIPConfig(**PLAN))
    rp_t = replan.Replanner("srbm_lcp", n_knots=N, iter_cap=5, dtype=torch.float64,
                            plan_config=IPConfig(**PLAN), device="cpu")
    plan_j = rp_j.plan(jnp.asarray(Q0), jnp.asarray(QD0))
    plan_t = rp_t.plan(Q0, QD0)
    plan_n = rp_t.plan(Q0 * (1.0 + 1e-15), QD0)
    assert int(plan_t.iterations) == int(plan_j.iterations) == 5
    _close_by_rule(plan_t.z.numpy(), plan_n.z.numpy(), plan_j.z)

    # the replan carries each side's own plan (z, s, lam, y)
    re_j = rp_j.replan(j_replan.Replanner.carry(plan_j), jnp.asarray(Q0 + DQ), jnp.asarray(QD0))
    re_t = rp_t.replan(replan.Replanner.carry(plan_t), Q0 + DQ, QD0)
    re_n = rp_t.replan(replan.Replanner.carry(plan_n), (Q0 + DQ) * (1.0 + 1e-15), QD0)
    assert int(re_t.iterations) == int(re_j.iterations) <= 5
    _close_by_rule(re_t.z.numpy(), re_n.z.numpy(), re_j.z)
    z0 = rp_t._anchor(replan.Replanner.carry(plan_t), Q0 + DQ, QD0)  # re-anchored knot 0
    np.testing.assert_array_equal(z0[:12].numpy(), np.concatenate([Q0 + DQ, QD0]))
    torch.testing.assert_close(z0[12:], plan_t.z[12:], rtol=0, atol=0)

    # batched: two scenarios at once give the single-scenario answers
    q2, qd2 = np.stack([Q0, Q0 + DQ]), np.stack([QD0, QD0])
    plan_b = rp_t.plan(q2, qd2)
    torch.testing.assert_close(plan_b.z[0], plan_t.z, rtol=1e-9, atol=1e-9)
    re_b = rp_t.replan(replan.Replanner.carry(plan_b), q2 + DQ, qd2)
    assert re_b.z.shape == (2, plan_t.z.shape[0])

    # step: a tracking replan, with the recovery tier where it did not converge
    sol, st = rp_t.step(replan.Replanner.carry(plan_b), q2 + DQ, qd2)
    rec = rp_t.recover(replan.Replanner.carry(plan_b), q2 + DQ, qd2)
    for lane in range(2):
        want = re_b if bool(re_b.converged[lane]) else rec
        torch.testing.assert_close(sol.z[lane], want.z[lane], rtol=0, atol=0)
    assert isinstance(st, replan.ReplanState) and st.z is sol.z
