"""The host-side helpers of chip_smoke.py that need no card.

The numpy drop-scenario sampler against the JAX package's height rule, the
bounds computed from shapes, and the count of block-inverse launches per
cyclic-reduction factorization against the port's own factorization.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from landing_controller_tpu.dynamics.rotations import rpy_to_rot_xyz as j_rot_xyz
from landing_controller_tpu.warmstart.reference import DT_PRODUCTION, HIP_SRBM
from landing_controller_tpu_torch.ops import cri_factor, make_qd_inverse

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def test_drop_sampler_follows_the_hip_clearance_rule():
    """z0 = 0.35 + |min hip z| + |dt_0 v_z| as sample_drop_scenario of
    landing_controller_tpu.warmstart.reference computes it, within the
    production script's ranges; the same seed gives the same scenarios."""
    q, qd = chip_smoke.sample_drop_scenarios(11, 64)
    q2, qd2 = chip_smoke.sample_drop_scenarios(11, 64)
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(qd, qd2)
    assert q.shape == qd.shape == (64, 6) and q.dtype == qd.dtype == np.float32
    assert (q[:, :2] == 0).all()
    assert (np.abs(q[:, [3, 5]]) <= 0.25).all() and (np.abs(q[:, 4]) <= np.pi / 3 + 1e-6).all()
    assert (np.abs(qd[:, :3]) <= 0.5).all() and (np.abs(qd[:, 3:5]) <= 1.0).all()
    assert (qd[:, 5] <= -0.5).all() and (qd[:, 5] >= -5.0).all()
    assert not np.array_equal(q, chip_smoke.sample_drop_scenarios(12, 64)[0])
    for i in range(8):
        R = np.asarray(j_rot_xyz(jnp.asarray(q[i, 3:6], jnp.float64)))
        hips_w = HIP_SRBM @ R.T
        z0 = 0.35 + abs(hips_w[:, 2].min()) + abs(DT_PRODUCTION[0] * qd[i, 5])
        assert q[i, 2] == pytest.approx(z0, abs=1e-6)


@pytest.mark.parametrize("nb", [1, 2, 15, 16, 18, 21, 41])
def test_launches_per_factor_match_the_factorization(nb):
    calls = []
    fn = make_qd_inverse(3, 2)

    def counting(S):
        calls.append(S.shape[-3])
        return fn(S)

    A = torch.eye(5, dtype=torch.float64).expand(nb, 5, 5) * torch.tensor(
        [1.0, 1.0, 1.0, -1.0, -1.0], dtype=torch.float64)[:, None]
    C = torch.zeros((max(nb - 1, 0), 5, 5), dtype=torch.float64)
    fac = cri_factor(A.clone(), C, counting)
    assert bool(fac.ok)
    assert len(calls) == chip_smoke.cr_launches_per_factor(nb)
    assert calls == chip_smoke.cr_launch_sizes(nb)
    if nb == 21:
        assert calls == [10, 5, 3, 1, 1, 1]


@pytest.mark.parametrize("lanes,candidates,want", [
    (64, 2, [1280, 640, 384, 128, 128, 128]),      # the srbm_lcp path: five of six are one wave
    (128, 4, [5120, 2560, 1536, 512, 512, 512]),   # the kinodynamic path
])
def test_launch_sizes_of_one_factorization(lanes, candidates, want):
    """The batch sizes of the block-inverse calls of a 21-block factorization
    of (lanes, candidates) systems, from the helper and from cri_factor."""
    calls = []
    fn = make_qd_inverse(3, 2)

    def counting(S):
        calls.append(S.reshape((-1,) + S.shape[-2:]).shape[0])
        return fn(S)

    diag = torch.tensor([1.0, 1.0, 1.0, -1.0, -1.0], dtype=torch.float64)
    A = (torch.eye(5, dtype=torch.float64) * diag[:, None]).expand(lanes, candidates, 21, 5, 5)
    C = torch.zeros((lanes, candidates, 20, 5, 5), dtype=torch.float64)
    fac = cri_factor(A.clone(), C, counting)
    assert bool(fac.ok.all())
    assert calls == want == chip_smoke.cr_launch_sizes(21, lanes, candidates)


def test_bounds_from_shapes():
    """289 MB at 3.35 TB/s for the kinodynamic path's largest level; the SPD
    inverse at n = 48, m = 5120 is bound by bytes as well."""
    ms, by = chip_smoke.qd_inverse_bound_ms(5120, 48, 36)
    assert by == "bytes" and ms == pytest.approx(1e3 * 5120 * (2 * 84 * 84 * 4 + 1) / 3.35e12)
    assert ms == pytest.approx(0.0863, abs=1e-4)
    ms, by = chip_smoke.chol_inverse_bound_ms(5120, 48)
    assert by == "bytes" and ms == pytest.approx(1e3 * 5120 * (2 * 48 * 48 * 4 + 1) / 3.35e12)
    assert 5120 * 48.0**3 / 67e12 < ms * 1e-3


def test_f64_bounds_from_shapes():
    """The double instances move 8-byte words: twice the f32 byte bound, and
    the operations count against the f64 peak (34 TFLOP/s); still bound by
    bytes at the paths' shapes."""
    for m, np_, nd in ((1280, 36, 24), (5120, 48, 36), (1280, 30, 20)):
        ms, by = chip_smoke.qd_inverse_bound_ms(m, np_, nd, itemsize=8)
        bs = np_ + nd
        assert by == "bytes" and ms == pytest.approx(1e3 * m * (2 * bs * bs * 8 + 1) / 3.35e12)
    ms, by = chip_smoke.chol_inverse_bound_ms(5120, 48, itemsize=8)
    assert by == "bytes" and ms == pytest.approx(0.0563, abs=1e-4)
    assert 5120 * 48.0**3 / 34e12 < ms * 1e-3


def test_dynamics_inputs_are_seeded_configurations():
    q, qd, tau, qdd = chip_smoke.dynamics_inputs(18, 64)
    assert q.shape == qd.shape == tau.shape == qdd.shape == (64, 18)
    assert np.array_equal(q, chip_smoke.dynamics_inputs(18, 64)[0])
    assert ((q[:, 2] >= 0.1) & (q[:, 2] <= 0.7)).all() and (np.abs(q[:, 3:6]) <= 0.4).all()
    assert chip_smoke._rel_err(np.array([1.0, 2.0]), np.array([1.0, 2.0 + 4e-9])) == \
        pytest.approx(2e-9)


GOOD_RECORD = {"B": 2, "conv": 0.5, "it_max": 3, "lanes": [{"kkt": [1.0, 2.0]}],
               "qd_inverse_launches": 18, "batch_iterations": 3}


@pytest.mark.parametrize("change,fault", [
    ({}, None),
    ({"conv": None}, "lacks"),
    ({"lanes": [{"kkt": [1.0, float("nan")]}]}, "non-finite"),
    ({"it_max": 4}, "over the cap"),
    ({"qd_inverse_launches": 12}, "not 6 per iteration"),
    ({"qd_inverse_launches": 0, "batch_iterations": 0}, "batch iterations in 1 solves"),
    ({"qd_inverse_launches": 24, "batch_iterations": 4}, "batch iterations in 1 solves"),
])
def test_diag_record_check(change, fault):
    """Phase 22's check of a diagnostics tool's record: its keys, finite
    numbers, the iteration cap (of the lanes and of the batch), 6 qd_inverse
    launches per batch iteration."""
    rec = {k: v for k, v in {**GOOD_RECORD, **change}.items() if v is not None}
    check = lambda: chip_smoke.check_diag_record("t", rec, ("B", "conv", "lanes"), 3,  # noqa: E731
                                                  [rec["it_max"]])
    if fault is None:
        check()
    else:
        with pytest.raises(AssertionError, match=fault):
            check()
