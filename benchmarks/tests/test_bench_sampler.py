"""The traffic generator: determinism from the seed, the prefix property,
the ranges of each mix, and the production height rule against the port's."""

import json
import os

import numpy as np
import pytest
import torch

from benchmarks.samplers.drops import draw
from benchmarks.tests.conftest import ROOT

MIXES = ["bench_drops.b64", "production_drops.b512"]


def mix(name):
    with open(os.path.join(ROOT, "benchmarks", "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_drops_and_prefix(name):
    m = mix(name)
    seed = 2**31 + 12345  # the driver's seeds exceed 32 signed bits
    q, qd = draw(m, seed, 512, 0)
    q2, qd2 = draw(m, seed, 512, 0)
    assert q.dtype == np.float32 and q.shape == (512, 6) and qd.shape == (512, 6)
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(qd, qd2)
    q64, qd64 = draw(m, seed, 64, 0)
    np.testing.assert_array_equal(q64, q[:64])
    np.testing.assert_array_equal(qd64, qd[:64])
    # another seed, or the warm-up's stream: drops of their own
    for other, other_d in (draw(m, seed + 1, 64, 0), draw(m, seed, 64, 1)):
        assert not np.isin(other_d[:, 3:6], qd64[:, 3:6]).any()


@pytest.mark.parametrize("name", MIXES)
def test_every_aligned_64_covers_the_box(name):
    """Each of the nine drawn numbers takes each sixty-fourth of its range
    once in every aligned stretch of 64 drops, on every seed."""
    m = mix(name)
    lo = np.array([r[0] for k in ("rpy", "omega", "v") for r in m[k]])
    hi = np.array([r[1] for k in ("rpy", "omega", "v") for r in m[k]])
    for seed in (3, 2**31 + 77):
        q, qd = draw(m, seed, 256, 0)
        u = (np.concatenate([q[:, 3:6], qd], 1).astype(np.float64) - lo) / (hi - lo)
        for s in range(0, 256, 64):
            bins = np.floor(u[s:s + 64] * 64).astype(int)
            # float32 rounding may put a value on its bin's edge
            assert all(len(np.unique(b)) >= 62 for b in bins.T), seed


@pytest.mark.parametrize("name", MIXES)
def test_ranges(name):
    m = mix(name)
    q, qd = draw(m, 7, 4096, 0)
    w = np.concatenate([q[:, 3:6], qd], 1)
    lo = np.array([r[0] for k in ("rpy", "omega", "v") for r in m[k]], np.float32)
    hi = np.array([r[1] for k in ("rpy", "omega", "v") for r in m[k]], np.float32)
    assert (w >= lo).all() and (w <= hi).all()
    assert (w.min(0) < lo + 0.01 * (hi - lo)).all() and (w.max(0) > hi - 0.01 * (hi - lo)).all()
    np.testing.assert_array_equal(q[:, :2], 0.0)
    if m["z0"] != "hip_clearance":
        np.testing.assert_array_equal(q[:, 2], np.float32(m["z0"]))


def test_hip_clearance_is_the_ports_rule():
    from landing_controller_tpu_torch.warmstart.reference import drop_scenario_from_draws

    q, qd = draw(mix("production_drops.b512"), 99, 256, 0)
    qp, qdp = drop_scenario_from_draws(*(torch.as_tensor(a, dtype=torch.float64)
                                         for a in (q[:, 3:6], qd[:, 0:3], qd[:, 3:6])))
    np.testing.assert_allclose(q, qp.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(qd, qdp.numpy(), rtol=0, atol=0)
