"""The port's drop sampler, native runtime and streaming-solver options
against the JAX package (CPU).

- ``sample_scenarios_native(seed, n)`` bit for bit equal to the JAX
  package's (the same C++ source, each package's own build); the numpy
  fallback's heights against the JAX rotation to 1e-6 (f32);
- ``drop_scenario_from_draws`` fed the JAX sampler's own angles and
  velocities gives its z0 to 1e-6 (f32 on both sides); the torch sampler's
  ranges and its generator stream;
- ``ResultLog`` files written by either package (the port's native and
  Python writers) read back identically by the other's ``read_result_log``;
  the native pool's batches;
- StreamingSolver: the default sampler; a single attempt deadline records
  every scenario after its first attempt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from landing_controller_tpu.dynamics.rotations import rpy_to_rot_xyz as j_rot_xyz
from landing_controller_tpu.runtime import native as j_native
from landing_controller_tpu.warmstart.reference import DT_PRODUCTION, HIP_SRBM
from landing_controller_tpu.warmstart.reference import sample_drop_scenario as j_sample
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.parallel import StreamingSolver
from landing_controller_tpu_torch.runtime import native
from landing_controller_tpu_torch.solver.ip import IPConfig
from landing_controller_tpu_torch.warmstart.reference import (drop_scenario_from_draws,
                                                              sample_drop_scenario)

# the port's ops are small: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("seed,n", [(0, 64), (12345, 7)])
def test_native_sampler_bit_equal_to_jax(seed, n):
    assert native.native_available() and j_native.native_available()
    q, qd = native.sample_scenarios_native(seed, n)
    qj, qdj = j_native.sample_scenarios_native(seed, n)
    assert q.dtype == qd.dtype == np.float32 and q.shape == qd.shape == (n, 6)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(qd, qdj)


def test_numpy_fallback_follows_the_height_rule():
    """The fallback (no compiler): the JAX fallback's draws and height rule,
    with the port's rotation, to 1e-6 (f32)."""
    q, qd = native._sample_numpy(3, 32)
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(q[:, 3], rng.uniform(-0.25, 0.25, 32).astype(np.float32))
    for i in range(32):
        R = np.asarray(j_rot_xyz(jnp.asarray(q[i, 3:6])))
        z = (HIP_SRBM @ R.T)[:, 2]
        assert q[i, 2] == pytest.approx(0.35 + abs(z.min()) + abs(0.05 * qd[i, 5]), abs=1e-6)


def test_drop_transform_gives_jax_heights():
    keys = jax.random.split(jax.random.PRNGKey(7), 64)
    qj, qdj = (np.array(a) for a in jax.vmap(j_sample)(keys))  # f32
    q, qd = drop_scenario_from_draws(torch.as_tensor(qj[:, 3:6]), torch.as_tensor(qdj[:, 0:3]),
                                     torch.as_tensor(qdj[:, 3:6]))
    np.testing.assert_allclose(q.numpy()[:, 2], qj[:, 2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(q.numpy()[:, [0, 1, 3, 4, 5]], qj[:, [0, 1, 3, 4, 5]])
    np.testing.assert_array_equal(qd.numpy(), qdj)


def test_sampler_ranges_and_generator_stream():
    g = torch.Generator().manual_seed(5)
    q, qd = sample_drop_scenario(256, g, dtype=torch.float64, device="cpu")
    q2, _ = sample_drop_scenario(256, g, dtype=torch.float64, device="cpu")
    assert not torch.equal(q, q2)  # the generator's stream goes on
    q3, qd3 = sample_drop_scenario(256, torch.Generator().manual_seed(5), dtype=torch.float64,
                                    device="cpu")
    assert torch.equal(q, q3) and torch.equal(qd, qd3)
    assert q.dtype == torch.float64 and q.shape == qd.shape == (256, 6)
    assert (q[:, :2] == 0).all()
    assert (q[:, [3, 5]].abs() <= 0.25).all() and (q[:, 4].abs() <= np.pi / 3).all()
    assert (qd[:, :3].abs() <= 0.5).all() and (qd[:, 3:5].abs() <= 1.0).all()
    assert (qd[:, 5] <= -0.5).all() and (qd[:, 5] >= -5.0).all()
    # the height rule, against the JAX rotation
    for i in range(8):
        R = np.asarray(j_rot_xyz(jnp.asarray(q[i, 3:6].numpy())))
        z0 = 0.35 + abs((HIP_SRBM @ R.T)[:, 2].min()) + abs(DT_PRODUCTION[0] * float(qd[i, 5]))
        assert float(q[i, 2]) == pytest.approx(z0, abs=1e-12)
    q0, _ = sample_drop_scenario(4, device="cpu")
    assert q0.dtype == torch.float32 and torch.equal(
        q0, sample_drop_scenario(4, torch.Generator().manual_seed(0), device="cpu")[0])


def _records(n, rng):
    out = []
    for i in range(n):
        lam = None if i == 1 else rng.standard_normal(5 + i).astype(np.float32)
        y = None if i == 1 else rng.standard_normal(3).astype(np.float32)
        out.append((rng.standard_normal(6), rng.standard_normal(6), rng.standard_normal(10 + i),
                    bool(i % 2), lam, y))
    return out


def _write(log_cls, path, recs):
    with log_cls(path) as log:
        for q, qd, z, c, lam, y in recs:
            assert log.append_solution(q, qd, z, c, lam=lam, y=y)


def _same(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            np.testing.assert_array_equal(ra[k], rb[k])


@pytest.mark.parametrize("writer", ["port_native", "port_python", "jax"])
def test_result_logs_read_back_by_either_package(tmp_path, writer, monkeypatch):
    recs = _records(4, np.random.default_rng(0))
    path = str(tmp_path / "log.bin")
    if writer == "jax":
        _write(j_native.ResultLog, path, recs)
    else:
        if writer == "port_python":
            monkeypatch.setattr(native, "_load", lambda: False)
        _write(native.ResultLog, path, recs)
    got_port, got_jax = native.read_result_log(path), j_native.read_result_log(path)
    _same(got_port, got_jax)
    assert [r["converged"] for r in got_port] == [False, True, False, True]
    np.testing.assert_array_equal(got_port[2]["z"], recs[2][2].astype(np.float32))
    assert "lam" in got_port[0] and got_port[1]["lam"].size == 0
    # tensors are accepted where arrays are
    if writer == "port_native":
        with native.ResultLog(path) as log:
            log.append_solution(torch.zeros(6), torch.ones(6), torch.arange(4.0), True,
                                lam=torch.ones(2))
        last = j_native.read_result_log(path)[-1]
        np.testing.assert_array_equal(last["z"], np.arange(4.0, dtype=np.float32))
        # a torn tail is ignored
        with open(path, "ab") as f:
            f.write(b"\x4b\x54\x43\x4c\x10\x00")
        assert len(native.read_result_log(path)) == 5


def test_native_pool_batches():
    with native.NativeScenarioPool(batch=16, depth=2, threads=2, seed=3) as pool:
        batches = [pool.next() for _ in range(3)]
    for q, qd in batches:
        assert q.shape == qd.shape == (16, 6) and q.dtype == np.float32
        assert (np.abs(q[:, 4]) <= np.pi / 3 + 1e-6).all() and (qd[:, 5] <= -0.5).all()
    assert not np.array_equal(batches[0][0], batches[1][0])


def _solver():
    cfg = IPConfig(max_iter=30, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
                   refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri",
                   ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", corrector=1)
    return LandingSolver("srbm_lcp", n_knots=6, dtype=torch.float32, config=cfg,
                         guess="ballistic", device="cpu")


def test_default_sampler_draws_drops_from_seed_0():
    ss = StreamingSolver(_solver(), batch=2)
    q, qd = ss.sampler(3)
    q2, qd2 = ss.sampler(3)
    g = torch.Generator().manual_seed(0)
    for got, want in ((q, sample_drop_scenario(3, g, device="cpu")[0]), (q2, sample_drop_scenario(3, g, device="cpu")[0])):
        np.testing.assert_array_equal(got, want.numpy())
    assert isinstance(qd, np.ndarray) and qd.dtype == np.float32


def test_one_deadline_records_the_first_attempt():
    ss = StreamingSolver(_solver(), batch=2, segment=3, attempt_iters=(6,))
    assert ss.n_attempts == 1
    stats = ss.run(3)
    assert stats["n_finished"] == 3
    assert stats["iters_p90"] <= 6  # one attempt under the first deadline

