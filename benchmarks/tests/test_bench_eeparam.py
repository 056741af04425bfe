"""The eeParam cell's own pieces: its drop generator (determinism, the
prefix property, the ranges) and one run of ``eeparam.b512`` on the CPU at
4 lanes and a pool of 8, which must come out correct; the dense step's
metric readers on a small recorded trace."""

import json
import os

import numpy as np

from benchmarks.harness import HERE, load_module, run_cell
from benchmarks.samplers.eeparam_drops import draw
from benchmarks.tests.conftest import ROOT, _cut
from benchmarks.trace import Event, Trace

SEED = 2**31 + 12345  # seeds may exceed 32 signed bits


def mix():
    with open(os.path.join(ROOT, "benchmarks", "traffic", "eeparam_drops.b512.json")) as f:
        return json.load(f)


def test_same_seed_same_drops_prefix_and_ranges():
    m = mix()
    q, qd = draw(m, SEED, 512, 0)
    assert q.dtype == np.float32 and q.shape == (512, 6) and qd.shape == (512, 6)
    q2, qd2 = draw(m, SEED, 512, 0)
    np.testing.assert_array_equal(q, q2)
    np.testing.assert_array_equal(qd, qd2)
    q64, qd64 = draw(m, SEED, 64, 0)
    np.testing.assert_array_equal(q64, q[:64])
    np.testing.assert_array_equal(qd64, qd[:64])
    for other, _ in (draw(m, SEED + 1, 64, 0), draw(m, SEED, 64, 1)):
        assert not np.isin(other[:, 2], q64[:, 2]).any()
    # height, pitch and v_z drawn; every other number 0
    assert (q[:, 2] >= 0.45).all() and (q[:, 2] <= 0.65).all()
    assert (np.abs(q[:, 4]) <= 0.2).all() and (qd[:, 5] <= -0.5).all() and (qd[:, 5] >= -1.5).all()
    assert not q[:, [0, 1, 3, 5]].any() and not qd[:, :5].any()
    # each aligned 64 covers every sixty-fourth of the height's range once
    cells = np.floor((q[:64, 2].astype(np.float64) - 0.45) / 0.2 * 64).astype(int)
    assert sorted(cells.tolist()) == list(range(64))


def test_tiny_run_is_correct(tmp_path):
    bench, traffic = _cut(tmp_path, dict(segment=2, attempt_iters=[2], ramp_iterations=0),
                          dict(lanes=4, pool=8))
    result, checks = run_cell("eeparam.b512", SEED, 1.0, False, device="cpu", bench_path=bench,
                              traffic_dir=traffic, log=lambda *a, **k: None)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and checks["viol_gap"][0] < 1e-5
    assert result["metrics"]["batch_iteration_ms"]["value"] > 0


def test_dense_kkt_readers_on_a_recorded_trace():
    """Two potrf launches of 10 ms and one trsm of 5 ms among 40 ms of
    device time, over 25 iterations of 512 lanes."""
    with open(os.path.join(ROOT, "benchmarks", "configs", "eeparam_sweep.json")) as f:
        cfg = json.load(f)
    events = [Event("void potrf_syrk_nc_kernel<float, 5, 6, 3, 3, 4>(int)", True, 0, 10_000_000),
              Event("void potrf_cta_lower_batch<float, float, 16>(int)", True, 10_000_000, 10_000_000),
              Event("void batch_trsm_left_kernel<float, 64, 4, 3, false, false, false>()", True, 20_000_000,
                    5_000_000),
              Event("void at::native::elementwise_kernel<128, 2>()", True, 25_000_000, 15_000_000)]
    ctx = {"trace": Trace(window_s=0.05, iterations=25, events=events), "config": cfg, "mix": mix()}
    roof = load_module(os.path.join(HERE, "metrics", "dense_kkt_roofline.py"), "t_roof").read(ctx)
    share = load_module(os.path.join(HERE, "metrics", "kernel.dense_kkt.device_share.py"), "t_share").read(ctx)
    d = cfg["dense_kkt"]
    flops = 25 * 512 * (3 * d["n_vars"] ** 3 + 4 * d["n_eq"] ** 3) / 3
    nbytes = 25 * 512 * 8 * (3 * d["n_vars"] ** 2 + 4 * d["n_eq"] ** 2)
    assert roof == 100 * max(flops / 67e12, nbytes / 3.35e12) / 0.02
    assert share == 25 / 40
    assert load_module(os.path.join(HERE, "metrics", "dense_kkt_roofline.py"), "t_roof2").read(
        {**ctx, "config": {k: v for k, v in cfg.items() if k != "dense_kkt"}}) is None
