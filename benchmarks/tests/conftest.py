"""Shared pieces of the benchmark's CPU tests: the repository root on the
path, one torch thread per worker, and copies of the benchmark at sizes the
CPU runs in seconds: ``tiny_bench`` (4 lanes, pools of 24, segments of 2
iterations, deadlines of 2 iterations per attempt, a ramp of both) and
``solve_bench`` (4 lanes, pools of 8, segments of 10 iterations, one
attempt of 70, no ramp), in which drops converge."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _cut(d, config, mix):
    """(BENCHMARK.json path, traffic dir) of the benchmark with every
    configuration and mix updated by ``config`` and ``mix``, under d."""
    bench = _load(os.path.join(ROOT, "BENCHMARK.json"))
    for c in bench["configs"]:
        cfg = _load(os.path.join(ROOT, c["file"]))
        cfg.update(config)
        path = d / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    for w in bench["workloads"]:
        m = _load(os.path.join(ROOT, "benchmarks", "traffic", w["traffic"] + ".json"))
        m.update(mix)
        (d / f"{w['traffic']}.json").write_text(json.dumps(m))
    path = d / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path), str(d)


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    """(BENCHMARK.json path, traffic dir) of the benchmark cut to CPU size."""
    return _cut(tmp_path_factory.mktemp("tiny_bench"), dict(segment=2, attempt_iters=[2, 2], ramp_iterations=4),
                dict(lanes=4, pool=24))


@pytest.fixture(scope="session")
def solve_bench(tmp_path_factory):
    """(BENCHMARK.json path, traffic dir) of the benchmark at a CPU size in
    which drops converge."""
    return _cut(tmp_path_factory.mktemp("solve_bench"), dict(segment=10, attempt_iters=[70], ramp_iterations=0),
                dict(lanes=4, pool=8))
