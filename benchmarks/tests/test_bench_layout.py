"""BENCHMARK.json against the benchmark's contract, every name found as a
file, and a new cell added with new files only."""

import json
import math
import os
import re

import pytest

from benchmarks.harness import HERE, draw, load_cell, run_cell
from benchmarks.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmarks/run.py"] and bench["paths"] == ["benchmarks"]
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # the full check with 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("benchmarks/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert os.path.exists(os.path.join(HERE, "reference", c["name"] + ".py"))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        cell = load_cell(w["name"])
        q, qd = draw(cell.mix, 1, cell.mix["lanes"], 0)
        assert q.shape == (cell.mix["lanes"], 6)
        assert cell.mix["pool"] % cell.mix["lanes"] == 0


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py")), m["name"]
    for c in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(c in m.get("workloads", cells) for m in bench["end_to_end"]) >= 2
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"])


def test_a_new_cell_is_new_files_only(tiny_bench, tmp_path):
    """A cell of an existing configuration under a new mix (short, easy
    drops) needs a traffic file and an entry in BENCHMARK.json, no code."""
    bench_path, traffic = tiny_bench
    with open(bench_path) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "srbm_lcp.b4.easy", "config": "srbm_lcp_bench",
                               "traffic": "bench_drops.easy", "chips": 1, "why": "short solves"})
    with open(os.path.join(traffic, "bench_drops.b64.json")) as f:
        mix = json.load(f)
    mix["v"][2] = [-2.0, -0.5]
    (tmp_path / "bench_drops.easy.json").write_text(json.dumps(mix))
    for w in bench["workloads"]:
        if w["traffic"] != "bench_drops.easy":
            (tmp_path / f"{w['traffic']}.json").write_text(open(os.path.join(traffic, w["traffic"] + ".json")).read())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, _ = run_cell("srbm_lcp.b4.easy", 5, 1.0, False, device="cpu", bench_path=str(tmp_path / "BENCHMARK.json"),
                         traffic_dir=str(tmp_path), log=lambda *a, **k: None)
    assert result["correct"] and result["metrics"]["batch_iteration_ms"]["value"] > 0
    assert math.isfinite(result["metrics"]["setup_s"]["value"])
