"""The span readers (``benchmarks/spans.py``) on a small recorded span list
and trace with known answers, and one CPU run of a cell with the program's
spans on, in which every span metric of the cell reads a number."""

import os

import pytest

import benchmarks.spans as sp
from benchmarks.harness import HERE, load_module, run_cell
from benchmarks.trace import Event, Trace
from landing_controller_tpu_torch import tracing

US = 1000  # ns
BASE = 10**9  # the trace's base on the spans' clock


def reader(name):
    return load_module(os.path.join(HERE, "metrics", name + ".py"), "test_spans_" + name).read


def recorded():
    """A warm-up, the measured run's pool and three segments of 2
    iterations, 1 ms apart; segment 1 profiled.  Each segment: iteration 1
    (residuals 100 us, factor 100 us, 200 us its own), iteration 2 (line
    search 100 us, 300 us its own), the harvest (a rebuild of 20 us, 70 us
    its own), 10 us of the segment's own; then, 2 us later, the read."""
    spans = [("stream.pool", 0, 10 * US, -1), ("stream.segment", 10 * US, 20 * US, -1),
             ("stream.pool", 100 * US, 200 * US, -1)]

    def add(name, a, b, parent):
        spans.append((name, a, b, parent))
        return len(spans) - 1

    for k in range(3):
        s = (1000 + 1000 * k) * US
        seg = add("stream.segment", s, s + 900 * US, -1)
        it1 = add("solver.iteration", s, s + 400 * US, seg)
        add("solver.residuals", s + 10 * US, s + 110 * US, it1)
        add("newton.factor", s + 120 * US, s + 220 * US, it1)
        it2 = add("solver.iteration", s + 400 * US, s + 800 * US, seg)
        add("solver.line_search", s + 410 * US, s + 510 * US, it2)
        hv = add("stream.harvest", s + 800 * US, s + 890 * US, seg)
        add("solver.rebuild", s + 810 * US, s + 830 * US, hv)
        add("stream.read", s + 902 * US, s + 950 * US, -1)
        add("stream.callback", s + 950 * US, s + 990 * US, -1)
    s = 2000 * US  # the profiled segment

    def at(t):  # on the trace's clock
        return s + t * US - BASE

    launches = [Event("cudaLaunchKernel", False, at(t), 2 * US) for t in (20, 130, 300, 420, 895, 905)]
    device = [Event("k", True, at(30), 70 * US), Event("k", True, at(140), 260 * US),
              Event("k", True, at(430), 450 * US),
              Event("Memcpy DtoH (Device -> Pageable)", True, at(815), 3 * US),  # inside a kernel's time
              Event("Memcpy DtoH (Device -> Pageable)", True, at(910), 10 * US),  # the planned read
              Event("Memcpy DtoH (Device -> Pageable)", True, at(1815), 3 * US)]  # the next segment
    return spans, Trace(window_s=1e-3, iterations=2, events=launches + device)


def reading(trace=True):
    spans, tr = recorded()
    return sp.Reading(spans, 3, 2, tr if trace else None, BASE)


def test_self_time_and_division_per_iteration():
    r = reading()
    assert r.pool == 2 and r.pool_s() == pytest.approx(100e-6)
    assert len(r.window) == 3 and r.profiled == r.window[1] and r.steady == [r.window[0], r.window[2]]
    # over segments 0 and 2: 4 batch iterations, 2 harvests
    assert r.phase_ms("solver.residuals_ms") == pytest.approx(2 * 0.100 / 4)
    assert r.phase_ms("newton.factor_ms") == pytest.approx(2 * 0.100 / 4)
    assert r.phase_ms("solver.update_ms") == pytest.approx(2 * (0.200 + 0.300) / 4)
    assert r.phase_ms("solver.rebuild_ms") == pytest.approx(2 * 0.020 / 4)
    assert r.phase_ms("stream.harvest_ms") == pytest.approx(0.070)  # per segment
    assert r.phase_ms("solver.corrector_ms") is None  # no such span
    assert r.segment_self_share() == pytest.approx(10 / 900)
    # untraced: every window segment is steady
    assert reading(trace=False).phase_ms("stream.harvest_ms") == pytest.approx(0.070)
    # a window of no segment: nothing to divide by
    empty = sp.Reading(recorded()[0], 0, 2)
    assert empty.phase_ms("solver.update_ms") is None and empty.lines() == ["# spans: no steady segment"]


def test_idle_and_launches_by_the_span_open_on_the_host():
    r = reading()
    assert r.stretch() == (2000 * US, 2950 * US)
    idle = r.idle_by_span()
    assert {k: v / US for k, v in idle.items()} == {
        "solver.iteration": 30, "solver.residuals": 30, "newton.factor": 20, "solver.line_search": 20,
        "stream.harvest": 10, "stream.segment": 10, sp.OUTSIDE: 2, "stream.read": 38}
    assert r.idle_outside_spans() == pytest.approx(2 / 160)
    assert r.launches_by_span() == {"solver.residuals": 1, "newton.factor": 1, "solver.iteration": 1,
                                    "solver.line_search": 1, "stream.segment": 1, "stream.read": 1}
    # one copy to the host outside the read, in 2 iterations
    assert r.syncs_per_iter() == pytest.approx(0.5)
    lines = r.lines()
    assert len(lines) == 2 and all(line.startswith("# spans") for line in lines)
    assert "newton.factor 0.5/0.0000" in lines[1]


def test_readers_through_the_programs_spans(monkeypatch):
    spans, tr = recorded()
    monkeypatch.setattr(tracing, "spans", lambda: spans)
    monkeypatch.setattr(sp, "profiler_base_ns", lambda: BASE)
    monkeypatch.setattr(sp, "LAST", None)
    ctx = {"window": {"segments": 3, "segment": 2}, "trace": tr}
    assert reader("newton.factor_ms")(ctx) == pytest.approx(0.05)
    assert reader("device.idle_outside_spans")(ctx) == pytest.approx(2 / 160)
    assert reader("device.syncs_per_iter")(ctx) == pytest.approx(0.5)
    assert reader("stream.pool_s")(ctx) == pytest.approx(100e-6)
    untraced = {"window": {"segments": 3, "segment": 2}, "trace": None}
    assert reader("device.syncs_per_iter")(untraced) is None
    assert reader("solver.line_search_ms")(untraced) == pytest.approx(0.05)
    # no spans: nothing to read
    monkeypatch.setattr(tracing, "spans", lambda: [])
    for m in sp.METRICS:
        assert reader(m["name"])({"window": {"segments": 3, "segment": 2}, "trace": tr}) is None


def test_retry_share_reads_the_stream_counters(monkeypatch):
    from collections import Counter

    monkeypatch.setattr(tracing, "counters", lambda: Counter({"stream.finished": 12, "stream.retried": 3}))
    assert reader("stream.retry_share")({}) == pytest.approx(0.25)
    monkeypatch.setattr(tracing, "counters", lambda: Counter())
    assert reader("stream.retry_share")({}) is None


@pytest.fixture
def spans_off_after():
    yield
    tracing.disable()
    tracing.reset()


def test_cpu_run_reads_every_span_metric(tiny_bench, tmp_path, spans_off_after):
    bench, traffic = tiny_bench
    path = sp.bench_with_spans("srbm_lcp.b64", str(tmp_path / "BENCHMARK.json"), source=bench)
    tracing.reset()
    result, _ = run_cell("srbm_lcp.b64", 2**31 + 7, 3.0, True, device="cpu", bench_path=path,
                         traffic_dir=traffic, log=lambda *a, **k: None,
                         hooks={"solver": lambda solver: tracing.enable()})
    names = [m["name"] for m in sp.METRICS]  # srbm_lcp runs a corrector
    got = result["metrics"]
    assert set(names) <= set(got), set(names) - set(got)
    assert got["stream.pool_s"]["value"] > 0 and got["newton.derivatives_ms"]["value"] > 0
    assert got["device.syncs_per_iter"]["value"] == 0  # a CPU trace holds no copies
    assert 0 <= got["stream.retry_share"]["value"] <= 1
    assert len(sp.LAST[1].lines()) == 2
