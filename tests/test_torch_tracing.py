"""The port's spans and counters (``landing_controller_tpu_torch.tracing``),
on the CPU, port only.

- off, the default, records nothing and costs no torch op; the counters
  count either way;
- spans nest (parent indices, self time) and, converted through the
  anchor, share the clock of a ``torch.profiler`` Chrome trace;
- a stream run records every span of the stream and the interior point,
  and ``ip.iterations`` counts its batch iterations;
- a saved step's programs are the same traced with spans on and off, and,
  run, report the stream's spans and ``solver.iteration`` alone;
- the stream's fifth result row holds each drop's attempts.
"""

import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from landing_controller_tpu_torch import tracing
from landing_controller_tpu_torch.api import LandingSolver
from landing_controller_tpu_torch.parallel import StreamingSolver
from landing_controller_tpu_torch.parallel.stream import STEP_MAGIC
from landing_controller_tpu_torch.solver.ip import IPConfig

torch.set_num_threads(1)

STREAM_SPANS = {"stream.pool", "stream.segment", "stream.harvest", "stream.read", "stream.callback",
                "solver.iteration"}
PHASE_SPANS = {"solver.rebuild", "solver.residuals", "solver.corrector", "solver.line_search",
               "newton.derivatives", "newton.assembly", "newton.factor", "newton.solve"}


@pytest.fixture(autouse=True)
def off_and_empty():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _solver(n_knots=13, max_iter=9, **kw):
    cfg = IPConfig(max_iter=max_iter, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4,
                   sigma_max=1e5, refine_steps=1, relax_scale=1.0, delta_c=1e-6,
                   kkt_backend="cri", ladder_scales=(0.0, 1.0), n_linesearch=4,
                   mu_strategy="loqo", corrector=1)
    return LandingSolver("srbm_lcp", n_knots=n_knots, dtype=torch.float32, config=cfg,
                         guess="ballistic", device="cpu", **kw)


def _sampler(n, seed=0, vz=(0.3, 1.0)):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, 6))
    q[:, 2] = 0.5
    q[:, 3:6] = rng.uniform(-0.1, 0.1, (n, 3))
    qd = np.zeros((n, 6))
    qd[:, 5] = -rng.uniform(*vz, n)
    return q, qd


def _stream(segment=3):
    return StreamingSolver(_solver(retry_guess="reference"), batch=2, segment=segment,
                           sampler=_sampler, attempt_iters=(6, 3))


def test_off_records_nothing_and_counters_count():
    assert tracing.span("a") is tracing.span("b")  # one shared object
    with tracing.span("a"):
        tracing.count("x")
        tracing.count("x", 2)
    assert tracing.spans() == []
    c = tracing.counters()
    assert c["x"] == 3 and c["never counted"] == 0
    c["x"] = 0  # a copy
    assert tracing.counters()["x"] == 3
    tracing.reset()
    assert tracing.counters()["x"] == 0


def test_nesting_and_self_time():
    tracing.enable()
    with tracing.span("outer"):
        time.sleep(0.002)
        with tracing.span("a"):
            time.sleep(0.003)
        with tracing.span("b"):
            with tracing.span("c"):
                time.sleep(0.001)
    sp = tracing.spans()
    assert [s[0] for s in sp] == ["outer", "a", "b", "c"]
    assert [s[3] for s in sp] == [-1, 0, 0, 2]
    for name, start, end, parent in sp:
        assert start <= end
        if parent >= 0:
            assert sp[parent][1] <= start and end <= sp[parent][2]
    dur = [e - s for _, s, e, _ in sp]
    own = dur[0] - dur[1] - dur[2]  # outer's self time
    assert 2e6 <= own < dur[0] and dur[1] >= 3e6 and dur[2] >= dur[3] >= 1e6


def test_open_spans_and_reset_inside_one():
    tracing.enable()
    with tracing.span("outer"):
        assert tracing.spans()[0][2] is None  # still open
        tracing.reset()
        with tracing.span("inner"):
            pass
    assert [(s[0], s[3]) for s in tracing.spans()] == [("inner", -1)]
    tracing.disable()
    with tracing.span("after"):
        pass
    assert len(tracing.spans()) == 1


def test_clock_matches_the_profilers_trace(tmp_path):
    """A record_function marker inside a span, both under a CPU profiler,
    lies inside the span once the trace's times are put on the spans'
    clock (ts * 1000 + baseTimeNanoseconds), within 0.5 ms."""
    tracing.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            x = torch.ones(1000)
            with torch.profiler.record_function("marker"):
                y = x * 2
            (y + 1).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    marker = next(e for e in doc["traceEvents"] if e.get("name") == "marker" and e.get("ph") == "X")
    start = marker["ts"] * 1e3 + doc["baseTimeNanoseconds"]
    end = start + marker["dur"] * 1e3
    (_, s, e, _), = tracing.spans()
    assert s - 0.5e6 <= start <= end <= e + 0.5e6


def test_stream_records_every_span_and_counts_iterations():
    ss = _stream()
    tracing.enable()
    calls = []
    stats = ss.run(4, progress_cb=calls.append)
    sp = tracing.spans()
    assert {s[0] for s in sp} == STREAM_SPANS | PHASE_SPANS
    segs = [i for i, s in enumerate(sp) if s[0] == "stream.segment"]
    assert len(segs) == len(calls) >= 2
    c = tracing.counters()
    assert c["ip.iterations"] == len(segs) * ss.segment
    assert (c["stream.finished"], c["stream.retried"]) == (stats["n_finished"], stats["n_retried"])
    assert stats["n_finished"] == 4
    for i in segs:  # a segment: its iterations, then one harvest
        assert [s[0] for s in sp if s[3] == i] == ["solver.iteration"] * ss.segment + ["stream.harvest"]
    parents = collections.defaultdict(set)
    for name, _, _, parent in sp:
        parents[name].add(sp[parent][0] if parent >= 0 else None)
    assert parents["solver.rebuild"] == {"solver.iteration", "stream.harvest"}
    assert parents["newton.solve"] == {"solver.iteration", "solver.corrector"}
    for name in ("solver.residuals", "solver.corrector", "solver.line_search", "newton.derivatives",
                 "newton.assembly", "newton.factor"):
        assert parents[name] == {"solver.iteration"}, name
    for name in ("stream.pool", "stream.segment", "stream.read", "stream.callback"):
        assert parents[name] == {None}, name


def test_solve_counts_its_iterations():
    s = _solver(max_iter=4)
    q, qd = _sampler(2)
    s.solve_batch(q, qd)  # one chunk of 4 (the cap), then a host read
    assert tracing.counters()["ip.iterations"] == 4
    s._segment_impl(q, qd, None, 3)
    assert tracing.counters()["ip.iterations"] == 7
    assert tracing.spans() == []  # off by default


def test_one_iteration_issues_the_same_ops_on_and_off():
    s = _solver(n_knots=7)
    q, qd = (torch.as_tensor(a, dtype=torch.float32) for a in _sampler(2))
    snlp, st = s.init_lanes(q, qd)
    prog = s.program(snlp)

    def ops(on):
        (tracing.enable if on else tracing.disable)()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            prog.step(st)
        return collections.Counter(e.name for e in prof.events() if e.name.startswith("aten::"))

    prog.step(st)  # first calls
    off = ops(False)
    assert sum(off.values()) > 100 and ops(True) == off
    assert {s[0] for s in tracing.spans()} == PHASE_SPANS - {"solver.rebuild"}


@pytest.fixture(scope="module")
def traced_steps():
    """The stream's iteration and harvest programs, traced as
    ``export_step`` traces them (the two that hold phase spans; the pool
    init holds none), with spans off and with spans on."""
    from landing_controller_tpu_torch._tree import tree_cat, tree_stack
    from landing_controller_tpu_torch.parallel.stream import _Lanes
    from landing_controller_tpu_torch.runtime.artifact import (TRACE_Q, TRACE_QD,
                                                               register_stream_serialization)
    from landing_controller_tpu_torch.runtime.programs import trace_program

    register_stream_serialization()  # the stream's carry as pytrees
    ss = _stream(segment=2)
    q = torch.tensor(TRACE_Q, dtype=torch.float32).expand(2, 6).clone()
    qd = torch.tensor(TRACE_QD, dtype=torch.float32).expand(2, 6).clone()
    pool = tree_stack([tree_cat([_Lanes.of(*ss.solver.init_lanes(q, qd, 0))] * 2)] * 2)
    carry = ss._make_carry(pool, 4)
    traced = {}
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        traced[on] = [trace_program(ss._iterate, (carry.lanes,)),
                      trace_program(lambda pool, carry: ss._harvest(pool, carry, 4), (pool, carry))]
    tracing.disable()
    tracing.reset()
    return traced


def test_saved_programs_are_the_same_with_spans_on(traced_steps):
    from landing_controller_tpu_torch.runtime.programs import _graph_to_json

    for (off, _), (on, _) in zip(traced_steps[False], traced_steps[True], strict=True):
        assert _graph_to_json(off) == _graph_to_json(on)
        for n in off.graph.nodes:
            if n.op == "get_attr":
                assert torch.equal(getattr(off, n.target), getattr(on, n.target))


def test_loaded_step_reports_the_stream_spans_alone(traced_steps):
    """The step composed of traced programs, as ``load_step`` composes the
    loaded ones: the stream's spans and ``solver.iteration``, and no phase
    inside an iteration."""
    from landing_controller_tpu_torch.runtime.programs import Program

    ss = _stream(segment=2)
    ss._step_cache[4] = ss._compose(*(Program(gm, spec) for gm, spec in traced_steps[True]))
    tracing.enable()
    stats = ss.run(4, progress_cb=lambda stats: None)
    assert stats["n_finished"] == 4
    assert {s[0] for s in tracing.spans()} == STREAM_SPANS


def test_step_saved_with_four_rows_is_refused(tmp_path):
    """A step saved before the attempts row (another first line) is refused,
    not loaded with four result rows."""
    assert STEP_MAGIC == b"LCSTRMT2\n"
    old = tmp_path / "old.lcs"
    old.write_bytes(b"LCSTRMT1\n" + json.dumps({"key": _stream(segment=2).artifact_key(4), "V": 2}).encode()
                    + b"\n")
    assert _stream(segment=2).load_step(str(old), 4) is False


def test_attempts_row_is_one_plus_the_lanes_variant():
    """The retry chain of tests/test_torch_stream_aot.py (ballistic -> nn ->
    reference, deadlines (28, 1, 1)): each drop harvested at a segment's end
    has, in row 4, 1 + the variant its lane ran when it finished."""
    cfg = IPConfig(max_iter=28, hessian_mode="hybrid", mu_min=1e-5, tol=2e-4, sigma_max=1e5,
                   refine_steps=1, relax_scale=1.0, delta_c=1e-6, kkt_backend="cri",
                   ladder_scales=(0.0, 1.0), n_linesearch=4, mu_strategy="loqo", corrector=1)
    s = LandingSolver("srbm_lcp", n_knots=21, dtype=torch.float32, config=cfg, device="cpu",
                      guess="ballistic", retry_guess=("nn", "reference"))
    ss = StreamingSolver(s, batch=4, segment=4, attempt_iters=(28, 1, 1),
                         sampler=lambda n: _sampler(n, seed=1, vz=(1.5, 2.5)))
    seen = []
    harvest = ss._harvest

    def recording(pool, carry, P):
        out = harvest(pool, carry, P)
        seen.append((carry.lane_sid.numpy().copy(), carry.lane_variant.numpy().copy(),
                     carry.res.numpy().copy(), out.res.numpy().copy()))
        return out

    ss._harvest = recording
    stats = ss.run(8)
    assert stats["n_finished"] == 8
    attempts = {}
    for sid, variant, before, after in seen:
        for lane, k in enumerate(sid):
            if k < 8 and before[0, k] == 0 and after[0, k] == 1:
                attempts[int(k)] = int(after[4, k])
                assert after[4, k] == 1 + variant[lane]
    assert len(attempts) == 8 and set(attempts.values()) > {1}  # the chain ran
    assert stats["n_retried"] == sum(a > 1 for a in attempts.values())


def test_the_module_imports_neither_torch_nor_jax():
    code = ("import sys; import landing_controller_tpu_torch.tracing; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax', 'numpy', "
            "'landing_controller_tpu'}))")
    # -S: no site hooks, which may import packages of their own
    out = subprocess.run([sys.executable, "-S", "-c", code], capture_output=True, text=True, check=True,
                         cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.stdout.strip() == "[]"
