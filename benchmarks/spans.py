"""The program's spans (``landing_controller_tpu_torch.tracing``) read
beside one ``torch.profiler`` trace: host self time by phase, device idle
time and kernel launches by the span open on the host, and the device's
reads to the host that the stream did not plan.

    python3 benchmarks/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell as ``run.py`` does, in run.py's environment, with the
program's spans on from the solver's build onwards, and with the span
metrics below listed for the cell beside ``BENCHMARK.json``'s own (a copy
under ``build/bench_cache/``).  ``--trace 1`` prints, before the result
line, two ``#`` lines per span name on standard error.  ``--trace 0``
measures what the spans cost: its end-to-end metrics against ``run.py
--trace 0``'s.

The harness that the benchmark runs does not turn the spans on, so the
metrics here read nothing in its runs: each reader returns None where the
program recorded no spans.

The spans' clock is ``time.time_ns``'s; an event of the profiler's Chrome
trace starts at ``ts * 1000 + baseTimeNanoseconds``.  :class:`benchmarks.
trace.Trace` keeps ``ts`` alone; the base is one per process (a trace
exported later in the same process carries the same one), so
:func:`profiler_base_ns` reads it from a trace of nothing.

Every phase metric is the phase's host self time (its spans' durations less
their child spans'), in ms per batch iteration, over the window's segments
other than the profiled one (profiling slows the host).
"""

from __future__ import annotations

import bisect
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# metric: (span name, per "iteration" or per "segment"), self time
PHASES = {
    "stream.harvest_ms": ("stream.harvest", "segment"),
    "solver.rebuild_ms": ("solver.rebuild", "iteration"),
    "solver.residuals_ms": ("solver.residuals", "iteration"),
    "solver.corrector_ms": ("solver.corrector", "iteration"),
    "solver.line_search_ms": ("solver.line_search", "iteration"),
    "solver.update_ms": ("solver.iteration", "iteration"),
    "newton.derivatives_ms": ("newton.derivatives", "iteration"),
    "newton.assembly_ms": ("newton.assembly", "iteration"),
    "newton.factor_ms": ("newton.factor", "iteration"),
    "newton.solve_ms": ("newton.solve", "iteration"),
}
# the span metrics, as BENCHMARK.json's per_layer entries would list them
METRICS = [
    {"name": "stream.pool_s", "unit": "s", "better": "lower", "source": "program_span",
     "layer": "stream (parallel/stream.py)", "moves": "setup_s"},
    {"name": "stream.harvest_ms", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "stream (parallel/stream.py)", "moves": "converged_solves_per_s"},
] + [
    {"name": m, "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "Newton step (solver/structured.py)" if m.startswith("newton.") else
     "interior point (solver/ip.py)", "moves": "batch_iteration_ms"}
    for m in PHASES if m != "stream.harvest_ms"
] + [
    {"name": "device.idle_outside_spans", "unit": "fraction", "better": "lower", "source": "program_span",
     "layer": "device", "moves": "batch_iteration_ms"},
    {"name": "device.syncs_per_iter", "unit": "syncs", "better": "lower", "source": "device_trace",
     "layer": "device", "moves": "batch_iteration_ms"},
]
OUTSIDE = "(no span)"

_base_ns = None
LAST = None  # the last :class:`Reading` made, for the ``#`` lines


def profiler_base_ns() -> int:
    """``baseTimeNanoseconds`` of this process's profiler traces."""
    global _base_ns
    if _base_ns is None:
        import tempfile

        import torch

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            pass
        cache = os.path.join(ROOT, "build", "bench_cache")
        os.makedirs(cache, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=cache) as d:
            path = os.path.join(d, "base.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                _base_ns = int(json.load(f)["baseTimeNanoseconds"])
    return _base_ns


def self_ns(spans) -> list:
    """Each span's duration less its direct children's."""
    out = [(e - s) if e is not None else 0 for _, s, e, _ in spans]
    for _, s, e, parent in spans:
        if parent >= 0 and e is not None:
            out[parent] -= e - s
    return out


class Reading:
    """The spans of the measured run (from its ``stream.pool`` on) and, in a
    traced run, one profiled segment of its window.

    ``window_segments``: the window's segments, the last of the run;
    ``segment``: iterations per segment; ``trace``: the Trace or None;
    ``base_ns``: the trace's base on the spans' clock."""

    def __init__(self, spans, window_segments, segment, trace=None, base_ns=0):
        self.spans = spans
        self.segment = segment
        pools = [i for i, sp in enumerate(spans) if sp[0] == "stream.pool" and sp[2] is not None]
        self.pool = pools[-1] if pools else None
        first = -1 if self.pool is None else self.pool
        segs = [i for i, sp in enumerate(spans) if i > first and sp[0] == "stream.segment" and sp[2] is not None]
        self.window = segs[-window_segments:] if window_segments else []
        self.self_ns = self_ns(spans)
        self.top = self._tops()
        self.trace = trace
        self.base_ns = base_ns
        self.profiled = self._profiled() if trace is not None else None
        self.steady = [i for i in self.window if i != self.profiled]

    def _tops(self) -> list:
        """The outermost enclosing span of each span (itself at the top)."""
        top = list(range(len(self.spans)))
        for i, sp in enumerate(self.spans):
            if sp[3] >= 0:
                top[i] = top[sp[3]]
        return top

    def _profiled(self):
        """The window's segment that holds most of the trace's host events."""
        starts = np.sort(np.array([e.start_ns for e in self.trace.events if not e.on_device], np.int64)
                         + self.base_ns)
        best, most = None, 0
        for i in self.window:
            _, s, e, _ = self.spans[i]
            n = int(np.searchsorted(starts, e) - np.searchsorted(starts, s))
            if n > most:
                best, most = i, n
        return best

    # ------------------------------------------------------------ host time
    def self_by_name(self, segments) -> dict:
        """{span name: self ns} over the spans inside ``segments``."""
        inside = set(segments)
        out: dict = {}
        for i, sp in enumerate(self.spans):
            if self.top[i] in inside:
                out[sp[0]] = out.get(sp[0], 0) + self.self_ns[i]
        return out

    def phase_ms(self, metric):
        name, per = PHASES[metric]
        if not self.steady:
            return None
        sums = self.self_by_name(self.steady)
        if name not in sums:
            return None
        n = len(self.steady) * (self.segment if per == "iteration" else 1)
        return 1e-6 * sums[name] / n

    def pool_s(self):
        if self.pool is None:
            return None
        _, s, e, _ = self.spans[self.pool]
        return 1e-9 * (e - s)

    def segment_self_share(self):
        """The largest share of a steady segment's time that is its own."""
        if not self.steady:
            return None
        return max(self.self_ns[i] / (self.spans[i][2] - self.spans[i][1]) for i in self.steady)

    # ------------------------------------------------------- profiled segment
    def stretch(self):
        """(start, end) of the profiled segment and the read after it."""
        _, s, e, _ = self.spans[self.profiled]
        reads = [sp for sp in self.spans if sp[0] == "stream.read" and sp[1] >= e and sp[2] is not None]
        return s, (min(reads, key=lambda sp: sp[1])[2] if reads else e)

    def innermost(self, lo, hi):
        """[(start, end, name)] covering [lo, hi]: the innermost span open on
        the host at each moment (``OUTSIDE`` where none is)."""
        marks = []
        for i, (name, s, e, _) in enumerate(self.spans):
            if e is not None and e > lo and s < hi:
                marks.append((s, 1, i))
                marks.append((e, 0, i))
        marks.sort()
        pieces, open_, at = [], [], lo
        for t, kind, i in marks:
            t = min(max(t, lo), hi)
            if t > at:
                pieces.append((at, t, self.spans[open_[-1]][0] if open_ else OUTSIDE))
                at = t
            if kind:
                open_.append(i)
            else:
                open_.remove(i)
        if at < hi:
            pieces.append((at, hi, OUTSIDE))
        return pieces

    def idle_by_span(self) -> dict:
        """{span name: device idle ns} in the stretch, by the innermost span
        open on the host while the device idled."""
        lo, hi = self.stretch()
        dev = [(e.start_ns + self.base_ns, e.start_ns + e.dur_ns + self.base_ns)
               for e in self.trace.device()]
        dev = sorted((max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi)
        idle, at = [], lo
        for a, b in dev:
            if a > at:
                idle.append((at, a))
            at = max(at, b)
        if at < hi:
            idle.append((at, hi))
        out: dict = {}
        pieces = self.innermost(lo, hi)
        k = 0
        for a, b in idle:
            while k < len(pieces) and pieces[k][1] <= a:
                k += 1
            j = k
            while j < len(pieces) and pieces[j][0] < b:
                s, e, name = pieces[j]
                out[name] = out.get(name, 0) + min(b, e) - max(a, s)
                j += 1
        return out

    def launches_by_span(self) -> dict:
        """{span name: kernel-launch runtime calls} in the stretch."""
        from benchmarks.trace import LAUNCH_APIS

        lo, hi = self.stretch()
        pieces = self.innermost(lo, hi)
        starts = [p[0] for p in pieces]
        out: dict = {}
        for e in self.trace.events:
            t = e.start_ns + self.base_ns
            if not e.on_device and e.name in LAUNCH_APIS and lo <= t < hi:
                name = pieces[bisect.bisect_right(starts, t) - 1][2]
                out[name] = out.get(name, 0) + 1
        return out

    def idle_outside_spans(self):
        idle = self.idle_by_span()
        total = sum(idle.values())
        return idle.get(OUTSIDE, 0) / total if total else None

    def syncs_per_iter(self):
        """Device-to-host copies in the stretch outside every ``stream.read``,
        per batch iteration of the profiled segment."""
        lo, hi = self.stretch()
        reads = [(s, e) for name, s, e, _ in self.spans if name == "stream.read" and e is not None]
        n = 0
        for ev in self.trace.device():
            t = ev.start_ns + self.base_ns
            if "DtoH" in ev.name and lo <= t < hi and not any(s <= t < e for s, e in reads):
                n += 1
        return n / self.segment

    def lines(self) -> list:
        """The two ``#`` lines of a traced run."""
        out = ["# spans: no steady segment"]
        if self.steady:
            iters = len(self.steady) * self.segment
            sums = self.self_by_name(self.steady)
            host = " ".join(f"{n} {1e-6 * ns / iters:.3f}" for n, ns in sorted(sums.items()))
            out = [f"# spans, host self ms per batch iteration over {len(self.steady)} steady segments "
                   f"(largest segment self share {self.segment_self_share():.4f}): {host}"]
        if self.profiled is not None:
            idle, launches = self.idle_by_span(), self.launches_by_span()
            lo, hi = self.stretch()
            both = sorted(set(idle) | set(launches), key=lambda n: -idle.get(n, 0))
            out.append(f"# spans in the profiled segment ({1e-9 * (hi - lo):.3f} s; launches per batch "
                       f"iteration / device idle s): " + " ".join(
                           f"{n} {launches.get(n, 0) / self.segment:.1f}/{1e-9 * idle.get(n, 0):.4f}"
                           for n in both))
        return out


def reading(ctx):
    """The :class:`Reading` of a run's readers (one per run), or None where
    the program recorded no spans."""
    global LAST
    if LAST is not None and LAST[0] is ctx:
        return LAST[1]
    try:
        from landing_controller_tpu_torch import tracing
    except ImportError:  # a program without spans
        return None
    spans = tracing.spans()
    if not spans:
        return None
    tr = ctx["trace"]
    r = Reading(spans, ctx["window"]["segments"], ctx["window"]["segment"], tr,
                profiler_base_ns() if tr is not None else 0)
    LAST = (ctx, r)
    return r


def read_metric(ctx, name):
    """One span metric of the run, or None."""
    r = reading(ctx)
    if r is None:
        return None
    if name in PHASES:
        return r.phase_ms(name)
    if name == "stream.pool_s":
        return r.pool_s()
    if r.profiled is None:  # the device metrics need a trace
        return None
    return {"device.idle_outside_spans": r.idle_outside_spans,
            "device.syncs_per_iter": r.syncs_per_iter}[name]()


def bench_with_spans(name: str, path: str, source: str | None = None) -> str:
    """A copy of BENCHMARK.json (or of ``source``) at ``path`` that lists
    the span metrics for cell ``name``, the corrector's only where the
    configuration runs one."""
    from benchmarks.harness import load_cell, load_json

    source = source or os.path.join(ROOT, "BENCHMARK.json")
    bench = load_json(source)
    cell = load_cell(name, source)
    mine = [m for m in METRICS if m["name"] != "solver.corrector_ms" or cell.config["ip"]["corrector"]]
    bench["per_layer"] += [dict(m, workloads=[name]) for m in mine]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def main(argv=None, t_start=None) -> int:
    import argparse

    import torch

    from benchmarks.harness import run_cell
    from landing_controller_tpu_torch import tracing

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    bench = bench_with_spans(args.workload, os.path.join(ROOT, "build", "bench_cache", "spans",
                                                         "BENCHMARK.json"))
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start,
                              hooks={"solver": lambda solver: tracing.enable()}, bench_path=bench)
    if LAST is not None:
        for line in LAST[1].lines():
            print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from benchmarks import run  # run.py's environment: caches, one thread, its clock
    from benchmarks.spans import main as spans_main  # the readers' module, not __main__

    sys.exit(spans_main(t_start=run.T_START))
