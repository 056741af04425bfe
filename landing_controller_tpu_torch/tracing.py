"""Spans and counters of the port: where the host's time goes, and how often
things happen.

``span(name)`` marks a stretch of host code::

    with tracing.span("newton.factor"):
        ...

Tracing is off by default, and then ``span`` returns one shared object that
does nothing: a test of a module flag is all it costs.  It never calls
torch, never waits for the device and never allocates a tensor.  After
:func:`enable`, each span appends ``(name, start_ns, end_ns, parent)`` to a
list in memory, timed by ``time.perf_counter_ns`` at both ends; ``parent``
is the index in that list of the span that was open around it (-1 for
none), so a segment's span groups its iterations.

A span's time is host time: the time the host took to enqueue the work.
Work on the device reaches a span only through a profiler's trace, on the
same clock: :func:`spans` gives the times as ``time.time_ns()`` would have
read them (one anchor pair taken by :func:`enable`), which is the clock of
a ``torch.profiler`` Chrome trace, whose event starts at
``ts * 1000 + baseTimeNanoseconds``.

A program that ``make_fx`` or ``torch.export`` traced holds no spans, since
the trace sees only tensor operations: a saved step (``StreamingSolver.
load_step``) reports its ``stream.*`` and ``solver.iteration`` spans, which
its host loop opens, and none of the phases inside an iteration.  Nor does
a replay of the stream's captured CUDA graph: each replay is one
``solver.iteration`` span, and the phases' spans are recorded once, at the
capture, in the stream's set-up.

``count(name, n)`` adds to a registry of integers that is always on, at the
cost of a dictionary update: ``qd_inverse.launches`` and
``chol_inverse.launches`` (kernel launches; a CPU call runs the plain
version and is not one), ``ip.iterations`` (interior-point iterations run
over whole batches, masked lanes included, by ``solver.ip.solve``, the
stream's step and a loaded solver), ``stream.finished`` and
``stream.retried`` (drops a stream's run finished, and those of them that
took more than one attempt), ``stream.graph_captures`` (iterations a
stream captured as a CUDA graph), ``stream.graph_replays`` and
``stream.eager_iterations`` (a stream's batch iterations run as replays of
such a graph, and run otherwise).  A replay adds what the captured
iteration counted (``qd_inverse.launches``), so the counters read as the
eager iterations would.  :func:`counters` reads them; a caller takes the
difference around its own work, or calls :func:`reset`.

``count_on_device(name, n)`` adds a device tensor's sum to a counter
without reading it: the sum accumulates on the device (inside a captured
CUDA graph too, at each replay) and reaches the host where
:func:`counters` reads it (waiting for the device) or where a stream's
one host read per segment takes it along (:func:`start_device_reads`,
:func:`finish_device_reads`).  The dense KKT step counts
``dense_kkt.emergency`` so (lanes whose every ladder shift failed to
factor, which took the emergency shift), beside ``dense_kkt.lane_iterations``
(the lanes it factored, frozen lanes included, as ``ip.iterations`` counts
whole batches).  The module imports no torch itself; these take the
tensors of a caller that has.
"""

from __future__ import annotations

import time
from collections import Counter

__all__ = ["count", "count_on_device", "counters", "disable", "enable", "finish_device_reads", "reset",
           "span", "spans", "start_device_reads"]

_on = False
_anchor = (0, 0)  # (time.time_ns(), time.perf_counter_ns()) read together
_records: list = []  # [name, start, end, parent], perf_counter_ns
_open: list = []  # indices of the spans open now, innermost last
_counts: Counter = Counter()
_device_counts: dict = {}  # (name, device) -> 0-dim int64 tensor on that device


class _Off:
    """The span of tracing off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.record = [self.name, time.perf_counter_ns(), None, _open[-1] if _open else -1]
        _open.append(len(_records))
        _records.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record[2] = time.perf_counter_ns()
        if _open:  # empty where reset() ran inside this span
            _open.pop()
        return False


def span(name: str):
    """A context manager that records ``name`` around its body while
    tracing is on, and does nothing while it is off."""
    return _Span(name) if _on else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (always on)."""
    _counts[name] += n


def count_on_device(name: str, n) -> None:
    """Add the sum of the integer or boolean tensor ``n`` to the counter
    ``name`` where ``n`` lives, without reading it.  Nothing is counted
    inside a trace (``make_fx``, ``torch.export``, ``torch.compile``),
    whose program holds no counter."""
    import torch
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    if _get_current_dispatch_mode() is not None or torch.compiler.is_compiling():
        return
    key = (name, n.device)
    acc = _device_counts.get(key)
    if acc is None:
        acc = _device_counts[key] = torch.zeros((), dtype=torch.int64, device=n.device)
    acc.add_(n.sum())


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def start_device_reads() -> list:
    """Copy every device counter's sum to the host without waiting, and
    zero it after the copy: ``[(name, host tensor)]``, whose values are
    there once the host has waited for the device (a blocking read queued
    after them, as a stream's one read per segment)."""
    reads = []
    for (name, _), acc in _device_counts.items():
        reads.append((name, acc.to("cpu", non_blocking=True, copy=True)))
        acc.zero_()
    return reads


def finish_device_reads(reads: list) -> None:
    """Add the sums of :func:`start_device_reads` to the counters (after the
    host has waited for the device)."""
    for name, host in reads:
        _counts[name] += int(host)


def enable() -> None:
    """Start recording spans, and anchor their clock to ``time.time_ns``."""
    global _on, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable() -> None:
    """Stop recording spans; those recorded stay until :func:`reset`."""
    global _on
    _on = False


def spans() -> list:
    """The spans in the order they opened: ``(name, start_ns, end_ns,
    parent)``, times on ``time.time_ns``'s clock; ``end_ns`` is None for a
    span still open."""
    shift = _anchor[0] - _anchor[1]
    return [(name, start + shift, None if end is None else end + shift, parent)
            for name, start, end, parent in _records]


def counters() -> Counter:
    """A copy of the counters (a name never counted reads 0).  Device
    counters are read first, which waits for their devices (not while a
    CUDA graph is being captured: they are read later)."""
    if _device_counts and not _capturing():
        for (name, _), acc in _device_counts.items():
            _counts[name] += int(acc.item())
            acc.zero_()
    return Counter(_counts)


def reset() -> None:
    """Forget the recorded spans and zero every counter; tracing stays on
    or off as it was."""
    _records.clear()
    _open.clear()
    _counts.clear()
    for acc in _device_counts.values():
        acc.zero_()
