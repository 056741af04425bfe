"""Reduction of one ``torch.profiler`` trace to what the per-layer metrics
read.

The harness profiles a bounded stretch of the window (whole segments, each
starting and ending at the stream's host read, so the device is idle at both
ends) with the CUDA activity alone: the kernels, copies and the runtime calls
that launched them, at a cost of microseconds a launch.  Host ops are not
recorded: with them the profiled segment ran 7x slower than the unprofiled
ones on the card, and its idle share read 0.99.  The events come here as
plain records, read from the profiler's Chrome trace; everything below works
on those, so the tests feed it a small recorded trace.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

# runtime and driver calls that launch a kernel
LAUNCH_APIS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                         "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"})
_NOISE = re.compile(r"\bvoid |at::native::|\(anonymous namespace\)::|std::|<unnamed>::")


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: a host-side runtime call or a device operation,
    with a kernel's launch grid (x, y, z) where the trace gives it."""

    name: str
    on_device: bool
    start_ns: int
    dur_ns: int
    grid: tuple | None = None


# trace-event categories of work on the device
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def events_of(prof, path: str) -> list:
    """The profiler's events as :class:`Event` records, by way of its
    Chrome trace written to ``path`` (the only place where this PyTorch
    gives a kernel's launch grid); the file is removed after reading."""
    import json
    import os

    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            doc = json.load(f)
    finally:
        os.remove(path)
    return parse_chrome_trace(doc)


def parse_chrome_trace(doc) -> list:
    """Complete events ("ph": "X") of a Chrome trace as :class:`Event`."""
    out = []
    for e in doc.get("traceEvents", doc) if isinstance(doc, dict) else doc:
        if e.get("ph") != "X":
            continue
        on_device = e.get("cat") in DEVICE_CATS
        grid = (e.get("args") or {}).get("grid") if on_device else None
        out.append(Event(e["name"], on_device, int(round(float(e["ts"]) * 1e3)),
                         int(round(float(e.get("dur", 0)) * 1e3)), tuple(int(g) for g in grid) if grid else None))
    return out


def short(name: str, width: int = 150) -> str:
    """A kernel's name without the namespaces and keywords that fill its
    first hundred characters, cut to ``width``."""
    return _NOISE.sub("", name)[:width]


def _merge(starts, ends):
    """Union of intervals: (merged starts, merged ends), sorted."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1]) if len(s) else run_end


@dataclasses.dataclass
class Trace:
    """One profiled stretch: its host-clock length, the batch iterations it
    holds, and its events."""

    window_s: float
    iterations: int
    events: list

    def device(self):
        return [e for e in self.events if e.on_device]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (union of the
        device events' intervals)."""
        dev = self.device()
        if not dev:
            return 0.0
        st = np.array([e.start_ns for e in dev], np.int64)
        s, e = _merge(st, st + np.array([e.dur_ns for e in dev], np.int64))
        return float((e - s).sum()) * 1e-9

    def launches(self) -> int:
        return sum(1 for e in self.events if not e.on_device and e.name in LAUNCH_APIS)

    def device_seconds(self, contains: str | None = None) -> float:
        return 1e-9 * sum(e.dur_ns for e in self.device() if contains is None or contains in e.name)

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        sums: dict = {}
        for e in self.device():
            sums[e.name] = sums.get(e.name, 0) + e.dur_ns
        ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[short(name), ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """[name, seconds]: the device's idle time between operations,
        summed by the operation that ends each gap ("before <op>"): the
        host spent the gap preparing it.  The longest first."""
        dev = sorted(self.device(), key=lambda e: e.start_ns)
        if len(dev) < 2:
            return []
        st = np.array([e.start_ns for e in dev], np.int64)
        run_end = np.maximum.accumulate(st + np.array([e.dur_ns for e in dev], np.int64))
        gap = st[1:] - run_end[:-1]
        sums: dict = {}
        for i in np.flatnonzero(gap > 0):
            name = "before " + short(dev[i + 1].name)
            sums[name] = sums.get(name, 0) + int(gap[i])
        ranked = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns * 1e-9] for name, ns in ranked]

